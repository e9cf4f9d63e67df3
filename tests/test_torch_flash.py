"""The port's flash attention against the JAX reference, on the CPU.

`flash_attention` on CPU tensors runs its plain version `attention_ref`,
which must agree with the JAX `ref.attention_ref` and with the JAX Pallas
kernel (interpret mode, blocks of 32) within the JAX package's own
tolerances: 2e-5 for float32, 5e-2 for bfloat16 (`tests/test_kernels.py`).
The Pallas kernel attends to padded key slots when Sk is not a multiple of
its key block and the query and key paddings differ, or without a causal
mask; at those shapes the port is held to `attention_ref` alone.  Inputs
are seeded numpy normals.  The CUDA kernel is held against `attention_ref`
on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention, ref

# (B, H, Sq, Sk, D, window, softcap, dtype): tests/test_kernels.py's cases
ATTN_CASES = [
    (2, 3, 64, 64, 32, None, None, "float32"),
    (1, 2, 128, 128, 32, 32, None, "float32"),
    (1, 2, 64, 64, 32, None, 30.0, "float32"),
    (1, 2, 1, 96, 32, None, None, "float32"),
    (1, 1, 100, 100, 16, 24, 50.0, "float32"),
    (2, 2, 64, 64, 64, None, None, "bfloat16"),
]
# (B, H, Sq, Sk, D, causal, pad, explicit): masks beyond the causal ones
MASK_CASES = [
    (2, 2, 64, 64, 32, True, (0, 20), False),
    (3, 1, 1, 64, 16, True, (0, 63, 64), False),
    (1, 2, 64, 96, 32, False, None, False),
    (2, 2, 40, 70, 32, True, None, True),
    (2, 1, 33, 33, 128, False, None, True),
]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _qkv(B, H, Sq, Sk, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for S in (Sq, Sk, Sk)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _positions(B, Sq, Sk, seed):
    """Explicit (B, S) positions with −1 rows: a shuffled key order, dead
    key slots and dead query rows."""
    rng = np.random.default_rng(seed)
    qp = np.tile(np.arange(Sq, dtype=np.int32) + (Sk - Sq), (B, 1))
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kp[0] = rng.permutation(Sk)
    kp[-1, 3:11] = -1
    qp[0, :4] = -1
    return qp, kp


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


def _mask_kwargs(case, seed):
    B, H, Sq, Sk, D, causal, pad, explicit = case
    jkw = dict(causal=causal)
    tkw = dict(causal=causal)
    if pad is not None:
        jkw["pad"] = jnp.asarray(pad, jnp.int32)
        tkw["pad"] = torch.tensor(pad, dtype=torch.int32)
    if explicit:
        qp, kp = _positions(B, Sq, Sk, seed)
        jkw.update(qpos=jnp.asarray(qp), kpos=jnp.asarray(kp))
        tkw.update(qpos=torch.from_numpy(qp), kpos=torch.from_numpy(kp))
    return jkw, tkw


@pytest.mark.parametrize("B,H,Sq,Sk,D,win,cap,dtype", ATTN_CASES)
def test_flash_matches_reference_and_pallas(B, H, Sq, Sk, D, win, cap,
                                            dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Sq, Sk, D, dtype, B * Sq + Sk)
    got = flash_attention(q, k, v, causal=True, window=win, softcap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jref.attention_ref(jq, jk, jv, causal=True, window=win,
                                   softcap=cap), dtype)
    _close(got, jflash(jq, jk, jv, causal=True, window=win, softcap=cap,
                       block_q=32, block_k=32), dtype)


@pytest.mark.parametrize("case", MASK_CASES)
def test_masks_match_reference_and_pallas(case):
    B, H, Sq, Sk, D = case[:5]
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Sq, Sk, D, "float32", Sq + 7 * Sk)
    jkw, tkw = _mask_kwargs(case, Sk)
    got = flash_attention(q, k, v, **tkw)
    _close(got, jref.attention_ref(jq, jk, jv, **jkw), "float32")
    _close(got, jflash(jq, jk, jv, block_q=32, block_k=32, **jkw),
           "float32")
    _close(ref.attention_ref(q, k, v, **tkw),
           jref.attention_ref(jq, jk, jv, **jkw), "float32")


@pytest.mark.parametrize("Sq,Sk,causal", [(1, 100, True), (4, 100, True),
                                          (100, 100, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_key_shapes_follow_reference(Sq, Sk, causal, dtype):
    """Sk = 100 is no multiple of a 32-key block: the port never attends to
    the padding, so it agrees with `attention_ref`."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 2, Sq, Sk, 32, dtype, Sq + Sk)
    got = flash_attention(q, k, v, causal=causal)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), dtype)


def test_fully_masked_rows_are_zero():
    (jq, jk, jv), (q, k, v) = _qkv(3, 2, 8, 40, 16, "float32", 5)
    pad = (0, 40, 36)                # lane 1 all keys padded; lane 2 rows
    got = flash_attention(q, k, v, pad=torch.tensor(pad))
    want = jref.attention_ref(jq, jk, jv, pad=jnp.asarray(pad))
    assert torch.all(got[1] == 0)
    assert torch.all(got[2, :, :4] == 0) and torch.any(got[2, :, 4:] != 0)
    _close(got, want, "float32")
    qp = torch.tensor([[-1] * 8, list(range(32, 40)), [-1] * 4 + [0] * 4])
    kp = torch.tensor([list(range(40)), [-1] * 40, [5] * 40])
    got = flash_attention(q, k, v, qpos=qp, kpos=kp)
    assert torch.all(got[:2] == 0) and torch.all(got[2, :, 4:] == 0)


def test_rejects():
    q = torch.zeros(2, 1, 4, 16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        flash_attention(q, q, q, pad=torch.zeros(2, dtype=torch.int32),
                        qpos=torch.arange(4))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ref.attention_ref(q, q, q, pad=torch.zeros(2, dtype=torch.int32),
                          kpos=torch.arange(4))
    with pytest.raises(ValueError, match="share"):
        flash_attention(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="B, H, Sk, D"):
        flash_attention(q, q[:, :, :, :8], q)
    before = flash_attention.launches
    flash_attention(q, q, q)
    assert flash_attention.launches == before


@pytest.mark.parametrize("D", [8, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_padding_arithmetic(D, dtype):
    """What the CUDA wrapper does for a head size it does not compile: q,
    k and v padded with zero columns to `padded_head(D)`, the scores scaled
    by 1/√D of the true D (`attention_ref(scale=)`), the extra output
    columns dropped.  Equal to the reference's `attention_ref` at D, within
    its tolerance, and the dropped columns exactly 0."""
    from repro_torch.kernels.flash_attention import HEAD_SIZES, padded_head

    Dk = padded_head(D)
    assert Dk == {8: 16, 80: 80}[D] and Dk in HEAD_SIZES
    (jq, jk, jv), (q, k, v) = _qkv(2, 3, 24, 40, D, dtype, D)
    pad = torch.tensor([0, 9], dtype=torch.int32)
    want = jref.attention_ref(jq, jk, jv, window=16, softcap=30.0,
                              pad=jnp.asarray(pad))
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 16)) for t in (q, k, v))
    full = ref.attention_ref(qp, kp, vp, window=16, softcap=30.0, pad=pad,
                             scale=1.0 / np.sqrt(D))
    assert torch.all(full[..., D:] == 0)
    _close(full[..., :D], want, dtype)
    _close(flash_attention(q, k, v, window=16, softcap=30.0, pad=pad), want,
           dtype)
    # the reference's own scale= argument, at the padded width
    _close(full[..., :D], jref.attention_ref(
        *(jnp.pad(a, ((0, 0),) * 3 + ((0, 16),)) for a in (jq, jk, jv)),
        window=16, softcap=30.0, scale=1.0 / np.sqrt(D),
        pad=jnp.asarray(pad))[..., :D], dtype)


def test_head_sizes():
    from repro_torch.kernels.flash_attention import HEAD_SIZES, padded_head

    assert [padded_head(d) for d in (1, 8, 16, 17, 48, 64, 72, 80, 90, 96,
                                     100, 128, 200, 256)] == \
        [16, 16, 16, 32, 64, 64, 80, 80, 96, 96, 128, 128, 256, 256]
    assert HEAD_SIZES[-1] == 256
    # above 256 the wide route: the next multiple of its 128-column chunk
    assert [padded_head(d) for d in (257, 320, 384, 512, 513)] == \
        [384, 384, 384, 512, 640]
    with pytest.raises(ValueError, match="positive"):
        padded_head(0)


# (B, H, Sq, Sk, D, window, softcap, dtype): head sizes above 256, which
# the CUDA wrapper sends to its wide route (padded to a multiple of 128)
WIDE_CASES = [
    (1, 2, 40, 40, 320, None, None, "float32"),
    (1, 2, 40, 40, 320, 16, 30.0, "bfloat16"),
    (2, 1, 1, 64, 512, None, None, "float32"),
    (1, 2, 32, 64, 512, 24, 50.0, "float32"),
    (1, 1, 40, 40, 512, 16, None, "bfloat16"),
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,win,cap,dtype", WIDE_CASES)
def test_wide_heads_match_reference_and_pallas(B, H, Sq, Sk, D, win, cap,
                                               dtype):
    """The plain version at D = 320 and 512 (the wide route's) against the
    reference's `attention_ref` and its Pallas kernel in interpret mode,
    within the JAX package's tolerances (2e-5 float32, 5e-2 bfloat16); and
    the wide route's padding arithmetic (zero columns to `padded_head(D)`,
    the true D's scale) equal to it within the same."""
    from repro_torch.kernels.flash_attention import padded_head

    (jq, jk, jv), (q, k, v) = _qkv(B, H, Sq, Sk, D, dtype, D + Sq)
    kw = dict(causal=True, window=win, softcap=cap)
    got = flash_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jref.attention_ref(jq, jk, jv, **kw), dtype)
    _close(got, jflash(jq, jk, jv, block_q=32, block_k=32, **kw), dtype)
    Dk = padded_head(D)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    full = ref.attention_ref(qp, kp, vp, scale=1.0 / np.sqrt(D), **kw)
    assert torch.all(full[..., D:] == 0)
    _close(full[..., :D], jref.attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("D", [257, 320, 512, 1000])
@pytest.mark.parametrize("Sq", [1, 16, 17, 2048])
def test_wide_route_above_256(D, Sq):
    """Every call above D = 256 takes the wide route, whatever its query
    count and type; nothing at or below 256 does."""
    from repro_torch.kernels.flash_attention import (ROUTES, WIDE_CHUNK,
                                                     flash_route,
                                                     padded_head)

    assert ROUTES[-1] == "wide" and WIDE_CHUNK == 128
    for dtype in (torch.float32, torch.bfloat16):
        assert flash_route(Sq, dtype, D) == "wide"
        assert flash_route(Sq, dtype, 256) != "wide"
        assert flash_route(Sq, dtype) == flash_route(Sq, dtype, 64)
    Dk = padded_head(D)
    assert Dk % WIDE_CHUNK == 0 and D <= Dk < D + WIDE_CHUNK
