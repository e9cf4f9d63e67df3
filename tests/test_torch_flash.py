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
    with pytest.raises(ValueError, match="256"):
        padded_head(257)
