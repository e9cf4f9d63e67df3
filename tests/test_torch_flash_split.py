"""The flash split route's plan and decomposition, on the CPU.

`ref.split_key_ranges` is the key plan of the split route (Sq <= 16):
the ranks of a thread-block cluster each take a contiguous run of the
64-key tiles the rows can reach.  `csrc/flash_split.cu` computes the same
ranges on the card.  `ref.attention_split_ref` runs the decomposition with
plain ops: a masked softmax partial (m, l, acc) per rank, then the merge.
Both are held here, on seeded numpy inputs in float32, against the port's
`attention_ref` and the JAX `repro.kernels.ref.attention_ref` at the
float32 tolerance of `tests/test_torch_flash.py` (2e-5).  The cases cover
cluster sizes 1, 2, 3 and 8, lanes whose pad covers whole splits, an
all-padding lane, a window at Sq = 1, explicit positions with -1 rows,
and Sk no multiple of S·64.  The kernel itself is held against
`attention_ref` on the card by `tests/test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, ref
from repro_torch.kernels.flash_attention import flash_route, split_count

TOL = 2e-5
SPLITS = (1, 2, 3, 8)
# (B, H, Sq, Sk, D, causal, window, softcap, pad, explicit)
CASES = {
    # lane 1's pad covers the first three of four tiles, lane 2 is all pad,
    # lane 3's pad ends mid-tile; Sk = 200 is no multiple of S·64
    "decode-pad": (4, 2, 1, 200, 32, True, None, None, (0, 192, 200, 70),
                   False),
    "decode-window": (2, 2, 1, 300, 16, True, 50, None, (0, 280), False),
    "rows4-softcap": (2, 1, 4, 257, 32, True, None, 30.0, (3, 130), False),
    "rows16-window": (1, 2, 16, 333, 16, True, 100, None, None, False),
    "rows5-noncausal": (2, 1, 5, 130, 64, False, None, None, (0, 64),
                        False),
    "positions": (3, 1, 4, 150, 16, True, None, None, None, True),
}


def _inputs(case, seed):
    B, H, Sq, Sk, D, causal, window, cap, pad, explicit = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    jkw = dict(causal=causal, window=window, softcap=cap)
    tkw = dict(jkw)
    if pad is not None:
        jkw["pad"] = jnp.asarray(pad, jnp.int32)
        tkw["pad"] = torch.tensor(pad, dtype=torch.int32)
    if explicit:
        qp = np.tile(np.arange(Sq, dtype=np.int32) + (Sk - Sq), (B, 1))
        kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
        kp[0] = rng.permutation(Sk)
        kp[1, : Sk // 2] = -1              # the first splits' keys dead
        kp[2] = -1                         # a lane with no key at all
        qp[0, 1] = -1
        jkw.update(qpos=jnp.asarray(qp), kpos=jnp.asarray(kp))
        tkw.update(qpos=torch.from_numpy(qp), kpos=torch.from_numpy(kp))
    return (q, k, v), jkw, tkw


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_ref_matches_references(name, splits):
    case = CASES[name]
    (q, k, v), jkw, tkw = _inputs(case, splits + len(name))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ref.attention_split_ref(tq, tk, tv, splits=splits, **tkw)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    want = ref.attention_ref(tq, tk, tv, **tkw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    jwant = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), **jkw))
    np.testing.assert_allclose(got.numpy(), jwant, atol=TOL, rtol=0)
    np.testing.assert_allclose(flash_attention(tq, tk, tv, **tkw).numpy(),
                               jwant, atol=TOL, rtol=0)
    # fully masked rows are exactly 0 in the decomposition too
    B, _, Sq, Sk = case[0], case[1], case[2], case[3]
    dead = ~ref.attention_mask(B, Sq, Sk, **{
        n: tkw.get(n) for n in ("causal", "window", "pad", "qpos",
                                "kpos")}).any(-1)
    assert (got[dead[:, None].expand(-1, case[1], -1)] == 0).all()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_ranges_cover_reachable_keys_once(name, splits):
    """Per lane: the ranks' ranges are contiguous, in rank order, cover
    [k_lo, Sk) exactly once (k_lo from pad and window), start on the
    64-key tiles, and hold every key some row attends."""
    B, H, Sq, Sk, D, causal, window, cap, pad, explicit = CASES[name]
    _, _, tkw = _inputs(CASES[name], 0)
    attended = ref.attention_mask(B, Sq, Sk, **{
        n: tkw.get(n) for n in ("causal", "window", "pad", "qpos",
                                "kpos")}).any(1)
    for b in range(B):
        p = 0 if pad is None else pad[b]
        ranges = ref.split_key_ranges(Sq, Sk, splits, pad=p, window=window,
                                      explicit=explicit)
        assert len(ranges) == splits
        k_lo = 0 if explicit else max(
            p, 0 if window is None else Sk - Sq - window + 1)
        count = np.zeros(Sk, dtype=int)
        at = min(k_lo, Sk)
        for lo, hi in ranges:
            assert lo <= hi
            if hi > lo:
                assert lo == at and (lo == k_lo or lo % ref.SPLIT_TILE == 0)
                at = hi
                count[lo:hi] += 1
        assert at == Sk
        assert (count[k_lo:] == 1).all() and (count[:k_lo] == 0).all()
        assert (count[attended[b].numpy()] == 1).all()


def test_all_padding_lane_has_only_empty_ranges():
    for splits in SPLITS:
        for lo, hi in ref.split_key_ranges(1, 200, splits, pad=200):
            assert lo == hi
        for lo, hi in ref.split_key_ranges(1, 200, splits, pad=250):
            assert lo >= hi


@pytest.mark.parametrize("bh,Sk,want", [(72, 2048, 8), (72, 128, 2),
                                        (8, 4096, 8), (600, 2048, 1),
                                        (264, 2048, 2), (72, 1, 1)])
def test_split_count(bh, Sk, want):
    """Four blocks an SM over the heads on 132 SMs, at most 8 and at most
    the 64-key tiles of Sk."""
    assert split_count(bh, Sk, 132) == want


@pytest.mark.parametrize("Sq,dtype,want", [
    (1, torch.bfloat16, "split"), (16, torch.float32, "split"),
    (17, torch.bfloat16, "mma"), (17, torch.float32, "fma"),
    (2048, torch.bfloat16, "mma"), (2048, torch.float32, "fma")])
def test_flash_route(Sq, dtype, want):
    """Up to 16 query rows take the split route in either type; longer
    blocks the tensor cores in bf16 and the CUDA cores in float32."""
    assert flash_route(Sq, dtype) == want
