"""The port's standalone fold against the JAX reference, on the CPU.

`fold` on a CPU tensor runs its plain version, which must be bit-equal to
the JAX `fold` (Pallas in interpret mode, as `tests/test_kernels.py` runs
it), to the JAX `ref.fold_ref` and to the exact remainder, on the paper's
n5/n8/n11 channel sets at the bounds of `tests/test_kernels.py`, and with
a power-of-two channel.  Seeds are fixed per case; every comparison is
exact.  The CUDA kernel is held against `fold_ref` on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rns as jrns
from repro.kernels import ref as jref
from repro.kernels.fold import fold as jfold
from repro_torch.kernels import fold, ref

CHANNEL_SETS = {"paper-n5": jrns.PAPER_N5_MODULI, "n8": jrns.N8_CHANNELS,
                "n11": jrns.N11_CHANNELS}


def _values(mods, bound, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, bound, (len(mods), S), dtype=np.int64)
    x[:, :2] = [0, bound - 1]
    return x.astype(np.int32)


@pytest.mark.parametrize("bound", [2**15, 2**25, 2**31 - 1])
@pytest.mark.parametrize("name", sorted(CHANNEL_SETS))
def test_fold_matches_reference(name, bound):
    mods = tuple(int(m) for m in CHANNEL_SETS[name])
    x = _values(mods, bound, 600, bound % 1000 + len(mods))
    got = fold(torch.from_numpy(x), mods, bound)
    assert got.dtype == torch.int32
    want = np.asarray(jfold(jnp.asarray(x), mods, bound, block=256))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jref.fold_ref(
        jnp.asarray(x), mods, bound)))
    assert np.array_equal(got.numpy(),
                          x.astype(np.int64) % np.array(mods)[:, None])


def test_fold_includes_pow2_channel():
    mods = (1024, 47, 31)
    x = np.array([[2**30, 1023, 1024], [5000, 46, 47], [12345, 1, 0]],
                 dtype=np.int32)
    got = fold(torch.from_numpy(x), mods, 2**31 - 1)
    want = np.asarray(jfold(jnp.asarray(x), mods, 2**31 - 1, block=4))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.fold_ref(torch.from_numpy(x), mods,
                                       2**31 - 1).numpy(), want)


def test_fold_rejects_and_counts_nothing_on_cpu():
    before = fold.launches
    fold(torch.zeros(2, 5, dtype=torch.int32), (47, 43), 2**20)
    assert fold.launches == before
    with pytest.raises(ValueError, match="int32"):
        fold(torch.zeros(2, 5, dtype=torch.int64), (47, 43), 2**20)
    with pytest.raises(ValueError, match="C=2"):
        fold(torch.zeros(3, 5, dtype=torch.int32), (47, 43), 2**20)
