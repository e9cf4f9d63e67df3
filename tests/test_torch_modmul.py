"""The arithmetic of the port's `rns_modmul` kernel, on the CPU.

The CUDA kernel runs only on the card (`tests/test_torch_cuda.py`); here
its divide-free floored mod is emulated in int64 with the wrapper's own
tables and choice of path (`kernels.rns_modmul.direct_mod`): the
two-multiply remainder over every product of canonical operands of every
modulus an int8-residue plan holds (2..128) and every int8 product of every
modulus a product plan holds (to 46,341), the quotient estimate over the
extremes of every int32-residue modulus, and the plain version's
``out_dtype``.  The plain version against the reference is
`tests/test_torch_staged.py::test_modmul_matches_reference_and_pallas_interpret`.
"""
import numpy as np
import pytest
import torch

from repro.kernels.rns_modmul import rns_modmul as jmodmul
from repro_torch.core.channel_plan import residue_dtype_for
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.kernels import ref, rns_modmul
from repro_torch.kernels.rns_convert import forward_tables
from repro_torch.kernels.rns_modmul import direct_mod

M32 = (1 << 32) - 1
PLAN_MAX = 46341           # the largest m with (m - 1)^2 < 2^31


def _umulhi(u, mu):
    """__umulhi(u, mu) of unsigned 32-bit values, exact in int64."""
    return (u * (mu >> 16) + ((u * (mu & 0xFFFF)) >> 16)) >> 16


def _kernel_mod(p, m, direct):
    """The kernel's floored |p|_m of a product p >= 0 (int64 tensors, m a
    column): the low-word remainder (fwd_mod8, no lift) or the quotient
    estimate and one correction (fwd_mod32)."""
    mu = torch.tensor(forward_tables(tuple(m[:, 0].tolist()))["mu"],
                      dtype=torch.int64)[:, None]
    if direct:
        return _umulhi((mu * p) & M32, m)
    r = (p - _umulhi(p, mu) * m) & M32
    return torch.minimum(r, (r + m) & M32)


def _products(hi):
    """Every product a·b of operands 0..hi, once each."""
    a = torch.arange(hi + 1, dtype=torch.int64)
    return torch.unique(a[:, None] * a[None])


def test_direct_mod_every_int8_residue_modulus():
    """Every modulus 2..128 (int8 residues) takes the two-multiply
    remainder for int8 and int32 operands, and it equals p mod m for every
    p in [0, (m−1)^2]: every product of two canonical residues."""
    mods = tuple(range(2, 129))
    assert direct_mod(mods, torch.int8) and direct_mod(mods, torch.int32)
    m = torch.tensor(mods, dtype=torch.int64)[:, None]
    p = torch.arange(127 ** 2 + 1, dtype=torch.int64)[None]
    p = torch.minimum(p, (m - 1) ** 2)       # [0, (m−1)^2] per row
    assert torch.equal(_kernel_mod(p, m, True), torch.remainder(p, m))


@pytest.mark.parametrize("chunk", range(4))
def test_direct_mod_int8_operands_every_plan_modulus(chunk):
    """int8 operands take the two-multiply remainder for every modulus a
    product plan holds, and it is exact for every product of two int8
    residues (0..127) of each (in four chunks of moduli)."""
    step = -(-(PLAN_MAX - 128) // 4)
    lo = 129 + chunk * step
    mods = tuple(range(lo, min(lo + step, PLAN_MAX + 1)))
    assert direct_mod(mods, torch.int8)
    p = _products(127)[None]
    for i in range(0, len(mods), 512):
        m = torch.tensor(mods[i:i + 512], dtype=torch.int64)[:, None]
        assert torch.equal(_kernel_mod(p, m, True), torch.remainder(p, m))


def test_int32_operands_every_plan_modulus():
    """int32 operands of every modulus 2..46,341: the path the wrapper
    picks is exact on the products that bound it — (m−1)^2, the multiples
    of m (±1) below it, the largest products and random ones — and the
    two-multiply path is picked only where e·(m−1)^2 < 2^32."""
    mods = tuple(range(2, PLAN_MAX + 1))
    direct = torch.tensor([direct_mod((mm,), torch.int32) for mm in mods])
    assert bool(direct[:127].all())          # every int8-residue modulus
    m = torch.tensor(mods, dtype=torch.int64)[:, None]
    top = (m - 1) ** 2
    k = top // m
    g = torch.Generator().manual_seed(0)
    rand = (torch.rand((len(mods), 64), generator=g, dtype=torch.float64)
            * (top + 1).double()).long()
    p = torch.cat([top, top - 1, (m - 1) * (m - 2), k * m - 1, k * m,
                   torch.minimum(k * m + 1, top), m - 1, m, m + 1,
                   torch.zeros_like(m), rand], 1).clamp(min=0)
    want = torch.remainder(p, m)
    for path in (True, False):
        rows = direct == path
        assert torch.equal(_kernel_mod(p[rows], m[rows], path), want[rows])
    # the estimate is exact everywhere; the low word only where chosen
    assert torch.equal(_kernel_mod(p, m, False), want)
    e = (torch.tensor(forward_tables(mods)["mu"], dtype=torch.int64) * m[:, 0]
         - (1 << 32))
    assert torch.equal(direct, e * top[:, 0] < (1 << 32))


@pytest.mark.parametrize("itype", [torch.int8, torch.int32])
def test_plain_out_dtype(itype):
    """The plain version's out_dtype: int8 products equal to the int32 ones
    (canonical, so below 128), which match the reference Pallas kernel in
    interpret mode."""
    mods = basis_for_chain(1536).moduli
    assert residue_dtype_for(mods) == torch.int8
    g = torch.Generator().manual_seed(5)
    a, b = (torch.stack([torch.randint(0, m, (300,), generator=g)
                         for m in mods]).to(itype) for _ in range(2))
    a[:, 0] = b[:, 0] = torch.tensor(mods) - 1
    want = np.asarray(jmodmul(a.numpy(), b.numpy(), mods, block=128,
                              interpret=True))
    r32 = rns_modmul(a, b, mods)
    r8 = rns_modmul(a, b, mods, out_dtype=torch.int8)
    assert r32.dtype == torch.int32 and r8.dtype == torch.int8
    assert np.array_equal(r32.numpy(), want)
    assert torch.equal(r8, r32.to(torch.int8))
    assert torch.equal(ref.rns_modmul_ref(a, b, mods, out_dtype=torch.int8),
                       r8)


def test_out_dtype_validation():
    big = basis_for_int8_matmul(576).moduli + (131,)
    a = torch.zeros((len(big), 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="out_dtype"):
        rns_modmul(a, a, big, out_dtype=torch.int8)
    with pytest.raises(ValueError, match="out_dtype"):
        rns_modmul(a, a, big, out_dtype=torch.int16)
    with pytest.raises(ValueError, match="channels"):
        rns_modmul(torch.zeros((13, 4), dtype=torch.int8),
                   torch.zeros((13, 4), dtype=torch.int8),
                   (3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43))
