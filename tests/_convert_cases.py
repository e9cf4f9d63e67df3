"""Edge cases of the conversion kernels shared by `tests/test_torch_convert.py`
(CPU) and `tests/test_torch_cuda.py` (card): a basis for every (C, L)
instance of the reverse, residues at the signed range's corners, and the
moduli and values at the forward's edges.  Imports torch and the port only.
"""
import math

import torch

from repro_torch.core import multiword as mw
from repro_torch.core.rns import RNSBasis

INT32_EXTREMES = (-2**31, 2**31 - 1, -2**31 + 1, -1, 0, 1)
# C = 1..12 moduli with int8 residues (powers of two and odd), and moduli
# whose residues need int32
SMALL_MODULI = (2, 64, 128, 47, 43, 41, 39, 37, 35, 31, 29, 3)
LARGE_MODULI = (2, 64, 2**15 + 3, 2**31 - 1)


def primes_from(lo, n, hi=1 << 15):
    """The ``n`` primes from ``lo`` up, or None past ``hi``."""
    out, p = [], max(2, lo)
    while len(out) < n:
        if p > hi:
            return None
        if all(p % q for q in range(2, math.isqrt(p) + 1)):
            out.append(p)
        p += 1
    return out


def basis_with_limbs(C, L):
    """A basis of C primes whose ConversionPlan has L limbs."""
    for bits in range(15 * L - 2, 15 * L - 17, -1):
        for lo in (int(2 ** (bits / C)), 2):
            ps = primes_from(lo, C)
            if ps and mw.nlimbs_for(math.prod(ps)) == L:
                return RNSBasis(name=f"edge-{C}-{L}", moduli=tuple(ps))
    raise ValueError(f"no basis of {C} primes has {L} limbs")


def edge_residues(basis, shape, seed, device="cpu"):
    """(C, *shape) random canonical residues of ``basis`` whose first
    elements are the signed range's corners 0, −1, ⌈M/2⌉−1 and −⌈M/2⌉."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = math.prod(shape)
    half = (basis.M + 1) // 2
    r = torch.stack([torch.randint(0, m, (S,), generator=g, device=device,
                                   dtype=torch.int32)
                     for m in basis.moduli])
    for i, v in enumerate((0, -1, half - 1, -half)[:S]):
        r[:, i] = torch.tensor([v % m for m in basis.moduli],
                               dtype=torch.int32)
    return r.reshape((len(basis.moduli),) + tuple(shape))


def forward_values(n, dtype, seed, offset=0, device="cpu"):
    """``n`` random values of ``dtype`` (int8 or int32) with the type's
    extremes first, starting ``offset`` elements into a fresh buffer (an
    offset > 0 gives a view off the 16-byte boundary)."""
    g = torch.Generator(device=device).manual_seed(seed)
    info = torch.iinfo(dtype)
    buf = torch.randint(info.min, info.max + 1, (n + offset,), generator=g,
                        device=device, dtype=torch.int64)
    ext = INT32_EXTREMES if dtype == torch.int32 else (-128, 127, -127, -1,
                                                       0, 1)
    k = min(n, len(ext))
    buf[offset:offset + k] = torch.tensor(ext[:k])
    return buf.to(dtype)[offset:]
