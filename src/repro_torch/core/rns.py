"""RNS bases, port of `repro/core/rns.py`: moduli sets, the dynamic range,
the per-channel 2^n±δ descriptors, forward conversion, the CRT and
Mixed-Radix reverse oracles over Python ints, the paper's case-study and τ
bases, and the basis-sizing rules of the int8 matmul and of the
residue-resident chain.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .twit import Modulus, is_power_of_two

__all__ = ["RNSBasis", "PAPER_N5_MODULI", "PAPER_N5_DYNAMIC_RANGE",
           "paper_n5_basis", "tau_basis", "n8_channels", "n11_channels",
           "basis_for_accumulation", "basis_for_chain",
           "basis_for_int8_matmul"]

# The paper's Section IV-D case-study set (order as printed).
PAPER_N5_MODULI: Tuple[int, ...] = (17, 19, 23, 29, 31, 1024, 35, 37, 39, 41,
                                    43, 47)
# Exact dynamic range claimed in Section IV-D.
PAPER_N5_DYNAMIC_RANGE = 28_620_324_425_937_054_720

# Table III's wider channels, for the circuit study (not a coprime set).
N8_CHANNELS: Tuple[int, ...] = (253, 259, 247, 265, 129, 383)  # 2^8∓{3,9,127}
N11_CHANNELS: Tuple[int, ...] = (2045, 2051, 2039, 2057, 1025,
                                 3071)                       # 2^11∓{3,9,1023}


def _egcd(a: int, b: int) -> Tuple[int, int, int]:
    if b == 0:
        return a, 1, 0
    g, x, y = _egcd(b, a % b)
    return g, y, x - (a // b) * y


def _modinv(a: int, m: int) -> int:
    g, x, _ = _egcd(a % m, m)
    if g != 1:
        raise ValueError(f"{a} not invertible mod {m}")
    return x % m


@dataclasses.dataclass(frozen=True)
class RNSBasis:
    """A pairwise-coprime RNS basis; channels of the form 2^n ± δ carry a
    :class:`Modulus` descriptor, power-of-two channels none."""

    name: str
    moduli: Tuple[int, ...]
    channel_n: int | None = None     # force the 2^n±δ channel width

    def __post_init__(self):
        ms = self.moduli
        for i in range(len(ms)):
            for j in range(i + 1, len(ms)):
                if math.gcd(ms[i], ms[j]) != 1:
                    raise ValueError(
                        f"basis {self.name!r} not pairwise coprime: "
                        f"gcd({ms[i]}, {ms[j]}) != 1")

    @property
    def k(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def M(self) -> int:
        """Dynamic range = product of the moduli."""
        return math.prod(self.moduli)

    @functools.cached_property
    def channels(self) -> Tuple[Modulus | None, ...]:
        """Per-channel 2^n±δ descriptors (None for power-of-two channels)."""
        return tuple(None if is_power_of_two(m)
                     else Modulus.from_value(m, n=self.channel_n)
                     for m in self.moduli)

    @functools.cached_property
    def _crt_weights(self) -> Tuple[int, ...]:
        """w_i = M_i · |M_i^{-1}|_{m_i} with M_i = M / m_i."""
        return tuple((self.M // m) * _modinv(self.M // m, m)
                     for m in self.moduli)

    def to_int(self, residues: Sequence[int]) -> int:
        """CRT reverse conversion over Python ints (the oracle)."""
        if len(residues) != self.k:
            raise ValueError(f"{len(residues)} residues for a basis of "
                             f"{self.k} channels")
        return sum(int(r) * w for r, w in
                   zip(residues, self._crt_weights)) % self.M

    def to_signed(self, residues: Sequence[int]) -> int:
        """Reverse conversion into the centered range [−M/2, M/2)."""
        v = self.to_int(residues)
        return v - self.M if v >= (self.M + 1) // 2 else v

    def forward(self, x):
        """Binary → residues, channel i holding |x|_{m_i} (floored, so a
        negative input maps to its coset representative).  A torch tensor
        goes through THE forward converter (`conversion_plan.forward`: the
        `rns_forward` kernel on CUDA) as int32 into the residue dtype; Python
        ints and numpy arrays take the exact big-int path of the oracle."""
        if isinstance(x, torch.Tensor):
            from .conversion_plan import forward

            return forward(x.to(torch.int32), self.moduli)
        xs = np.asarray(x)
        if xs.dtype == object or xs.dtype.kind not in "iu":
            xs = xs.astype(object)
        return np.stack([np.mod(xs, m) for m in self.moduli], axis=0)

    @functools.cached_property
    def mrc_inverses(self) -> Tuple[Tuple[int, ...], ...]:
        """inv[j][i] = |m_i^{-1}|_{m_j} for i < j, 0 elsewhere."""
        k = self.k
        inv = [[0] * k for _ in range(k)]
        for j in range(k):
            for i in range(j):
                inv[j][i] = _modinv(self.moduli[i], self.moduli[j])
        return tuple(tuple(row) for row in inv)

    def mrc_digits(self, residues: Sequence[int]) -> List[int]:
        """Mixed-radix digits d_i with x = d_0 + m_0(d_1 + m_1(d_2 + …))."""
        d: List[int] = []
        for j, mj in enumerate(self.moduli):
            t = int(residues[j]) % mj
            for i in range(j):
                t = ((t - d[i]) * self.mrc_inverses[j][i]) % mj
            d.append(t)
        return d

    def from_mrc(self, digits: Sequence[int]) -> int:
        """Horner recombination of mixed-radix digits (oracle form)."""
        v = 0
        for dj, mj in zip(reversed(digits), reversed(self.moduli)):
            v = v * mj + int(dj)
        return v


@functools.lru_cache(maxsize=None)
def paper_n5_basis() -> RNSBasis:
    """The Section IV-D 12-modulus case-study set (DR ≈ 2^65), every
    non-power-of-two channel a 2^5±δ datapath."""
    return RNSBasis(name="paper-n5-12mod", moduli=PAPER_N5_MODULI,
                    channel_n=5)


@functools.lru_cache(maxsize=None)
def tau_basis(n: int = 22) -> RNSBasis:
    """The classical 3-modulus set τ = {2^n − 1, 2^n, 2^n + 1} (Table II)."""
    return RNSBasis(name=f"tau-{n}", moduli=(2**n - 1, 2**n, 2**n + 1))


def n8_channels() -> Tuple[Modulus, ...]:
    """Table III's n = 8 channels as :class:`Modulus` descriptors."""
    return tuple(Modulus.from_value(m) for m in N8_CHANNELS)


def n11_channels() -> Tuple[Modulus, ...]:
    """Table III's n = 11 channels as :class:`Modulus` descriptors."""
    return tuple(Modulus.from_value(m) for m in N11_CHANNELS)


def basis_for_accumulation(max_abs: int, name: str | None = None,
                           int8_only: bool = True) -> RNSBasis:
    """Smallest subset of the paper set (largest moduli first) whose
    dynamic range covers [−max_abs, max_abs].  With ``int8_only`` 1024 is
    left out: its 10-bit residues do not fit the kernels' int8 operands.
    Without it 1024 comes first, as in the paper's set; such a basis is for
    the plain path only, and a kernel launch on it raises."""
    target = 2 * max_abs + 1
    odd = sorted((m for m in PAPER_N5_MODULI if m != 1024), reverse=True)
    chosen: List[int] = []
    prod = 1
    for m in odd if int8_only else [1024] + odd:
        chosen.append(m)
        prod *= m
        if prod >= target:
            return RNSBasis(name=name or f"acc-{max_abs}",
                            moduli=tuple(chosen))
    raise ValueError(
        f"paper n=5 set (M={prod}) cannot cover max_abs={max_abs}")


@functools.lru_cache(maxsize=64)
def basis_for_chain(k: int) -> RNSBasis:
    """THE basis of a residue-resident linear chain whose widest contraction
    is ``k`` deep (d_ff for a GLU MLP): the gated down projection multiplies
    three int8 factors per term, so the range covers K·128³.  Every launch
    of the chain shares it, so residues pass between launches unchanged."""
    return basis_for_accumulation(k * 128 * 128 * 128, name=f"rns-chain-k{k}")


@functools.lru_cache(maxsize=64)
def basis_for_int8_matmul(k: int) -> RNSBasis:
    """THE basis a K-deep int8 matmul uses, sized for K·128² so that any
    int8 operands (−128 included) are exact."""
    return basis_for_accumulation(k * 128 * 128, name=f"rns-dense-k{k}")
