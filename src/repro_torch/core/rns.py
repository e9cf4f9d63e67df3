"""RNS bases, port of `repro/core/rns.py`: moduli sets, the dynamic range,
the Mixed-Radix inverse table, and the basis-sizing rules of the int8 matmul
and of the residue-resident chain.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

__all__ = ["RNSBasis", "PAPER_N5_MODULI", "basis_for_accumulation",
           "basis_for_chain", "basis_for_int8_matmul"]

# The paper's Section IV-D case-study set (order as printed).
PAPER_N5_MODULI: Tuple[int, ...] = (17, 19, 23, 29, 31, 1024, 35, 37, 39, 41,
                                    43, 47)


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
    """A pairwise-coprime RNS basis."""

    name: str
    moduli: Tuple[int, ...]

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
    def mrc_inverses(self) -> Tuple[Tuple[int, ...], ...]:
        """inv[j][i] = |m_i^{-1}|_{m_j} for i < j, 0 elsewhere."""
        k = self.k
        inv = [[0] * k for _ in range(k)]
        for j in range(k):
            for i in range(j):
                inv[j][i] = _modinv(self.moduli[i], self.moduli[j])
        return tuple(tuple(row) for row in inv)


def basis_for_accumulation(max_abs: int, name: str | None = None) -> RNSBasis:
    """Smallest subset of the paper set's odd moduli (largest first) whose
    dynamic range covers [−max_abs, max_abs].  1024 is left out: its
    residues do not fit the int8 operands of the kernel."""
    target = 2 * max_abs + 1
    chosen: List[int] = []
    prod = 1
    for m in sorted((m for m in PAPER_N5_MODULI if m != 1024), reverse=True):
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
