"""Moduli of the form 2^n ± δ (the twit datapath's channel descriptors).

Port of the part of `repro/core/twit.py` the plan layer needs: the
:class:`Modulus` descriptor (the fold schedule reads its width ``n``) and
:func:`is_power_of_two`.  The bit-level twit codec stays in the reference.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Modulus", "is_power_of_two"]


def is_power_of_two(m: int) -> bool:
    return m > 0 and (m & (m - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Modulus:
    """A modulus m = 2^n + sign·delta with 0 <= delta <= 2^(n-1) - 1."""

    n: int
    delta: int
    sign: int

    def __post_init__(self):
        if self.sign not in (-1, +1):
            raise ValueError(f"sign must be ±1, got {self.sign}")
        if self.n < 2:
            raise ValueError(f"need n >= 2, got n={self.n}")
        if not (0 <= self.delta <= 2 ** (self.n - 1) - 1):
            raise ValueError(
                f"delta={self.delta} outside admissible range "
                f"[0, 2^{self.n - 1}-1] for n={self.n}")

    @property
    def m(self) -> int:
        return 2**self.n + self.sign * self.delta

    @classmethod
    def from_value(cls, m: int, n: int | None = None) -> "Modulus":
        """Factor m into 2^n ± δ: at the width ``n`` when given (the paper's
        case study keeps every channel at n = 5, e.g. 17 = 2^5 − 15), else
        with the smallest admissible δ."""
        if m < 3:
            raise ValueError(f"modulus too small: {m}")
        if n is not None:
            delta = m - 2**n
            return cls(n=n, delta=abs(delta), sign=-1 if delta < 0 else 1)
        best = None
        for nn in range(2, m.bit_length() + 1):
            delta = m - 2**nn
            sign = 1 if delta >= 0 else -1
            d = abs(delta)
            if d <= 2 ** (nn - 1) - 1 or d == 0:
                cand = cls(n=nn, delta=d, sign=sign if d else 1)
                if best is None or cand.delta < best.delta:
                    best = cand
        if best is None:
            raise ValueError(f"{m} has no admissible 2^n±δ representation")
        return best
