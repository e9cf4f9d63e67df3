"""Twit-based residue representation for moduli of the form 2^n ± δ, port
of `repro/core/twit.py`.

A *twit* (two-valued digit) is a binary variable with lower value 0 and gap
±δ, so a set twit contributes ``twit_value = s·δ`` (``s = +1`` for
m = 2^n + δ, ``s = -1`` for m = 2^n − δ; paper Section IV-A, Example 2).
A residue A ∈ [0, m) is an n-bit unsigned ``bin`` plus a twit bit ``t``:
value(bin, t) = (bin + t·s·δ) mod m.  All 2^(n+1) codewords decode to some
residue; the redundancy absorbs the end-around correction, so adders and
multipliers need no compare-and-subtract in their inner stages.

`decode` and `encode` take Python ints or torch int64 tensors on any
device (the reference takes numpy arrays).  ``twit_value`` is negative for
2^n − δ, so tensor reductions use the floored ``torch.remainder``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Tuple

import torch

__all__ = ["Modulus", "encode", "encode_all_forms", "decode",
           "is_power_of_two", "TwitOperand", "all_codewords",
           "admissible_deltas"]


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

    @property
    def twit_value(self) -> int:
        """Value contributed by a set twit bit: s·δ."""
        return self.sign * self.delta

    @property
    def fold_value(self) -> int:
        """Signed equivalent of 2^n:  2^n ≡ −s·δ (mod m)."""
        return -self.sign * self.delta

    @property
    def mask(self) -> int:
        return 2**self.n - 1

    @property
    def is_pow2(self) -> bool:
        return self.delta == 0

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

    def __str__(self) -> str:
        s = "+" if self.sign > 0 else "-"
        return f"2^{self.n}{s}{self.delta} (= {self.m})"


def decode(bin_part, twit, mod: Modulus):
    """Decode a (bin, twit) codeword to its canonical residue in [0, m).

    Accepts Python ints or torch tensors (returned as int64)."""
    if isinstance(bin_part, torch.Tensor) or isinstance(twit, torch.Tensor):
        dev = (bin_part if isinstance(bin_part, torch.Tensor) else twit).device
        b = torch.as_tensor(bin_part, dtype=torch.int64, device=dev)
        t = torch.as_tensor(twit, dtype=torch.int64, device=dev)
        return torch.remainder(b + t * mod.twit_value, mod.m)
    return (int(bin_part) + int(twit) * mod.twit_value) % mod.m


def encode(value, mod: Modulus):
    """Canonical encoding of a residue: twit = 0 whenever bin fits n bits.

    For m = 2^n + δ the residues in [2^n, m) need the twit:
    A = (A − δ) + δ with A − δ ∈ [2^n − δ, 2^n).  For m = 2^n − δ every
    residue fits in n bits with twit = 0.  A tensor gives (bin, twit) as
    int64 tensors."""
    if isinstance(value, torch.Tensor):
        value = torch.remainder(value.to(torch.int64), mod.m)
        need_twit = value >= 2**mod.n
        bin_part = torch.where(need_twit, value - mod.twit_value, value)
        return bin_part, need_twit.to(torch.int64)
    value = int(value) % mod.m
    if value < 2**mod.n:
        return value, 0
    # only reachable for sign=+1 (m > 2^n)
    return value - mod.twit_value, 1


def encode_all_forms(value: int, mod: Modulus) -> list[Tuple[int, int]]:
    """Every valid (bin, twit) codeword that decodes to ``value`` (the
    redundancy claims of Section IV-A: for 2^n − δ every residue has at
    least one form and many have two; for 2^n + δ only some have two)."""
    value = value % mod.m
    forms = []
    for t in (0, 1):
        # bin + t·s·δ ≡ value (mod m)  with bin in [0, 2^n)
        base = (value - t * mod.twit_value) % mod.m
        for k in range(0, 2):  # bin may exceed m but must fit n bits
            b = base + k * mod.m
            if 0 <= b < 2**mod.n:
                forms.append((b, t))
    return sorted(set(forms))


@dataclasses.dataclass(frozen=True)
class TwitOperand:
    """A twit-encoded scalar operand (used by the bit-faithful models)."""

    bin: int
    twit: int
    mod: Modulus

    def __post_init__(self):
        if not (0 <= self.bin < 2**self.mod.n):
            raise ValueError(f"bin {self.bin} out of n={self.mod.n} bits")
        if self.twit not in (0, 1):
            raise ValueError(f"twit must be 0/1, got {self.twit}")

    @property
    def value(self) -> int:
        return decode(self.bin, self.twit, self.mod)

    @classmethod
    def from_value(cls, value: int, mod: Modulus) -> "TwitOperand":
        b, t = encode(value, mod)
        return cls(bin=b, twit=t, mod=mod)

    def bit(self, i: int) -> int:
        return (self.bin >> i) & 1


@functools.lru_cache(maxsize=None)
def all_codewords(mod: Modulus) -> tuple[TwitOperand, ...]:
    """All 2^(n+1) codewords, for exhaustive checks (cached)."""
    return tuple(TwitOperand(bin=b, twit=t, mod=mod)
                 for t in (0, 1) for b in range(2**mod.n))


def admissible_deltas(n: int) -> Iterable[int]:
    """All admissible offsets for a channel width (the paper's full generic
    range)."""
    return range(0, 2 ** (n - 1))
