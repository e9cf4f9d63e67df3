"""Exact integer intervals — the abstract domain of the bound checker, port
of `repro/analysis/intervals.py`.

An :class:`Interval` is an inclusive ``[lo, hi]`` range over Python ints
(arbitrary precision, so every propagation step is *exact* — the derived
bounds are tight, not merely sound, which is what lets the adversarial tests
pin them to the saturated-corner values the kernel tests already hit).  The
special value :data:`TOP` means "nothing is known"; every operation on TOP
yields TOP, and downstream checks on TOP values degrade to warnings instead
of proofs.

The operations here are the ones the RNS pipeline's integer segment uses:
ring ops (add/sub/mul/neg/abs), the K-deep dot accumulation, floored mod by
a positive constant, the fold-ladder rung ``lo + hi·c``, shifts/masks, and
clipping.  Each is the exact image of the concrete op over the interval
corners (multiplication takes the min/max over the four corner products,
which is exact for intervals).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Interval", "TOP", "INT8", "INT32", "dtype_range"]


@dataclasses.dataclass(frozen=True)
class Interval:
    """Inclusive integer range ``[lo, hi]``; ``None`` bounds mean unbounded."""

    lo: Optional[int]
    hi: Optional[int]

    def __post_init__(self):
        if self.lo is not None and self.hi is not None and self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    # ---------------------------------------------------------- constructors
    @classmethod
    def point(cls, v: int) -> "Interval":
        return cls(int(v), int(v))

    @classmethod
    def symmetric(cls, b: int) -> "Interval":
        """[-b, b] — the signed operand ranges (127 quantized, 128 int8)."""
        return cls(-int(b), int(b))

    @classmethod
    def canonical(cls, m: int) -> "Interval":
        """[0, m-1] — a canonical residue of channel m."""
        return cls(0, int(m) - 1)

    # ------------------------------------------------------------ predicates
    @property
    def is_top(self) -> bool:
        return self.lo is None or self.hi is None

    @property
    def max_abs(self) -> Optional[int]:
        if self.is_top:
            return None
        assert self.lo is not None and self.hi is not None
        return max(abs(self.lo), abs(self.hi))

    def within(self, lo: int, hi: int) -> Optional[bool]:
        """True/False if provable, None when this interval is TOP."""
        if self.is_top:
            return None
        assert self.lo is not None and self.hi is not None
        return lo <= self.lo and self.hi <= hi

    # ------------------------------------------------------------- ring ops
    def __add__(self, o: "Interval") -> "Interval":
        if self.is_top or o.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        assert o.lo is not None and o.hi is not None
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o: "Interval") -> "Interval":
        if self.is_top or o.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        assert o.lo is not None and o.hi is not None
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __mul__(self, o: "Interval") -> "Interval":
        if self.is_top or o.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        assert o.lo is not None and o.hi is not None
        corners = (self.lo * o.lo, self.lo * o.hi,
                   self.hi * o.lo, self.hi * o.hi)
        return Interval(min(corners), max(corners))

    def __neg__(self) -> "Interval":
        if self.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        return Interval(-self.hi, -self.lo)

    def abs(self) -> "Interval":
        if self.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return -self
        return Interval(0, max(-self.lo, self.hi))

    def union(self, o: "Interval") -> "Interval":
        if self.is_top or o.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        assert o.lo is not None and o.hi is not None
        return Interval(min(self.lo, o.lo), max(self.hi, o.hi))

    # ------------------------------------------------------- pipeline ops --
    def dot(self, o: "Interval", k: int) -> "Interval":
        """K-deep sum of elementwise products — the Stage-③ accumulator."""
        return (self * o) * Interval.point(int(k))

    def mod(self, m: int) -> "Interval":
        """Floored mod by a positive constant (``torch.remainder``)."""
        m = int(m)
        if m <= 0:
            raise ValueError(f"mod by non-positive constant {m}")
        if (self.lo is not None and self.hi is not None
                and self.lo >= 0 and self.hi < m):
            return self                       # already canonical: exact
        return Interval(0, m - 1)

    def clip(self, lo: int, hi: int) -> "Interval":
        if self.is_top:
            return Interval(int(lo), int(hi))
        assert self.lo is not None and self.hi is not None
        return Interval(min(max(self.lo, int(lo)), int(hi)),
                        min(max(self.hi, int(lo)), int(hi)))

    def rshift(self, s: int) -> "Interval":
        if self.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        return Interval(self.lo >> s, self.hi >> s)

    def mask(self, bits: int) -> "Interval":
        """``v & (2^bits - 1)`` — exact for nonneg inputs below the mask."""
        if (self.lo is not None and self.hi is not None
                and 0 <= self.lo and self.hi < (1 << bits)):
            return self
        return Interval(0, (1 << bits) - 1)

    def rung(self, s: int, c: int) -> "Interval":
        """One fold-ladder rung ``(v & (2^s-1)) + (v >> s)·c`` on [0, hi]."""
        if self.is_top:
            return TOP
        assert self.lo is not None and self.hi is not None
        if self.lo < 0:
            raise ValueError("fold rungs apply to nonnegative accumulators; "
                             "fold |x| first (signed plans)")
        lo_max = min(self.hi, (1 << s) - 1)
        return Interval(0, lo_max + (self.hi >> s) * int(c))

    def __str__(self) -> str:
        if self.is_top:
            return "[⊤]"
        return f"[{self.lo}, {self.hi}]"


TOP = Interval(None, None)

# the integer dtypes' representable ranges
_DTYPE_RANGES = {
    "int8": (-(1 << 7), (1 << 7) - 1),
    "uint8": (0, (1 << 8) - 1),
    "int16": (-(1 << 15), (1 << 15) - 1),
    "uint16": (0, (1 << 16) - 1),
    "int32": (-(1 << 31), (1 << 31) - 1),
    "uint32": (0, (1 << 32) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1),
    "uint64": (0, (1 << 64) - 1),
}

INT8 = Interval(*_DTYPE_RANGES["int8"])
INT32 = Interval(*_DTYPE_RANGES["int32"])


def dtype_range(dtype) -> Optional[Interval]:
    """The representable interval of an integer dtype — a torch dtype or
    its name (``torch.int8`` or ``"int8"``) — None for floats."""
    name = str(dtype).removeprefix("torch.")
    rng = _DTYPE_RANGES.get(name)
    return Interval(*rng) if rng is not None else None
