"""15-bit limb arithmetic on torch int32 tensors, port of
`repro/core/multiword.py` with the same op order.

Wide unsigned integers (the MRC accumulator, up to the dynamic range M) are
lists of little-endian 15-bit limbs held in int32, so every partial product
and carry stays int32-safe.  `limbs_to_float` replays the reference's
float32 Horner ``out = out·2^15 + limb`` exactly: its rounding is part of the
bit-exact contract of the fused epilogue.
"""
from __future__ import annotations

import torch

__all__ = ["LIMB_BITS", "LIMB_MASK", "MAX_HORNER_MODULUS", "nlimbs_for",
           "to_limbs_const", "limbs_from_scalar", "limbs_horner",
           "limbs_sub_const", "limbs_const_minus", "limbs_ge_const",
           "limbs_select", "limbs_to_float"]

LIMB_BITS = 15
LIMB_MASK = (1 << LIMB_BITS) - 1
# `limbs_horner` is int32-safe only for m <= 2^15.
MAX_HORNER_MODULUS = 1 << LIMB_BITS


def nlimbs_for(value: int, headroom_bits: int = 2) -> int:
    """Limb count covering ``value`` plus carry headroom."""
    return (value.bit_length() + headroom_bits + LIMB_BITS - 1) // LIMB_BITS


def to_limbs_const(value: int, nlimbs: int) -> tuple[int, ...]:
    """Python int → static limb tuple (little-endian)."""
    if value < 0:
        raise ValueError("limb constants are unsigned")
    out = []
    for _ in range(nlimbs):
        out.append(value & LIMB_MASK)
        value >>= LIMB_BITS
    if value:
        raise ValueError(f"constant needs more than {nlimbs} limbs")
    return tuple(out)


def limbs_from_scalar(d: torch.Tensor, nlimbs: int) -> list[torch.Tensor]:
    """Small nonnegative int32 tensor (< 2^30) → limb list."""
    d = d.to(torch.int32)
    limbs = []
    for _ in range(nlimbs):
        limbs.append(d & LIMB_MASK)
        d = d >> LIMB_BITS
    return limbs


def _carry_propagate(limbs):
    out = []
    carry = torch.zeros_like(limbs[0])
    for limb in limbs:
        v = limb + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return out


def limbs_horner(acc, m: int, d: torch.Tensor):
    """acc·m + d with m <= 2^15 and d an MRC digit."""
    if not 0 < m <= MAX_HORNER_MODULUS:
        raise ValueError(f"Horner modulus {m} outside (0, 2^15]")
    prods = [limb * m for limb in acc]
    prods[0] = prods[0] + d.to(torch.int32)
    return _carry_propagate(prods)


def limbs_sub_const(acc, value: int):
    """acc − value (value fits the limb count; assumes acc >= value)."""
    out = []
    borrow = torch.zeros_like(acc[0])
    for limb, c in zip(acc, to_limbs_const(value, len(acc))):
        v = limb - c - borrow
        borrow = (v < 0).to(torch.int32)
        out.append(v + borrow * (1 << LIMB_BITS))
    return out


def limbs_const_minus(value: int, acc):
    """value − acc (assumes value >= acc elementwise)."""
    out = []
    borrow = torch.zeros_like(acc[0])
    for limb, c in zip(acc, to_limbs_const(value, len(acc))):
        v = c - limb - borrow
        borrow = (v < 0).to(torch.int32)
        out.append(v + borrow * (1 << LIMB_BITS))
    return out


def limbs_ge_const(acc, value: int) -> torch.Tensor:
    """Boolean tensor: acc >= value (lexicographic from the top limb)."""
    ge = torch.zeros(acc[0].shape, dtype=torch.bool, device=acc[0].device)
    eq = torch.ones(acc[0].shape, dtype=torch.bool, device=acc[0].device)
    for limb, c in zip(reversed(acc), reversed(to_limbs_const(value,
                                                              len(acc)))):
        ge = ge | (eq & (limb > c))
        eq = eq & (limb == c)
    return ge | eq


def limbs_select(pred: torch.Tensor, a, b):
    """Limb-wise ``where(pred, a, b)``."""
    return [torch.where(pred, x, y) for x, y in zip(a, b)]


def limbs_to_float(acc) -> torch.Tensor:
    """Limb list → float32 via the reference's Horner ``out·2^15 + limb``."""
    out = torch.zeros(acc[0].shape, dtype=torch.float32, device=acc[0].device)
    for limb in reversed(acc):
        out = out * float(1 << LIMB_BITS) + limb.to(torch.float32)
    return out
