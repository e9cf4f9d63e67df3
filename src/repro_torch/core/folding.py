"""Static fold-ladder schedules (Stage ④), port of `repro/core/folding.py`.

Each rung applies ``v = lo + hi·2^s ≡ lo + hi·|2^s|_m (mod m)``; the
schedule is chosen greedily with every intermediate proven int32-safe, and a
bounded number of conditional subtracts finishes the canonicalization.  The
ladder itself runs in `channel_plan.ChannelPlan.apply_ladder` (torch) and in
the CUDA epilogue (`csrc/rns_kernels.cu`).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

from .twit import Modulus

__all__ = ["fold_schedule", "schedule_output_bound", "max_subtracts",
           "INT32_SAFE"]

INT32_SAFE = 2**31 - 1


def _rung_bound(bound: int, s: int, c: int) -> int:
    """Exact worst-case value after one rung applied to values in [0, bound]."""
    return min(bound, (1 << s) - 1) + (bound >> s) * c


@functools.lru_cache(maxsize=4096)
def fold_schedule(bound: int, mod: Modulus, target_multiple: int = 8,
                  max_rungs: int = 8) -> Tuple[Tuple[int, int], ...]:
    """Static (shift, constant) ladder reducing values <= bound below
    ``target_multiple·m``; raises if that needs more than ``max_rungs``."""
    m = mod.m
    target = target_multiple * m
    if bound > INT32_SAFE:
        raise ValueError(f"bound {bound} exceeds int32 accumulator range")
    rungs: List[Tuple[int, int]] = []
    b = bound
    while b >= target:
        best: Tuple[int, int] | None = None
        best_bound = b
        for s in range(mod.n, b.bit_length() + 1):
            c = (1 << s) % m
            if c == (1 << s):
                continue
            nb = _rung_bound(b, s, c)
            if (b >> s) * c > INT32_SAFE:
                continue
            if nb < best_bound:
                best_bound = nb
                best = (s, c)
        if best is None:
            raise ValueError(
                f"fold_schedule stalled at bound {b} for modulus {mod} "
                f"(target {target})")
        rungs.append(best)
        b = best_bound
        if len(rungs) > max_rungs:
            raise ValueError(
                f"fold_schedule needs > {max_rungs} rungs for {mod}, "
                f"bound {bound} — widen target or raise max_rungs")
    return tuple(rungs)


def schedule_output_bound(bound: int,
                          schedule: Sequence[Tuple[int, int]]) -> int:
    b = bound
    for s, c in schedule:
        b = _rung_bound(b, s, c)
    return b


def max_subtracts(bound: int, schedule: Sequence[Tuple[int, int]],
                  m: int) -> int:
    """Number of conditional subtracts needed after the ladder."""
    return max(0, schedule_output_bound(bound, schedule) // m)
