"""Functional models of the paper's baseline generic modular multipliers,
port of `repro/core/baselines.py` (unchanged arithmetic).

The paper compares against two arithmetic-based generic designs (Section III-B,
Fig. 1):

  * Hiasat [14] — "New efficient structure for a modular multiplier for RNS":
    conventional n×n binary multiplication, then reduction of the high product
    half through a constant (δ) multiplier and wide carry-propagate additions.
    Natively formulated for m = 2^n − δ; the 2^n + δ case is handled by
    *widening the datapath* (m = 2^(n+1) − δ' with δ' = 2^n − δ), which is
    exactly the cost blow-up the paper observes in Table III.

  * Matutino et al. [15] — "RNS Arithmetic Units for Modulo 2^n ± k":
    the same multiply-then-reduce principle extended to both signs, but with
    the structural restriction δ < 2^⌊n/2⌋ (the constant-multiplier width p
    is at most half of n) — several moduli of the paper's study are therefore
    *not supported* (the missing red bars of Fig. 5).

Both models are arithmetic-level (multiply → split → constant-multiply-fold →
correct), matching the published organizations stage for stage; gate-level
delay/cost of the same organizations is modeled in `analytical.py` (Table I).
They double as correctness oracles: tests check them against plain modular
arithmetic wherever they claim applicability.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .twit import Modulus

__all__ = [
    "mulmod_hiasat",
    "mulmod_matutino",
    "matutino_applicable",
    "hiasat_effective_width",
    "ReduceTrace",
]


@dataclasses.dataclass
class ReduceTrace:
    """Reduction-stage intermediates (for white-box structure tests)."""

    product: int = 0
    fold_iters: int = 0
    fold_values: List[int] = dataclasses.field(default_factory=list)
    corrections: int = 0


def hiasat_effective_width(mod: Modulus) -> int:
    """Datapath width of [14] for this modulus: n, or n+1 for plus moduli."""
    return mod.n if mod.sign < 0 else mod.n + 1


def _fold_minus(p: int, n: int, delta: int, m: int,
                trace: ReduceTrace | None) -> int:
    """Iterative high/low folding for m = 2^w − δ:  2^w ≡ δ."""
    while p >= (1 << n):
        hi, lo = p >> n, p & ((1 << n) - 1)
        p = hi * delta + lo
        if trace is not None:
            trace.fold_iters += 1
            trace.fold_values.append(p)
    while p >= m:
        p -= m
        if trace is not None:
            trace.corrections += 1
    return p


def mulmod_hiasat(a: int, b: int, mod: Modulus,
                  trace: ReduceTrace | None = None) -> int:
    """|a·b|_m through the multiply-then-reduce organization of [14].

    Minus form: full 2n-bit product; P_H·δ + P_L folds (constant multiplier +
    adder), iterated; final conditional correction.
    Plus form: the same engine over the widened modulus 2^(n+1) − (2^n − δ).
    """
    m = mod.m
    a, b = int(a) % m, int(b) % m
    p = a * b
    if trace is not None:
        trace.product = p
    if mod.sign < 0 or mod.delta == 0:
        return _fold_minus(p, mod.n, mod.delta, m, trace)
    # plus form: m = 2^n + δ = 2^(n+1) − (2^n − δ)
    w = mod.n + 1
    dprime = (1 << mod.n) - mod.delta
    return _fold_minus(p, w, dprime, m, trace)


def matutino_applicable(mod: Modulus) -> bool:
    """[15] supports δ strictly smaller than 2^⌊n/2⌋ (Section III-B)."""
    return 0 < mod.delta < (1 << (mod.n // 2))


def mulmod_matutino(a: int, b: int, mod: Modulus,
                    trace: ReduceTrace | None = None) -> int:
    """|a·b|_m through the organization of [15] (both signs, restricted δ).

    The published datapath computes P = A·B, splits it, and reduces via
    2^n ≡ ∓δ with a p_S-bit constant multiplier (p_S = bits of δ ≤ n/2),
    one more δ² fold level, and a mux-selected final correction.
    """
    if not matutino_applicable(mod):
        raise ValueError(
            f"Matutino [15] is not applicable to {mod}: requires "
            f"0 < δ < 2^⌊n/2⌋ = {1 << (mod.n // 2)}")
    n, delta, m = mod.n, mod.delta, mod.m
    a, b = int(a) % m, int(b) % m
    p = a * b
    if trace is not None:
        trace.product = p
    sgn = -mod.sign  # 2^n ≡ −sign·δ
    # level 1: P = P_H·2^n + P_L  ⇒  P ≡ sgn·δ·P_H + P_L
    hi, lo = p >> n, p & ((1 << n) - 1)
    q = lo + sgn * delta * hi
    if trace is not None:
        trace.fold_iters += 1
        trace.fold_values.append(q)
    # level 2: fold the (≤ p_S + n)-bit word once more (δ² term)
    if q >= 0:
        hi2, lo2 = q >> n, q & ((1 << n) - 1)
        q = lo2 + sgn * delta * hi2
    else:
        # negative intermediate (plus moduli): add ⌈|q|/m⌉·m (mux-selected)
        k = (-q + m - 1) // m
        q += k * m
        if trace is not None:
            trace.corrections += k
    if trace is not None:
        trace.fold_iters += 1
        trace.fold_values.append(q)
    # final mux-selected correction (bounded)
    while q < 0:
        q += m
        if trace is not None:
            trace.corrections += 1
    while q >= m:
        q -= m
        if trace is not None:
            trace.corrections += 1
    return q


def mulmod_binary(a: int, b: int, m: int) -> int:
    """Conventional binary multiply + generic (division-based) reduction —
    the 'Conv. Binary' row of Table II."""
    return (int(a) * int(b)) % m
