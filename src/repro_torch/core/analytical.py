"""Block-level analytical delay/cost models — Table I and Fig. 4 of the
paper; port of `repro/core/analytical.py` (unchanged arithmetic).

Section V-B defines the evaluation currency: ΔG (delay of a simple 2-input
gate) and #G (its cost), with the following published primitives:

    XOR gate / 2:1 mux : delay 2ΔG, cost 3#G
    n-bit CSA          : delay 4ΔG, cost 9#G per bit
    n-bit CPA (Kogge–Stone): delay (3 + 2⌈log2 n⌉)ΔG,
                             cost  (3 + 3n⌈log2 n⌉ − 3n)#G
    n-input CL block   : delay ⌈log2 n⌉ΔG, cost n#G
    binary multiplier  : 3-stage (PPG → reduction tree → final CPA)
    constant multiplier: no PPG stage (operand fixed)

Table I then composes each architecture from these blocks.  The printed table
loses its boldface (critical-path markers) in extraction, so the critical-path
composition below is reconstructed from the block counts plus the described
dataflow (Fig. 1 and Fig. 2); the *assertions* we make against the paper are
its robust claims (Fig. 4): the proposed design has the lowest delay at every
n in [3, 16] with a widening gap, while its hardware cost grows faster with n
(quadratic partial-product count) and overtakes the baselines at large widths.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .modmul import num_groups, reduction_levels
from .twit import Modulus

__all__ = [
    "DelayCost",
    "cpa_delay", "cpa_cost", "cl_delay", "cl_cost",
    "mulbin", "constmul",
    "proposed_model", "hiasat_model", "matutino_model",
    "analytical_table",
]

XOR_DELAY, XOR_COST = 2, 3
MUX_DELAY, MUX_COST = 2, 3
CSA_DELAY = 4
CSA_COST_PER_BIT = 9
AND_DELAY, AND_COST = 1, 1


@dataclasses.dataclass(frozen=True)
class DelayCost:
    delay: float  # ΔG
    cost: float   # #G

    def __add__(self, other: "DelayCost") -> "DelayCost":
        return DelayCost(self.delay + other.delay, self.cost + other.cost)

    def cost_only(self) -> "DelayCost":
        """Block off the critical path: contributes cost, no delay."""
        return DelayCost(0.0, self.cost)


def _log2c(x: int) -> int:
    return max(1, math.ceil(math.log2(max(2, x))))


def cpa_delay(n: int) -> float:
    return 3 + 2 * _log2c(n)


def cpa_cost(n: int) -> float:
    return 3 + 3 * n * _log2c(n) - 3 * n


def cl_delay(k: int) -> float:
    return _log2c(k)


def cl_cost(k: int) -> float:
    return k


def csa_levels(operands: int) -> int:
    """3:2-counter levels to reduce `operands` rows to 2."""
    if operands <= 2:
        return 0
    return math.ceil(math.log(operands / 2.0, 1.5))


def csa_tree(operands: int, width: int) -> DelayCost:
    lam = csa_levels(operands)
    return DelayCost(CSA_DELAY * lam,
                     CSA_COST_PER_BIT * width * max(0, operands - 2))


def mulbin(n: int) -> DelayCost:
    """n×n binary multiplier: AND-matrix PPG + CSA tree + final 2n-bit CPA."""
    ppg = DelayCost(AND_DELAY, AND_COST * n * n)
    tree = csa_tree(n, 2 * n)
    final = DelayCost(cpa_delay(2 * n), cpa_cost(2 * n))
    return ppg + tree + final


def constmul(i: int, c: int) -> DelayCost:
    """i-bit × c-bit constant multiplier: shifted-copy rows (≤ c) + CPA."""
    if c <= 0 or i <= 0:
        return DelayCost(0, 0)
    w = i + c
    tree = csa_tree(c, w)
    return tree + DelayCost(cpa_delay(w), cpa_cost(w))


# --------------------------------------------------------------- designs ----
def proposed_model(n: int, sign: int) -> DelayCost:
    """Proposed twit multiplier (Table I, last two columns).

    Critical path: one local CL(6) PP block → (λ+1)-level CSA (tree + the
    final-stage CSA) → CL(2λ+2|4) squeeze/transform block → (n+1|2)-bit CPA →
    XOR twit correction.  Off-path: the remaining Γ²−1 PP blocks.
    """
    gam = num_groups(n)
    lam = reduction_levels(n)
    cl_in = (2 * lam + 2) if sign < 0 else (2 * lam + 4)
    cpa_w = (n + 1) if sign < 0 else (n + 2)

    path = (DelayCost(cl_delay(6), cl_cost(6))                        # one PP
            + DelayCost(CSA_DELAY * (lam + 1),
                        CSA_COST_PER_BIT * n * max(0, gam * gam - 2)  # tree
                        + CSA_COST_PER_BIT * cpa_w)                   # stage-4 CSA
            + DelayCost(cl_delay(cl_in), cl_cost(cl_in))              # squeeze CL
            + DelayCost(cpa_delay(cpa_w), cpa_cost(cpa_w))            # single CPA
            + DelayCost(XOR_DELAY, XOR_COST))                         # twit fix
    off_path = DelayCost(0, cl_cost(6) * (gam * gam - 1) + cl_cost(2))
    return path + off_path


def hiasat_model(n: int, delta: int, sign: int) -> DelayCost:
    """Hiasat [14] (Table I col. 1).  Plus moduli widen the datapath by 1.

    Critical path follows the Fig. 1(a) dataflow: the full binary multiplier,
    then the constant (δ) multiplier on the *high* product half (its reduction
    tree; its resolving CPA is the first of the design's two CPAs), a CSA
    merge with the low half, the final CPA, and the small correction CL.
    """
    w = n if sign < 0 else n + 1
    d = delta if sign < 0 else (1 << n) - delta
    p_h = max(1, d.bit_length())
    cm_rows = csa_tree(p_h, w + p_h)                                   # CM tree
    path = (mulbin(w)                                                  # full mult
            + DelayCost(cl_delay(p_h + 2), cl_cost(p_h + 2))
            + cm_rows                                                  # CM on path
            + DelayCost(cpa_delay(w + p_h), cpa_cost(w + p_h))         # CPA #1 (CM)
            + DelayCost(CSA_DELAY, CSA_COST_PER_BIT * w)               # 1 CSA
            + DelayCost(cpa_delay(w), cpa_cost(w))                     # CPA #2
            + DelayCost(cl_delay(2), cl_cost(2)))
    return path


def matutino_model(n: int, delta: int, sign: int) -> DelayCost | None:
    """Matutino [15] (Table I cols. 2–3).  None if δ ≥ 2^⌊n/2⌋ (unsupported)."""
    mod = Modulus(n=n, delta=delta, sign=sign) if delta else None
    if delta == 0 or not (0 < delta < (1 << (n // 2))):
        return None
    p_s = max(1, delta.bit_length())
    n_csa = 2 if sign < 0 else 3
    cl_blocks = [4, 2] if sign < 0 else [2, 4, 2]
    # Fig. 1(b) dataflow: multiplier → constant multipliers on the high parts
    # (tree on path; resolving CPA is the bold one of Table I) → CSA merges →
    # mux-selected correction.
    cm_tree = csa_tree(p_s, n + p_s)
    path = (mulbin(n)
            + cm_tree                                   # CM on path
            + DelayCost(cpa_delay(n + p_s), cpa_cost(n + p_s))  # bold CPA
            + DelayCost(CSA_DELAY * n_csa, CSA_COST_PER_BIT * n * n_csa)
            + DelayCost(MUX_DELAY * 2, 0)               # two mux levels on path
            + DelayCost(0, cpa_cost(n)))                # second CPA off-path
    muxes = DelayCost(0, MUX_COST * n * 3)              # 4:1+4:1+2:1 (n-bit)
    cls = DelayCost(max(cl_delay(k) for k in cl_blocks),
                    sum(cl_cost(k) for k in cl_blocks))
    cms = constmul(p_s, p_s).cost_only()                # δ² helper CM off-path
    return path + muxes + cls + cms


def analytical_table(n_min: int = 3, n_max: int = 16,
                     delta_fn=None) -> Dict[int, Dict[str, DelayCost]]:
    """Fig. 4 data: per-n delay/cost for each design.

    delta_fn(n) picks the representative offset (default: δ = 3, the smallest
    nontrivial offset supported by every design, so all three are comparable).
    """
    delta_fn = delta_fn or (lambda n: 3)
    out: Dict[int, Dict[str, DelayCost]] = {}
    for n in range(n_min, n_max + 1):
        d = delta_fn(n)
        row = {
            "proposed-": proposed_model(n, -1),
            "proposed+": proposed_model(n, +1),
            "hiasat-": hiasat_model(n, d, -1),
            "hiasat+": hiasat_model(n, d, +1),
        }
        mm = matutino_model(n, d, -1)
        mp = matutino_model(n, d, +1)
        if mm is not None:
            row["matutino-"] = mm
        if mp is not None:
            row["matutino+"] = mp
        out[n] = row
    return out
