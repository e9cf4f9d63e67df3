"""Bit-faithful model of the paper's generic modulo-(2^n ± δ) multiplier
(Algorithm 1), port of `repro/core/modmul.py`, stage by stage:

  ① Operand splitting — Γ = 1 + ⌈(n−2)/3⌉ groups; group 0 = (twit, a1,
     a0), groups γ >= 1 the 3-bit slices from bit 2, weight 2^(3γ−1).
  ② Partial products — PP_{γ,η} = |g_γ^A · g_η^B · weight|_m, each a
     6-input Boolean function, modeled as the 64-entry table a LUT6
     realizes (built once per modulus).
  ③ Multi-operand reduction — carry-save accumulation of the Γ² partial
     products; the model keeps its arithmetic effect, the plain sum, and
     the 3:2-counter depth λ = ⌈log_{3/2}(Γ²/2)⌉ the circuit model uses.
  ④ Squeezing and the final modular addition — overflow bits at positions
     >= n fold back through 2^(n+j) ≡ |2^(n+j)|_m in blocks of at most six
     inputs, then one twit-compatible carry-propagate addition gives the
     canonical result.

Every stage records its intermediates in a :class:`StageTrace`.
`mulmod_twit_tensor` is the tensor form of the reference's
`mulmod_twit_np`: the (Γ, Γ, 64) table stack lives on the operands'
device, the squeeze loop's trip count is worked out on Python ints, and
the canonicalization is four conditional subtracts.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch

from .twit import Modulus, TwitOperand, decode, encode

__all__ = ["num_groups", "group_weight", "group_bits", "split_operand",
           "group_value", "PPTables", "pp_tables", "mulmod_twit",
           "mulmod_twit_tensor", "StageTrace", "reduction_levels"]


# --------------------------------------------------------------- stage 1 ----
def num_groups(n: int) -> int:
    """Γ = 1 + ⌈(n − 2)/3⌉ (Stage ①)."""
    return 1 + math.ceil((n - 2) / 3)


def group_weight(gamma: int) -> int:
    """Positional weight 2^w(γ): w(0) = 0, w(γ) = 3γ − 1 for γ >= 1."""
    return 1 if gamma == 0 else 2 ** (3 * gamma - 1)


def group_bits(gamma: int, n: int) -> Tuple[int, int]:
    """(lo_bit, width) of the binary bits group γ >= 1 covers."""
    lo = 3 * gamma - 1
    return lo, min(3, n - lo)


def split_operand(op: TwitOperand) -> List[int]:
    """Stage ①: the group codes (raw 3-bit patterns).  Group 0 packs
    (twit, a1, a0) as t<<2 | a1<<1 | a0, groups γ >= 1 their (up to) three
    binary bits; `group_value` reads a code's value."""
    n = op.mod.n
    groups = [((op.twit & 1) << 2) | (op.bin & 0b11)]
    for gamma in range(1, num_groups(n)):
        lo, width = group_bits(gamma, n)
        groups.append((op.bin >> lo) & ((1 << width) - 1))
    return groups


def group_value(code: int, gamma: int, mod: Modulus) -> int:
    """Numeric (possibly negative) value of a group code, without weight."""
    if gamma == 0:
        t = (code >> 2) & 1
        return (code & 0b11) + t * mod.twit_value
    return code


# --------------------------------------------------------------- stage 2 ----
@dataclasses.dataclass(frozen=True)
class PPTables:
    """The 6-input partial-product tables of Stage ②: ``tables[(γ, η)]``
    maps index (codeA << 3) | codeB to |value(g_γ^A)·value(g_η^B)·
    2^{w(γ)+w(η)}|_m ∈ [0, m), as a tuple of 64 ints (the LUT6 image)."""

    mod: Modulus
    tables: Dict[Tuple[int, int], Tuple[int, ...]]

    @property
    def count(self) -> int:
        return len(self.tables)

    def pp(self, gamma: int, eta: int, code_a: int, code_b: int) -> int:
        return int(self.tables[(gamma, eta)][(code_a << 3) | code_b])


@functools.lru_cache(maxsize=256)
def pp_tables(mod: Modulus) -> PPTables:
    g = num_groups(mod.n)
    tables = {}
    for gamma in range(g):
        for eta in range(g):
            w = group_weight(gamma) * group_weight(eta)
            tables[(gamma, eta)] = tuple(
                (group_value(ca, gamma, mod) * group_value(cb, eta, mod) * w)
                % mod.m for ca in range(8) for cb in range(8))
    return PPTables(mod=mod, tables=tables)


def reduction_levels(n: int) -> int:
    """λ = ⌈log_{3/2}(Γ²/2)⌉, the 3:2-counter tree depth (Stage ③)."""
    g2 = num_groups(n) ** 2
    if g2 <= 2:
        return 0
    return math.ceil(math.log(g2 / 2.0, 1.5))


# --------------------------------------------------------------- stage 3/4 --
@dataclasses.dataclass
class StageTrace:
    """Intermediates of one multiplication, for white-box checks."""

    groups_a: List[int] = dataclasses.field(default_factory=list)
    groups_b: List[int] = dataclasses.field(default_factory=list)
    partial_products: List[int] = dataclasses.field(default_factory=list)
    csa_sum: int = 0
    squeeze_iters: int = 0
    squeeze_values: List[int] = dataclasses.field(default_factory=list)
    final_bin: int = 0
    final_twit: int = 0
    cpa_carry_out: int = 0


def _squeeze(value: int, mod: Modulus, trace: StageTrace | None,
             block_inputs: int = 6) -> int:
    """Stage ④ front half: fold the overflow bits (positions >= n) back in
    blocks of at most ``block_inputs`` inputs — each step replaces the
    lowest chunk c at position n by |c·2^n|_m — until the value fits the
    n + 2 bits the final twit adder accepts."""
    n, m = mod.n, mod.m
    limit = 1 << (n + 2)
    while value >= limit:
        hi = value >> n
        lo = value & mod.mask
        chunk = hi & ((1 << block_inputs) - 1)
        rest = hi >> block_inputs
        value = lo + (chunk << n) % m + (rest << (n + block_inputs))
        if trace is not None:
            trace.squeeze_iters += 1
            trace.squeeze_values.append(value)
        assert value >= 0
    return value


def _final_twit_addition(value: int, mod: Modulus,
                         trace: StageTrace | None) -> int:
    """Stage ④ back half: the twit-compatible final modular addition of an
    (n + 2)-bit value.  A combinational block turns the top bits into
    |hi·2^n|_m, one carry-propagate addition sums, and each carry-out of
    2^n is absorbed as the fold value −s·δ; residues in [2^n, m) of a plus
    modulus keep their twit form and are not folded again."""
    n, m = mod.n, mod.m
    hi = value >> n
    s = (value & mod.mask) + (hi << n) % m
    if trace is not None:
        trace.cpa_carry_out = min(s >> n, 1)
    while True:
        if s < 0:
            s += m
            continue
        if s < (1 << n) or s < m:
            break
        s = (s - (1 << n)) + mod.fold_value
    bin_part, twit = encode(s % m, mod)
    if trace is not None:
        trace.final_bin, trace.final_twit = bin_part, twit
    return decode(bin_part, twit, mod)


def mulmod_twit(a: TwitOperand | int, b: TwitOperand | int, mod: Modulus,
                trace: StageTrace | None = None) -> int:
    """The four-stage twit multiplier: |A·B|_m as a canonical residue.
    Raw residues are encoded first (the representation of Section IV-A)."""
    if not isinstance(a, TwitOperand):
        a = TwitOperand.from_value(int(a), mod)
    if not isinstance(b, TwitOperand):
        b = TwitOperand.from_value(int(b), mod)
    ga, gb = split_operand(a), split_operand(b)             # Stage ①
    if trace is not None:
        trace.groups_a, trace.groups_b = list(ga), list(gb)
    tabs = pp_tables(mod)                                   # Stage ②
    pps = [tabs.pp(gamma, eta, ca, cb)
           for gamma, ca in enumerate(ga) for eta, cb in enumerate(gb)]
    if trace is not None:
        trace.partial_products = list(pps)
    # Section IV-C ②: each PP < m (n bits for 2^n−δ, n+1 for 2^n+δ)
    assert all(0 <= p < mod.m for p in pps)
    s = sum(pps)                                            # Stage ③
    if trace is not None:
        trace.csa_sum = s
    return _final_twit_addition(_squeeze(s, mod, trace), mod, trace)


# ------------------------------------------------------------- tensor form --
@functools.lru_cache(maxsize=256)
def _stacked_tables(mod: Modulus, device: torch.device) -> torch.Tensor:
    """(Γ, Γ, 64) int64 table stack on ``device``, built once per pair."""
    g = num_groups(mod.n)
    tabs = pp_tables(mod)
    return torch.tensor([[tabs.tables[(gamma, eta)] for eta in range(g)]
                         for gamma in range(g)], dtype=torch.int64,
                        device=device)


def _split_tensor(bin_part: torch.Tensor, twit: torch.Tensor,
                  mod: Modulus) -> List[torch.Tensor]:
    """Stage ① on tensors: the Γ group-code tensors."""
    codes = [((twit & 1) << 2) | (bin_part & 0b11)]
    for gamma in range(1, num_groups(mod.n)):
        lo, width = group_bits(gamma, mod.n)
        codes.append((bin_part >> lo) & ((1 << width) - 1))
    return codes


def _squeeze_steps(mod: Modulus) -> int:
    """Trip count of the tensor squeeze: the scalar loop's bound on the
    largest Stage ③ sum Γ²·(m − 1), worked out on Python ints."""
    n, m = mod.n, mod.m
    limit = 1 << (n + 2)
    max_sum = num_groups(n) ** 2 * (m - 1)
    steps = 0
    while max_sum >= limit:
        max_hi = max_sum >> n
        max_sum = (mod.mask + ((max_hi & 0x3F) << n) % m
                   + ((max_hi >> 6) << (n + 6)))
        steps += 1
    return steps


def mulmod_twit_tensor(a: torch.Tensor, b: torch.Tensor,
                       mod: Modulus) -> torch.Tensor:
    """The bit-faithful multiplier over canonical residue tensors ([0, m),
    any integer dtype, any device) into int64: the tensor form of the
    reference's `mulmod_twit_np`, equal to `mulmod_twit` on every pair."""
    bin_a, twit_a = encode(a, mod)
    bin_b, twit_b = encode(b, mod)
    ca = _split_tensor(bin_a, twit_a, mod)
    cb = _split_tensor(bin_b, twit_b, mod)
    tabs = _stacked_tables(mod, bin_a.device)
    s = torch.zeros_like(bin_a)
    for gamma, code_a in enumerate(ca):
        for eta, code_b in enumerate(cb):
            s = s + tabs[gamma, eta][(code_a << 3) | code_b]
    n, m = mod.n, mod.m
    for _ in range(_squeeze_steps(mod)):
        hi = s >> n
        s = (s & mod.mask) + torch.remainder((hi & 0x3F) << n, m) \
            + ((hi >> 6) << (n + 6))
    # final twit addition
    s = (s & mod.mask) + torch.remainder((s >> n) << n, m)
    for _ in range(4):   # <= 3 conditional subtracts by construction
        s = torch.where(s >= m, s - m, s)
    return s
