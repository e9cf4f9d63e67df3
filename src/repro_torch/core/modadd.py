"""Twit-compatible modular addition and subtraction for moduli 2^n ± δ,
port of `repro/core/modadd.py`.

The generic modulo-(2^n ± δ) adder of the authors' prior work (ARITH'25),
on which the multiplier's Stage ④ rests, as an arithmetically exact model
with its published structure:

  1. a small combinational block selects the constant contribution
     C(t_A, t_B) = |(t_A + t_B)·s·δ|_m (a 2-input block, four cases);
  2. one carry-save level combines (bin_A, bin_B, C);
  3. a single carry-propagate addition resolves the sum;
  4. the carry-outs are absorbed through the end-around congruence
     2^n ≡ −s·δ (mod m), the twit correction.

Every intermediate fits n + 2 bits.  `addmod_twit_tensor` is the tensor
form of the reference's `addmod_twit_np`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from .twit import Modulus, TwitOperand, decode, encode

__all__ = ["addmod_twit", "addmod_twit_tensor", "submod_twit",
           "negate_twit", "AddTrace"]


@dataclasses.dataclass
class AddTrace:
    """Intermediates of one twit addition, for white-box tests."""

    csa_constant: int = 0
    cpa_sum: int = 0
    carry_out: int = 0
    final_bin: int = 0
    final_twit: int = 0


@functools.lru_cache(maxsize=512)
def _twit_constants(mod: Modulus) -> Tuple[int, int, int, int]:
    """C(t_A, t_B) = |(t_A + t_B)·s·δ|_m for the four twit-bit pairs: the
    lookup of the adder's 2-input block, each constant below 2m."""
    return tuple(((ta + tb) * mod.twit_value) % mod.m
                 for ta in (0, 1) for tb in (0, 1))


@functools.lru_cache(maxsize=512)
def _constants_tensor(mod: Modulus, device: torch.device) -> torch.Tensor:
    """The four constants on ``device``, built once per pair (so a CUDA
    graph can capture the adder: it copies nothing from the host)."""
    return torch.tensor(_twit_constants(mod), dtype=torch.int64,
                        device=device)


def _resolve(s: int, mod: Modulus, trace: AddTrace | None) -> int:
    """Single-CPA resolution with the end-around twit correction.

    ``s`` fits n + 2 bits; each wrap of 2^n is absorbed as the fold value
    −s·δ, with at most two bounded correction selects — no division, no
    iteration count that depends on data."""
    n, m = mod.n, mod.m
    if trace is not None:
        trace.cpa_sum = s
        trace.carry_out = min(s >> n, 1)
    hi = s >> n                    # s < 4·2^n ⇒ hi ∈ {0..3}
    s = (s & mod.mask) + hi * mod.fold_value
    while s < 0:
        s += m
    while s >= m:
        s -= m
    bin_part, twit = encode(s, mod)
    if trace is not None:
        trace.final_bin, trace.final_twit = bin_part, twit
    return decode(bin_part, twit, mod)


def addmod_twit(a: TwitOperand | int, b: TwitOperand | int, mod: Modulus,
                trace: AddTrace | None = None) -> int:
    """|A + B|_m through the twit adder's organization."""
    if not isinstance(a, TwitOperand):
        a = TwitOperand.from_value(int(a), mod)
    if not isinstance(b, TwitOperand):
        b = TwitOperand.from_value(int(b), mod)
    const = _twit_constants(mod)[(a.twit << 1) | b.twit]
    if trace is not None:
        trace.csa_constant = const
    # carry-save level (its arithmetic effect is the sum) + a single CPA
    return _resolve(a.bin + b.bin + const, mod, trace)


def negate_twit(a: TwitOperand | int, mod: Modulus) -> TwitOperand:
    """Additive inverse |−A|_m as a twit codeword."""
    if not isinstance(a, TwitOperand):
        a = TwitOperand.from_value(int(a), mod)
    return TwitOperand.from_value((mod.m - a.value) % mod.m, mod)


def submod_twit(a: TwitOperand | int, b: TwitOperand | int,
                mod: Modulus) -> int:
    """|A − B|_m = A + (−B): subtraction reuses the adder datapath."""
    return addmod_twit(a, negate_twit(b, mod), mod)


def addmod_twit_tensor(a: torch.Tensor, b: torch.Tensor,
                       mod: Modulus) -> torch.Tensor:
    """The twit adder over canonical residue tensors ([0, m), any integer
    dtype, any device) into int64: the tensor form of the reference's
    `addmod_twit_np`, step for step."""
    bin_a, twit_a = encode(a, mod)
    bin_b, twit_b = encode(b, mod)
    consts = _constants_tensor(mod, bin_a.device)
    s = bin_a + bin_b + consts[(twit_a << 1) | twit_b]
    hi = s >> mod.n
    s = (s & mod.mask) + hi * mod.fold_value
    s = torch.where(s < 0, s + mod.m, s)
    for _ in range(3):  # bounded canonicalization (selects in hardware)
        s = torch.where(s >= mod.m, s - mod.m, s)
    return s
