"""ChannelPlan: the Stage-④ fold plan, port of `repro/core/channel_plan.py`.

For one ``(moduli, bound)`` pair the plan precomputes the per-channel fold
ladders (padded to a common rung count with the provable no-op rung
``(30, 0)``), the shared conditional-subtract count ``n_sub``, and the
signedness of the accumulator.  ``sched``/``mods``/``n_sub`` are what the
CUDA epilogue receives (`kernels/rns_fused.py`); `apply_ladder`,
`fold_signed` and `fold` are the same ladder on torch int32 tensors, used by
the plain versions in `kernels/ref.py`.

`matmul`, `matmul_broadcast` and `modmul` are the staged datapath's channel
ops.  Each goes to its kernel wrapper (`kernels/rns_matmul.py`,
`kernels/rns_modmul.py`), which launches the CUDA kernel on a CUDA tensor
and runs the plain version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .folding import INT32_SAFE, fold_schedule, max_subtracts
from .twit import Modulus, is_power_of_two

__all__ = ["ChannelPlan", "residue_dtype_for", "matmul", "matmul_broadcast",
           "modmul"]

# Every post-ladder value is < 4m < 2^30, so ``v & (2^30 - 1)`` keeps it and
# the hi term adds 0: a pad rung changes nothing.
_PAD_RUNG = (30, 0)


def residue_dtype_for(moduli) -> torch.dtype:
    """int8 when every residue fits an int8 operand, int32 otherwise."""
    return torch.int8 if max(moduli) <= 128 else torch.int32


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Frozen, hashable Stage-④ plan for one ``(moduli, bound)`` pair."""

    moduli: Tuple[int, ...]
    channels: Tuple[Optional[Modulus], ...]
    bound: int
    rungs: Tuple[Tuple[Tuple[int, int], ...], ...]   # (C, R, 2), padded
    n_sub: int
    signed: bool = False

    @classmethod
    def build(cls, moduli: Sequence[int], bound: int, *,
              signed: bool = False, max_rungs: int = 6) -> "ChannelPlan":
        """Plan for accumulators in [-bound, bound] (signed) or [0, bound];
        raises on int32 overflow."""
        mods = tuple(int(m) for m in moduli)
        chans = tuple(None if is_power_of_two(m) else Modulus.from_value(m)
                      for m in mods)
        return _build_plan(mods, chans, int(bound), bool(signed),
                           int(max_rungs))

    @classmethod
    def for_channels(cls, channels: Sequence[Modulus], bound: int, *,
                     signed: bool = False,
                     max_rungs: int = 6) -> "ChannelPlan":
        """Plan over explicit :class:`Modulus` descriptors, which keep a
        forced channel width n (the paper's all-n = 5 case study)."""
        chans = tuple(channels)
        mods = tuple(ch.m for ch in chans)
        chans = tuple(None if ch.is_pow2 else ch for ch in chans)
        return _build_plan(mods, chans, int(bound), bool(signed),
                           int(max_rungs))

    @classmethod
    def for_matmul(cls, moduli: Sequence[int], k: int, *,
                   signed: bool = False) -> "ChannelPlan":
        """Plan for a K-deep deferred-reduction matmul: |acc| <=
        K·max(m−1)² for canonical operands, K·128·max(m−1) for raw signed
        int8 activations against canonical weight residues."""
        return _for_matmul(tuple(int(m) for m in moduli), int(k),
                           bool(signed))

    @classmethod
    def for_product(cls, moduli: Sequence[int]) -> "ChannelPlan":
        """Plan for one elementwise residue product: bound max(m−1)²."""
        mods = tuple(int(m) for m in moduli)
        return cls.build(mods, max((m - 1) ** 2 for m in mods))

    @property
    def k(self) -> int:
        return len(self.moduli)

    @property
    def num_rungs(self) -> int:
        return len(self.rungs[0]) if self.rungs else 0

    @functools.cached_property
    def sched(self) -> np.ndarray:
        """(C, R, 2) int32 rung table."""
        return np.asarray(self.rungs, dtype=np.int32).reshape(
            self.k, self.num_rungs, 2)

    @functools.cached_property
    def mods(self) -> np.ndarray:
        return np.asarray(self.moduli, dtype=np.int32)

    @property
    def residue_dtype(self) -> torch.dtype:
        return residue_dtype_for(self.moduli)

    def apply_ladder(self, x: torch.Tensor, c: int | None = None, *,
                     sched=None, m: int | None = None) -> torch.Tensor:
        """Channel ``c``'s fold ladder and ``n_sub`` conditional subtracts on
        a nonnegative int32 tensor: result canonical in [0, m_c).  A
        channel-slice launch passes its own rung rows ``sched`` ((R, 2)
        ints) and modulus ``m`` instead of ``c``."""
        rungs = self.rungs[c] if sched is None else sched
        m = self.moduli[c] if m is None else int(m)
        for s, cc in rungs:
            x = (x & ((1 << int(s)) - 1)) + (x >> int(s)) * int(cc)
        for _ in range(self.n_sub):
            x = torch.where(x >= m, x - m, x)
        return x

    def fold_signed(self, x: torch.Tensor, c: int | None = None, *,
                    sched=None, m: int | None = None) -> torch.Tensor:
        """Ladder for possibly-negative accumulators: fold |x|, then
        (−v) mod m = m − (v mod m) where x < 0 and the residue is nonzero."""
        m = self.moduli[c] if m is None else int(m)
        r = self.apply_ladder(torch.abs(x), c, sched=sched, m=m)
        return torch.where((x < 0) & (r > 0), m - r, r)

    def fold(self, x: torch.Tensor, c: int | None = None, *, sched=None,
             m: int | None = None) -> torch.Tensor:
        if self.signed:
            return self.fold_signed(x, c, sched=sched, m=m)
        return self.apply_ladder(x, c, sched=sched, m=m)


@functools.lru_cache(maxsize=1024)
def _for_matmul(mods: Tuple[int, ...], k: int, signed: bool) -> ChannelPlan:
    if signed:
        bound = k * 128 * max(m - 1 for m in mods)
    else:
        bound = k * max((m - 1) ** 2 for m in mods)
    if bound > INT32_SAFE:
        raise ValueError(
            f"int32 accumulator overflow: K={k}, moduli={mods}, "
            f"bound={bound} >= 2^31")
    return ChannelPlan.build(mods, bound, signed=signed)


@functools.lru_cache(maxsize=1024)
def _build_plan(moduli: Tuple[int, ...],
                channels: Tuple[Optional[Modulus], ...],
                bound: int, signed: bool, max_rungs: int) -> ChannelPlan:
    if bound > INT32_SAFE:
        raise ValueError(f"bound {bound} exceeds the int32 accumulator range")
    scheds = []
    n_sub = 1
    for m, ch in zip(moduli, channels):
        if ch is None:                    # power of two: mask-only reduction
            scheds.append([(int(np.log2(m)), 0)])
            continue
        sc = list(fold_schedule(bound, ch, target_multiple=4,
                                max_rungs=max_rungs))
        n_sub = max(n_sub, max_subtracts(bound, sc, m))
        scheds.append(sc)
    R = max(len(s) for s in scheds)
    rungs = tuple(tuple(s) + (_PAD_RUNG,) * (R - len(s)) for s in scheds)
    return ChannelPlan(moduli=moduli, channels=channels, bound=bound,
                       rungs=rungs, n_sub=n_sub, signed=signed)


def matmul(a_res: torch.Tensor, b_res: torch.Tensor, moduli: Sequence[int],
           *, plan: ChannelPlan | None = None) -> torch.Tensor:
    """|A·B|_{m_c} per channel: (C, M, K) × (C, K, N) residues → (C, M, N)
    int32 canonical residues."""
    from repro_torch.kernels.rns_matmul import rns_matmul

    return rns_matmul(a_res, b_res, moduli, plan=plan,
                      signed_a=plan.signed if plan is not None else False)


def matmul_broadcast(x: torch.Tensor, w: torch.Tensor, moduli: Sequence[int],
                     *, encoded: bool = False) -> torch.Tensor:
    """(M, K) raw signed int8 × (K, N) int8 weights → (C, M, N) canonical
    residues: Σ x·w ≡ Σ x·|w|_m, so only the weights are forward-converted
    (not even those when ``encoded``: ``w`` is then the (C, K, N) residue
    stack) and the activation block is shared by every channel."""
    from repro_torch.kernels.rns_matmul import rns_matmul

    from .conversion_plan import forward

    mods = tuple(int(m) for m in moduli)
    if encoded and (w.ndim != 3 or w.shape[0] != len(mods)):
        raise ValueError(f"encoded weights must be (C, K, N) residues with "
                         f"C={len(mods)}, got {tuple(w.shape)}")
    plan = ChannelPlan.for_matmul(mods, w.shape[-2], signed=True)
    w_res = w if encoded else forward(w, mods, plan.residue_dtype)
    return rns_matmul(x[None], w_res, mods, signed_a=True, plan=plan)


def modmul(a_res: torch.Tensor, b_res: torch.Tensor, moduli: Sequence[int],
           *, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """|a·b|_{m_c} elementwise over (C, …) residue planes → ``out_dtype``
    (int32, or int8 for moduli <= 128)."""
    from repro_torch.kernels.rns_modmul import rns_modmul

    return rns_modmul(a_res, b_res, moduli, out_dtype=out_dtype)
