"""The standalone fold wrapper: port of `repro/kernels/fold.py::fold`.

Stage ④ on its own: (C, S) int32 values in [0, bound) → canonical residues
in [0, m_c) per channel, by the ``ChannelPlan.build(moduli, bound)`` ladder
and its conditional subtracts (`csrc/rns_kernels.cu`, ``rns_fold_kernel``,
the tile kernel's ladder device code, held in registers).  It
reads and writes one int32 per element and does a few integer operations
on it, so device memory bounds it: the kernel streams 16-byte loads and
stores, several in flight per thread, over a grid of a few waves.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.channel_plan import ChannelPlan

from . import _build
from .ref import fold_ref

__all__ = ["fold", "fold_blocks"]

THREADS, UNROLL = 256, 4       # FOLD_THREADS, FOLD_UNROLL of the kernel
RESIDENT = 2048 // THREADS     # blocks an SM holds


def fold_blocks(S: int, C: int, sms: int) -> int:
    """Blocks per channel: one per THREADS·UNROLL int4 of a row, capped at
    four waves of the card over the C channels."""
    need = -(-S // (4 * THREADS * UNROLL))
    return max(1, min(need, 4 * RESIDENT * sms // C))


@functools.lru_cache(maxsize=64)
def _plan_struct(mods: tuple, bound: int) -> _build.Plan:
    return _build.plan_struct(ChannelPlan.build(mods, bound), None)


@_build.kernel_region("fold")
def fold(x: torch.Tensor, moduli: Sequence[int], bound: int) -> torch.Tensor:
    """Canonicalize (C, S) int32 values in [0, ``bound``) into [0, m_c) per
    channel.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel; a meta tensor gets an empty output of the plain version's
    shape and dtype (a dry run).  On DTensor arguments it runs on the
    local shards (`dtensor_rules`): the channels gathered, S as it is."""
    mods = tuple(int(m) for m in moduli)
    bound = int(bound)
    if x.ndim != 2 or x.shape[0] != len(mods):
        raise ValueError(f"need x (C={len(mods)}, S), got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32, got {x.dtype}")
    if x.device.type == "cpu":
        return fold_ref(x, mods, bound)
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"fold runs on cuda or cpu, not {x.device}")
    st = _plan_struct(mods, bound)
    x = x.contiguous()
    out = torch.empty_like(x)
    S = x.shape[1]
    if S == 0:
        return out
    if S >= 2**31:
        raise ValueError(f"fold takes rows of fewer than 2^31 values, got {S}")
    blocks = fold_blocks(S, len(mods), _build.num_sms(x.device.index or 0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().rns_fold_launch(x.data_ptr(), out.data_ptr(), S,
                                          ctypes.byref(st), blocks, stream)
    _build.check(rc, "fold")
    fold.launches += 1
    return out


fold.launches = 0
