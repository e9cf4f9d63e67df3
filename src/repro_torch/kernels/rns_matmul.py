"""The staged channel matmul wrapper: port of
`repro/kernels/rns_matmul.py::rns_matmul`.

|A·B|_{m_c} for every channel c: a (C, M, K) canonical residue operand, or
one (1, M, K) raw signed int8 plane shared by every channel (the broadcast
form, ``signed_a``), times (C, K, N) weight residues, accumulated in int32
without reduction and folded once by the plan's ladder into (C, M, N)
canonical int32 residues.  On the card it is the tile kernel of
`csrc/rns_common.cuh` with the canonical-residue epilogue (no MRC); the
kernel's header says what bounds it and how the design answers it.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from repro_torch.core.channel_plan import ChannelPlan

from . import _build
from .ref import rns_matmul_ref
from .rns_fused import A_PLANES, A_SHARED, EMIT_CANONICAL, launch_tile

__all__ = ["rns_matmul"]


@functools.lru_cache(maxsize=256)
def _plan_struct(plan: ChannelPlan) -> _build.Plan:
    return _build.plan_struct(plan, None)


@_build.kernel_region("rns_matmul")
def rns_matmul(a_res: torch.Tensor, b_res: torch.Tensor,
               moduli: Sequence[int], *, signed_a: bool = False,
               plan: ChannelPlan | None = None) -> torch.Tensor:
    """(C or 1, M, K) int8 × (C, K, N) int8 residues → (C, M, N) int32.

    ``plan`` defaults to ``ChannelPlan.for_matmul(moduli, K,
    signed=signed_a)``; its signedness must match ``signed_a``.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel; a
    meta tensor gets an empty output of the plain version's shape and dtype
    (a dry run).  On DTensor arguments it runs on the local shards
    (`dtensor_rules`): the rows of ``a_res`` and the columns of ``b_res``
    stay sharded, K and the channels are gathered."""
    mods = tuple(int(m) for m in moduli)
    if a_res.ndim != 3 or b_res.ndim != 3:
        raise ValueError(f"need (C, M, K) and (C, K, N) residues, got "
                         f"{tuple(a_res.shape)} and {tuple(b_res.shape)}")
    Ca, M, K = a_res.shape
    C, K2, N = b_res.shape
    if C != len(mods) or K2 != K or Ca not in (1, C):
        raise ValueError(f"operands {tuple(a_res.shape)} × "
                         f"{tuple(b_res.shape)} do not fit moduli {mods}")
    if Ca == 1 and C > 1 and not signed_a:
        raise ValueError("a one-plane (broadcast) operand needs signed_a")
    if plan is None:
        plan = ChannelPlan.for_matmul(mods, K, signed=signed_a)
    elif plan.moduli != mods or plan.signed != signed_a:
        raise ValueError(f"plan (moduli {plan.moduli}, signed {plan.signed})"
                         f" does not match moduli={mods}, signed_a={signed_a}")
    if a_res.device.type == "cpu":
        return rns_matmul_ref(a_res, b_res, mods, signed_a=signed_a,
                              plan=plan)
    if a_res.device.type == "meta":
        return torch.empty((C, M, N), dtype=torch.int32, device="meta")
    if a_res.device.type != "cuda":
        raise ValueError(f"rns_matmul runs on cuda or cpu, not "
                         f"{a_res.device}")
    if b_res.device != a_res.device:
        raise ValueError(f"b_res on {b_res.device}, a_res on {a_res.device}")
    if a_res.dtype != torch.int8 or b_res.dtype != torch.int8:
        raise ValueError(f"the kernel takes int8 residues, got {a_res.dtype} "
                         f"and {b_res.dtype}")
    out = torch.empty((C, M, N), dtype=torch.int32, device=a_res.device)
    if M == 0 or N == 0:
        return out
    launch_tile(A_SHARED if Ca < C else A_PLANES, EMIT_CANONICAL,
                _plan_struct(plan), x=a_res.contiguous(),
                w=b_res.contiguous(), out=out, M=M, K=K, N=N, C=C,
                name="rns_matmul")
    rns_matmul.launches += 1
    return out


rns_matmul.launches = 0
