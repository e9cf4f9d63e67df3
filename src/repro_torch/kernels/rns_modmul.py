"""The elementwise residue multiply wrapper: port of
`repro/kernels/rns_modmul.py::rns_modmul`.

|a·b|_{m_c} over (C, …) residue planes: one int32 product per element and
the ``ChannelPlan.for_product`` fold ladder (`csrc/rns_kernels.cu`,
``rns_modmul_kernel``).  It reads two operands and writes one int32 result
per element, so device memory bounds it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.channel_plan import ChannelPlan

from . import _build
from .ref import rns_modmul_ref

__all__ = ["rns_modmul"]


@functools.lru_cache(maxsize=64)
def _plan_struct(mods: tuple) -> _build.Plan:
    return _build.plan_struct(ChannelPlan.for_product(mods), None)


def rns_modmul(a_res: torch.Tensor, b_res: torch.Tensor,
               moduli: Sequence[int]) -> torch.Tensor:
    """(C, …) × (C, …) int8 or int32 residues → (C, …) int32 canonical
    products.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel."""
    mods = tuple(int(m) for m in moduli)
    if a_res.shape != b_res.shape or a_res.shape[0] != len(mods):
        raise ValueError(f"need two (C={len(mods)}, ...) operands of one "
                         f"shape, got {tuple(a_res.shape)} and "
                         f"{tuple(b_res.shape)}")
    if a_res.device.type == "cpu":
        return rns_modmul_ref(a_res, b_res, mods)
    if a_res.device.type != "cuda":
        raise ValueError(f"rns_modmul runs on cuda or cpu, not "
                         f"{a_res.device}")
    if b_res.device != a_res.device or a_res.dtype != b_res.dtype \
            or a_res.dtype not in (torch.int8, torch.int32):
        raise ValueError("the kernel takes two int8 or two int32 operands on "
                         f"one device, got {a_res.dtype} on {a_res.device} "
                         f"and {b_res.dtype} on {b_res.device}")
    st = _plan_struct(mods)
    a, b = a_res.contiguous(), b_res.contiguous()
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    S = a.numel() // len(mods)
    if S == 0:
        return out
    blocks = max(1, min(-(-S // 256), _build.num_sms(a.device.index or 0)
                        * 16 // len(mods)))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _build.library().rns_modmul_launch(
        a.data_ptr(), b.data_ptr(), int(a.dtype == torch.int32),
        out.data_ptr(), S, ctypes.byref(st), blocks, stream)
    _build.check(rc, "rns_modmul")
    rns_modmul.launches += 1
    return out


rns_modmul.launches = 0
