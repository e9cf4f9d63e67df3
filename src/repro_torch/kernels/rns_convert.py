"""Forward conversion kernel wrapper: port of
`repro/kernels/rns_convert.py::rns_forward`.

The CUDA kernel (`csrc/rns_kernels.cu`, ``rns_forward_kernel``) reads each
int8/int32 value once and writes its C floored residues; it is bound by the
bytes it moves (S in, C·S out).  It encodes the weights at Engine init.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .ref import rns_forward_ref

__all__ = ["rns_forward"]

_MAXC = 12


class _ForwardMods(ctypes.Structure):
    _fields_ = [("C", ctypes.c_int), ("m", ctypes.c_int * _MAXC)]


def rns_forward(x: torch.Tensor, moduli: Sequence[int], *,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(…,) int8/int32 → (C, …) canonical residues in ``dtype`` (int8 or
    int32).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel."""
    mods = tuple(int(m) for m in moduli)
    if x.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"rns_forward takes int8 or int32, got {x.dtype}")
    if dtype not in (torch.int8, torch.int32):
        raise ValueError(f"residue dtype must be int8 or int32, got {dtype}")
    if dtype == torch.int8 and max(mods) > 128:
        raise ValueError(f"moduli {mods} have residues beyond int8")
    if not 0 < len(mods) <= _MAXC or min(mods) < 2:
        raise ValueError(f"need 1..{_MAXC} moduli >= 2, got {mods}")
    if x.device.type == "cpu":
        return rns_forward_ref(x, mods, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rns_forward runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    S = x.numel()
    out = torch.empty((len(mods),) + tuple(x.shape), dtype=dtype,
                      device=x.device)
    if S == 0:
        return out
    cm = _ForwardMods(len(mods), (ctypes.c_int * _MAXC)(*mods))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min((S + 255) // 256, sms * 16))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().rns_forward_launch(
        x.data_ptr(), int(x.dtype == torch.int32), out.data_ptr(),
        int(dtype == torch.int32), S, ctypes.byref(cm), blocks, stream)
    _build.check(rc, "rns_forward")
    rns_forward.launches += 1
    return out


rns_forward.launches = 0
