"""Conversion kernel wrappers: port of `repro/kernels/rns_convert.py`.

``rns_forward`` (`csrc/rns_kernels.cu`, ``rns_forward_kernel``) reads each
int8/int32 value once and writes its C floored residues; ``rns_reverse``
(``rns_reverse_kernel``) reads C int32 residues per element and writes one
float32 (MRC digits, 15-bit limb Horner, signed fix, optional scale).  Both
are bound by the bytes they move.  ``rns_forward`` encodes the weights at
Engine init, each activation entering a residue chain and, on the staged
path, the weights of every call; ``rns_reverse`` ends every staged linear.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.conversion_plan import ConversionPlan

from . import _build
from .ref import rns_forward_ref, rns_reverse_ref

__all__ = ["rns_forward", "rns_reverse"]

_MAXC = 12


class _ForwardMods(ctypes.Structure):
    _fields_ = [("C", ctypes.c_int), ("m", ctypes.c_int * _MAXC)]


def _blocks(S: int, device) -> int:
    return max(1, min(-(-S // 256), _build.num_sms(device.index or 0) * 16))


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().rns_forward_launch(
        x.data_ptr(), int(x.dtype == torch.int32), out.data_ptr(),
        int(dtype == torch.int32), S, ctypes.byref(cm),
        _blocks(S, x.device), stream)
    _build.check(rc, "rns_forward")
    rns_forward.launches += 1
    return out


rns_forward.launches = 0


@functools.lru_cache(maxsize=64)
def _reverse_struct(plan: ConversionPlan) -> _build.Plan:
    if not plan.device_reversible:
        raise ValueError(f"moduli {plan.moduli} exceed the int32 "
                         "limb-Horner bound of the kernel")
    return _build.plan_struct(None, plan)


def rns_reverse(residues: torch.Tensor, plan: ConversionPlan, *,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C, …) canonical residues → (…) float32 signed values, times
    ``scale`` (broadcast against the output) when given.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel."""
    if residues.ndim < 1 or residues.shape[0] != plan.k:
        raise ValueError(f"residues {tuple(residues.shape)} need {plan.k} "
                         "channels on axis 0")
    if residues.device.type == "cpu":
        return rns_reverse_ref(residues, plan, scale)
    if residues.device.type != "cuda":
        raise ValueError(f"rns_reverse runs on cuda or cpu, not "
                         f"{residues.device}")
    st = _reverse_struct(plan)
    shape = residues.shape[1:]
    r = residues.to(torch.int32).contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=r.device)
    S = out.numel()
    if S == 0:
        return out
    s_ptr = None
    if scale is not None:
        if scale.device != r.device:
            raise ValueError(f"scale on {scale.device}, residues on "
                             f"{r.device}")
        scale = torch.broadcast_to(scale.to(torch.float32),
                                   shape).contiguous()
        s_ptr = scale.data_ptr()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _build.library().rns_reverse_launch(
        r.data_ptr(), s_ptr, out.data_ptr(), S, ctypes.byref(st),
        _blocks(S, r.device), stream)
    _build.check(rc, "rns_reverse")
    rns_reverse.launches += 1
    return out


rns_reverse.launches = 0
