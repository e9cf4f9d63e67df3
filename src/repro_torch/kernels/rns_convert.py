"""Conversion kernel wrappers: port of `repro/kernels/rns_convert.py`.

``rns_forward`` (`csrc/rns_kernels.cu`, ``rns_forward_kernel``) reads each
int8/int32 value once and writes its C floored residues; ``rns_reverse``
(``rns_reverse_kernel``) reads C int32 residues per element and writes one
float32 (MRC digits, 15-bit limb Horner, signed fix, optional scale).  Both
are bound by the bytes they move, and at decode sizes by the fixed cost of
a launch.  ``rns_forward`` encodes the weights at Engine init, each
activation entering a residue chain and, on the staged path, the weights
of every call; ``rns_reverse`` ends every staged linear.

Both kernels stream 16-byte vectors (16 values a forward thread, 4
elements a reverse thread) over a grid-stride loop; the wrappers decide
here which part of S the vectors cover (`vectors`), how the scale is read
(`scale_map`), and the grid (`launch_shape`).  The forward's floored mod
divides by no run-time divisor: it reads the reciprocal tables of
`forward_tables`.  The reverse has one instance per (C, L) in
`REVERSE_INSTANCES`.  A launch allocates nothing but its output.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Sequence

import torch

from repro_torch.core import multiword as mw
from repro_torch.core.conversion_plan import ConversionPlan

from . import _build
from .ref import rns_forward_ref, rns_reverse_ref

__all__ = ["rns_forward", "rns_reverse", "forward_tables", "vectors",
           "scale_map", "launch_shape", "REVERSE_INSTANCES"]

_MAXC = _build.MAXC
SCALE_MAXD = 6       # SCALE_MAXD of the kernel: dimensions of a scale map
FWD_V, REV_V = 16, 4  # values a forward thread, elements a reverse thread
# threads an SM of a grid-stride launch: below what it holds, so that a
# thread of a large launch takes several vectors (measured on an H100,
# `convert_bench.py`: the reverse's integer work gains most from it)
FWD_PER_SM, REV_PER_SM = 1024, 512
_pinned: dict[str, int | None] = {"threads": None, "per_sm": None}


class _ForwardMods(ctypes.Structure):
    _fields_ = [("C", ctypes.c_int), ("m", ctypes.c_int * _MAXC),
                ("mu", ctypes.c_uint * _MAXC), ("mlo", ctypes.c_uint * _MAXC),
                ("neg", ctypes.c_uint * _MAXC)]


class _ScaleMap(ctypes.Structure):
    _fields_ = [("mode", ctypes.c_int), ("nd", ctypes.c_int),
                ("size", ctypes.c_longlong * SCALE_MAXD),
                ("stride", ctypes.c_longlong * SCALE_MAXD)]


def _first_primes(n: int) -> list[int]:
    out, p = [], 2
    while len(out) < n:
        if all(p % q for q in out if q * q <= p):
            out.append(p)
        p += 1
    return out


# Every (C, L) a ConversionPlan of 3-11 channels within the kernels'
# bounds (moduli <= 2^15, L <= MAXL limbs) can have: from the limbs of the
# C smallest pairwise-coprime moduli (the first C primes) to C + 1 (C
# moduli below 2^15 span at most 15·C bits).  The kernel library holds one
# rns_reverse instance for each.
REVERSE_INSTANCES = frozenset(
    (C, L) for C in range(3, 12)
    for L in range(mw.nlimbs_for(math.prod(_first_primes(C))),
                   min(_build.MAXL, C + 1) + 1))


def forward_tables(mods: Sequence[int]) -> dict[str, tuple[int, ...]]:
    """What the forward kernel's divide-free floored mod reads per modulus:
    ``mu`` = floor(2^32/m) + 1 (``__umulhi(u, mu)`` is floor(u/m) or one
    more for any u < 2^32); ``mlo`` = mu·madd mod 2^32, madd the least
    multiple of m that is at least 128 (an int8 v lifted to v + madd >= 0
    has remainder ``__umulhi(mu·v + mlo, m)`` for m <= 128); and ``neg`` =
    |−2^32|_m (a negative int32 v is its unsigned bits − 2^32)."""
    return {"mu": tuple((1 << 32) // m + 1 for m in mods),
            "mlo": tuple(((1 << 32) // m + 1) * (-(-128 // m) * m)
                         % (1 << 32) for m in mods),
            "neg": tuple(-(1 << 32) % m for m in mods)}


@functools.lru_cache(maxsize=64)
def _forward_struct(mods: tuple) -> _ForwardMods:
    t = forward_tables(mods)
    st = _ForwardMods(len(mods))
    for c, m in enumerate(mods):
        st.m[c], st.mu[c], st.mlo[c], st.neg[c] = (
            m, t["mu"][c], t["mlo"][c], t["neg"][c])
    return st


def vectors(S: int, V: int, out_ptr: int, out_plane_bytes: int,
            sms: int) -> int:
    """How many V-element vectors of S a kernel takes: all of them when
    the output starts 16-byte aligned, a plane's bytes (0: one plane) are
    a multiple of 16, and the vectors give every SM at least a warp of
    them; else none, and one thread takes one element.  Below that size
    (a decode step's activations and products) a launch is one dependent
    chain a thread, and V times as many threads finish it sooner."""
    if out_ptr % 16 or out_plane_bytes % 16 or S // V < 32 * sms:
        return 0
    return S // V


def _aligned(ptr: int, plane_bytes: int) -> bool:
    """Every plane of an input that starts at ``ptr`` is 16-byte aligned."""
    return ptr % 16 == 0 and plane_bytes % 16 == 0


def scale_map(shape: Sequence[int], strides: Sequence[int],
              aligned: bool) -> tuple[int, list[tuple[int, int]]]:
    """How the reverse kernel reads a scale whose broadcast view over the
    output ``shape`` has ``strides`` (elements; 0 along broadcast axes):
    (mode, [(size, stride)] innermost first).  Axes of size 1 are dropped
    and neighbours that step alike are merged.  Mode 1: the view is the
    output's own layout and starts 16-byte aligned (float4 loads); mode 2:
    element e reads the offset the dimensions give it."""
    dims: list[tuple[int, int]] = []
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size == 1:
            continue
        if dims and stride == dims[-1][1] * dims[-1][0]:
            dims[-1] = (dims[-1][0] * size, dims[-1][1])
        else:
            dims.append((size, stride))
    if len(dims) > SCALE_MAXD:
        raise ValueError(f"scale broadcast over {len(dims)} separate axes; "
                         f"the kernel reads at most {SCALE_MAXD}")
    contiguous = len(dims) == 1 and dims[0][1] == 1
    return (1 if contiguous and aligned else 2), dims


def launch_shape(nwork: int, sms: int, per_sm: int) -> tuple[int, int]:
    """(blocks, threads) of a grid-stride launch over ``nwork`` items: the
    largest block of 256 or 128 threads that still gives every SM a block,
    else 64; at most ``per_sm`` threads an SM, so that a thread of a large
    launch takes several items and reads the next while it converts
    one."""
    threads = _pinned["threads"] or next(
        (t for t in (256, 128) if -(-nwork // t) >= sms), 64)
    per_sm = _pinned["per_sm"] or per_sm
    return max(1, min(-(-nwork // threads),
                      max(1, per_sm // threads) * sms)), threads


@contextlib.contextmanager
def _pin_launch(threads: int | None = None, per_sm: int | None = None):
    """Launch both kernels with ``threads``-thread blocks and at most
    ``per_sm`` threads an SM (tests and measurement only)."""
    before = dict(_pinned)
    _pinned.update(threads=threads, per_sm=per_sm)
    try:
        yield
    finally:
        _pinned.update(before)


@_build.kernel_region("rns_forward")
def rns_forward(x: torch.Tensor, moduli: Sequence[int], *,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(…,) int8/int32 → (C, …) canonical residues in ``dtype`` (int8 or
    int32).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel; a meta tensor gets an empty output of the plain version's
    shape and dtype (a dry run).  On DTensor arguments it runs on the
    local shards (`dtensor_rules`): x's shardings, one dim further right."""
    mods = tuple(int(m) for m in moduli)
    if x.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"rns_forward takes int8 or int32, got {x.dtype}")
    if dtype not in (torch.int8, torch.int32):
        raise ValueError(f"residue dtype must be int8 or int32, got {dtype}")
    if dtype == torch.int8 and max(mods) > 128:
        raise ValueError(f"moduli {mods} have residues beyond int8")
    if not 0 < len(mods) <= _MAXC or min(mods) < 2 or max(mods) >= 1 << 31:
        raise ValueError(f"need 1..{_MAXC} moduli in [2, 2^31), got {mods}")
    if x.device.type == "cpu":
        return rns_forward_ref(x, mods, dtype)
    if x.device.type == "meta":
        return torch.empty((len(mods),) + tuple(x.shape), dtype=dtype,
                           device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"rns_forward runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    S = x.numel()
    out = torch.empty((len(mods),) + tuple(x.shape), dtype=dtype,
                      device=x.device)
    if S == 0:
        return out
    sms = _build.num_sms(x.device.index or 0)
    nvec = vectors(S, FWD_V, out.data_ptr(), S * out.element_size(), sms)
    blocks, threads = launch_shape(max(nvec, S - FWD_V * nvec), sms,
                                   FWD_PER_SM)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().rns_forward_launch(
        x.data_ptr(), int(x.dtype == torch.int32), out.data_ptr(),
        int(dtype == torch.int32), S, nvec, int(_aligned(x.data_ptr(), 0)),
        ctypes.byref(_forward_struct(mods)), blocks, threads, stream)
    _build.check(rc, "rns_forward")
    rns_forward.launches += 1
    return out


rns_forward.launches = 0


@functools.lru_cache(maxsize=64)
def _reverse_struct(plan: ConversionPlan) -> _build.Plan:
    if not plan.device_reversible:
        raise ValueError(f"moduli {plan.moduli} exceed the int32 "
                         "limb-Horner bound of the kernel")
    if (plan.k, plan.nlimbs) not in REVERSE_INSTANCES:
        raise ValueError(f"no rns_reverse instance for C={plan.k}, "
                         f"L={plan.nlimbs}")
    return _build.plan_struct(None, plan)


@_build.kernel_region("rns_reverse")
def rns_reverse(residues: torch.Tensor, plan: ConversionPlan, *,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C, …) canonical residues → (…) float32 signed values, times
    ``scale`` (broadcast against the output) when given.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel; a meta tensor gets
    an empty output of the plain version's shape and dtype (a dry run).
    On DTensor arguments it runs on the local shards (`dtensor_rules`):
    the channels gathered, every other dim as it is, ``scale`` sharded
    where it spans the output dim."""
    if residues.ndim < 1 or residues.shape[0] != plan.k:
        raise ValueError(f"residues {tuple(residues.shape)} need {plan.k} "
                         "channels on axis 0")
    if residues.device.type == "cpu":
        return rns_reverse_ref(residues, plan, scale)
    if residues.device.type == "meta":
        return torch.empty(residues.shape[1:], dtype=torch.float32,
                           device="meta")
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
    sms = _build.num_sms(r.device.index or 0)
    nvec = vectors(S, REV_V, out.data_ptr(), 0, sms)
    sm, s_ptr = _ScaleMap(0, 0), None
    if scale is not None:
        if scale.device != r.device:
            raise ValueError(f"scale on {scale.device}, residues on "
                             f"{r.device}")
        view = torch.broadcast_to(scale.to(torch.float32), shape)
        s_ptr = view.data_ptr()
        mode, dims = scale_map(shape, view.stride(),
                               nvec > 0 and s_ptr % 16 == 0)
        sm = _ScaleMap(mode, len(dims))
        for d, (size, stride) in enumerate(dims):
            sm.size[d], sm.stride[d] = size, stride
    blocks, threads = launch_shape(max(nvec, S - REV_V * nvec), sms,
                                   REV_PER_SM)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _build.library().rns_reverse_launch(
        r.data_ptr(), s_ptr, ctypes.byref(sm), out.data_ptr(), S, nvec,
        int(_aligned(r.data_ptr(), 4 * S)), ctypes.byref(st), blocks,
        threads, stream)
    _build.check(rc, "rns_reverse")
    rns_reverse.launches += 1
    return out


rns_reverse.launches = 0
