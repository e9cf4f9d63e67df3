"""The elementwise residue multiply wrapper: port of
`repro/kernels/rns_modmul.py::rns_modmul`.

|a·b|_{m_c} over (C, …) planes of canonical residues (`csrc/rns_kernels.cu`,
``rns_modmul_kernel``): one int32 product per element and a divide-free
floored mod by the channel's reciprocal mu = floor(2^32/m) + 1 (the
forward's `rns_convert.forward_tables`).  Where every product p of a
plane satisfies p·(mu·m − 2^32) < 2^32 (`direct_mod`: int8 operands, and
int32 ones of every modulus below 1,649) the remainder is the high word of
m times the low word of mu·p, in two multiplies; otherwise the quotient
estimate floor(p·mu/2^32), exact or one over, and one correction.  It
reads two operands and writes one result per element, so device memory
bounds it, and at a decode step's size the fixed cost of a launch.

Each grid row takes one plane; a plane of at least a warp of 16-value
vectors an SM streams them (`rns_convert.vectors`; for an int32 output in
whole runs of 512 values a warp, so that its stores are contiguous), a
smaller one takes one element a thread.  ``out_dtype`` (int32, the reference's contract, or int8
when every modulus is at most 128) lets the staged chain take its residue
type from the same launch.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core.channel_plan import ChannelPlan

from . import _build
from .ref import rns_modmul_ref
from .rns_convert import _aligned, _forward_struct, launch_shape, vectors

__all__ = ["rns_modmul", "direct_mod"]

MODMUL_V = 16          # values of a plane a thread takes on the vector path
MODMUL_PER_SM = 1024   # grid cap, threads an SM (as the forward's)


def direct_mod(mods: Sequence[int], dtype: torch.dtype) -> bool:
    """Whether the kernel's two-multiply remainder is exact for canonical
    ``dtype`` operands of every modulus: with mu·m = 2^32 + e (0 < e <= m)
    the low word of mu·p is q·e + mu·r for p = q·m + r, and m times it over
    2^32 is r + floor(e·p / 2^32), so it needs e·p < 2^32 for the largest
    product p (operands below min(m, 128) for int8, m for int32)."""
    top = 128 if dtype == torch.int8 else None
    for m in mods:
        e = ((1 << 32) // m + 1) * m - (1 << 32)
        hi = min(m, top or m) - 1
        if e * hi * hi >= 1 << 32:
            return False
    return True


@_build.kernel_region("rns_modmul")
def rns_modmul(a_res: torch.Tensor, b_res: torch.Tensor,
               moduli: Sequence[int], *,
               out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(C, …) × (C, …) int8 or int32 canonical residues → (C, …) canonical
    products in ``out_dtype`` (int32, or int8 when every modulus is at most
    128).  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel; a meta tensor gets an empty output of the plain version's shape
    and dtype (a dry run).  On DTensor arguments it runs on the local
    shards (`dtensor_rules`): the channels gathered, every other dim as
    ``a_res`` has it."""
    mods = tuple(int(m) for m in moduli)
    if a_res.shape != b_res.shape or a_res.shape[0] != len(mods):
        raise ValueError(f"need two (C={len(mods)}, ...) operands of one "
                         f"shape, got {tuple(a_res.shape)} and "
                         f"{tuple(b_res.shape)}")
    if out_dtype not in (torch.int32, torch.int8) or (
            out_dtype == torch.int8 and max(mods) > 128):
        raise ValueError(f"out_dtype must be int32, or int8 for moduli <= "
                         f"128; got {out_dtype} for {mods}")
    ChannelPlan.for_product(mods)          # raises past the int32 bound
    if len(mods) > _build.MAXC:
        raise ValueError(f"rns_modmul takes at most {_build.MAXC} channels, "
                         f"got {len(mods)}")
    if a_res.device.type == "cpu":
        return rns_modmul_ref(a_res, b_res, mods, out_dtype=out_dtype)
    if a_res.device.type == "meta":
        return torch.empty(a_res.shape, dtype=out_dtype, device="meta")
    if a_res.device.type != "cuda":
        raise ValueError(f"rns_modmul runs on cuda or cpu, not "
                         f"{a_res.device}")
    if b_res.device != a_res.device or a_res.dtype != b_res.dtype \
            or a_res.dtype not in (torch.int8, torch.int32):
        raise ValueError("the kernel takes two int8 or two int32 operands on "
                         f"one device, got {a_res.dtype} on {a_res.device} "
                         f"and {b_res.dtype} on {b_res.device}")
    a, b = a_res.contiguous(), b_res.contiguous()
    out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    C = len(mods)
    S = a.numel() // C
    if S == 0:
        return out
    sms = _build.num_sms(a.device.index or 0)
    nvec = vectors(S, MODMUL_V, out.data_ptr(), S * out.element_size(), sms)
    if out_dtype == torch.int32:
        nvec -= nvec % 32             # whole 512-value runs of a warp
    avec = all(_aligned(t.data_ptr(), S * t.element_size()) for t in (a, b))
    work = nvec if nvec else S          # vectors, or elements, of a plane
    blocks, threads = launch_shape(C * work, sms, MODMUL_PER_SM)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _build.library().rns_modmul_launch(
        a.data_ptr(), b.data_ptr(), int(a.dtype == torch.int32),
        out.data_ptr(), int(out_dtype == torch.int32), S, nvec, int(avec),
        int(direct_mod(mods, a.dtype)), ctypes.byref(_forward_struct(mods)),
        -(-blocks // C), threads, stream)
    _build.check(rc, "rns_modmul")
    rns_modmul.launches += 1
    return out


rns_modmul.launches = 0
