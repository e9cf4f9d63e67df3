"""The fused RNS linear kernel wrapper: port of
`repro/kernels/rns_fused.py::rns_fused_matmul`, quantize + float-emit
variant (the serving path of ``rns_dense``).

One launch does Stage ②–⑤: round/clip of the float activations by the row
scale, C per-channel int8 products into int32, the signed fold ladder, MRC
digits, 15-bit limb Horner, the signed fix, the float32 recombination and
``(y·s_row)·s_col``.  The CUDA source is `csrc/rns_kernels.cu`; its header
says what bounds the kernel on an H100 and how the design answers it.  The
residue-in / gate / ``emit="residues"`` and CRT-partial variants are not
ported yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import multiword as mw
from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.rns import basis_for_int8_matmul
from repro_torch.core.rns_tensor import RNSTensor

from . import _build
from .ref import rns_fused_matmul_ref

__all__ = ["rns_fused_matmul"]

_MAXC, _MAXR, _MAXL = 12, 8, 6
_TM, _TN, _TK = 16, 64, 32          # tile shape compiled into the kernel
_MIN_KTILES_PER_SPLIT = 1


class _FusedPlan(ctypes.Structure):
    _fields_ = [("C", ctypes.c_int), ("R", ctypes.c_int),
                ("n_sub", ctypes.c_int), ("L", ctypes.c_int),
                ("mods", ctypes.c_int * _MAXC),
                ("sched_s", (ctypes.c_int * _MAXR) * _MAXC),
                ("sched_c", (ctypes.c_int * _MAXR) * _MAXC),
                ("inv", (ctypes.c_int * _MAXC) * _MAXC),
                ("M_limbs", ctypes.c_int * _MAXL),
                ("half_limbs", ctypes.c_int * _MAXL)]


@functools.lru_cache(maxsize=256)
def _kernel_plan(basis, K: int):
    """(plan, conv, argument struct) of the K-deep launch in ``basis``,
    built once per (basis, K): the hot path does no plan work."""
    moduli = tuple(int(m) for m in basis.moduli)
    plan = ChannelPlan.for_matmul(moduli, K, signed=True)
    conv = ConversionPlan.for_basis(basis)
    if plan.residue_dtype != torch.int8 or not conv.device_reversible:
        raise ValueError(f"basis {moduli} needs residues or Horner steps "
                         "beyond the kernel's int8/int32 datapath")
    return plan, conv, _plan_struct(plan, conv)


def _plan_struct(plan: ChannelPlan, conv: ConversionPlan) -> _FusedPlan:
    if plan.k > 11 or plan.num_rungs > _MAXR or conv.nlimbs > _MAXL:
        raise ValueError(f"plan (C={plan.k}, R={plan.num_rungs}, "
                         f"L={conv.nlimbs}) exceeds the kernel's tables")
    st = _FusedPlan()
    st.C, st.R, st.n_sub, st.L = plan.k, plan.num_rungs, plan.n_sub, \
        conv.nlimbs
    for j, m in enumerate(plan.moduli):
        st.mods[j] = m
        for r, (s, c) in enumerate(plan.rungs[j]):
            st.sched_s[j][r] = s
            st.sched_c[j][r] = c
        for i in range(plan.k):
            st.inv[j][i] = conv.inv_rows[j][i]
    for l, v in enumerate(mw.to_limbs_const(conv.M, conv.nlimbs)):
        st.M_limbs[l] = v
    for l, v in enumerate(mw.to_limbs_const(conv.half, conv.nlimbs)):
        st.half_limbs[l] = v
    return st


@functools.lru_cache(maxsize=16)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_k(M: int, K: int, N: int, sms: int) -> tuple[int, int]:
    """(splits, k_per_split) for a launch: split the K loop across blocks
    only when the output tiles alone would leave SMs idle (decode shapes),
    aiming at two blocks per SM and at least two K steps per block."""
    tiles = -(-N // _TN) * -(-M // _TM)
    ktiles = -(-K // _TK)
    splits = 1
    if tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles),
                            ktiles // _MIN_KTILES_PER_SPLIT))
    k_per_split = -(-ktiles // splits) * _TK
    return -(-K // k_per_split), k_per_split


def rns_fused_matmul(x: torch.Tensor, w, basis=None, *,
                     scale_row: torch.Tensor,
                     scale_col: torch.Tensor) -> torch.Tensor:
    """One-launch Stage ②–⑤ pipeline: (M, K) float × weight → (M, N) f32.

    ``x`` holds the float32/bfloat16 activations; the kernel rounds/clips
    them by ``scale_row`` (M, 1) itself.  ``w`` is an encoded
    :class:`RNSTensor`, its raw (C, K, N) residue stack (then ``basis`` is
    required), or a raw (K, N) int8 weight converted per tile.  The dequant
    is ``(y·s_row)·s_col`` with ``scale_col`` (1, N).  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel.
    """
    if isinstance(w, RNSTensor):
        if w.residues.ndim != 3:
            raise ValueError("rns_fused_matmul needs an unbatched (C, K, N) "
                             f"encoded weight, got {tuple(w.residues.shape)}")
        if basis is not None and tuple(basis.moduli) != w.moduli:
            raise ValueError(f"basis {basis.moduli} does not match encoded "
                             f"weight channels {w.moduli}")
        basis, w = w.basis, w.residues
    if x.ndim != 2 or w.ndim not in (2, 3):
        raise ValueError(f"need x (M, K) and w (K, N) or (C, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.int8:
        raise ValueError(f"weights must be int8 (residues), got {w.dtype}")
    M, K = x.shape
    N = w.shape[-1]
    if w.shape[-2] != K or K == 0:
        raise ValueError(f"contraction mismatch: x K={K}, w K={w.shape[-2]}")
    if basis is None:
        if w.ndim == 3:
            raise ValueError("raw (C, K, N) residues need an explicit basis")
        basis = basis_for_int8_matmul(K)
    plan, conv, st = _kernel_plan(basis, K)
    if w.ndim == 3 and w.shape[0] != plan.k:
        raise ValueError(f"residue stack has {w.shape[0]} channels, basis "
                         f"has {plan.k}")
    srow = scale_row.to(torch.float32).reshape(M, 1)
    scol = scale_col.to(torch.float32).reshape(1, N)
    if x.device.type == "cpu":
        return rns_fused_matmul_ref(x, w, basis, scale_row=srow,
                                    scale_col=scol)
    if x.device.type != "cuda":
        raise ValueError(f"rns_fused_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    for name, t in (("w", w), ("scale_row", srow), ("scale_col", scol)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    x, w = x.contiguous(), w.contiguous()
    srow, scol = srow.contiguous(), scol.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    splits, kps = _split_k(M, K, N, _num_sms(x.device.index or 0))
    ws_ptr = counters_ptr = None         # read by the kernel only if split
    if splits > 1:
        n_acc = plan.k * M * N
        ws = torch.zeros(n_acc + -(-N // _TN) * -(-M // _TM),
                         dtype=torch.int32, device=x.device)
        ws_ptr, counters_ptr = ws.data_ptr(), ws[n_acc:].data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.library().rns_fused_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), srow.data_ptr(),
        w.data_ptr(), int(w.ndim == 3), scol.data_ptr(), out.data_ptr(),
        ws_ptr, counters_ptr, M, K, N, splits, kps,
        int(N % 4 == 0 and w.data_ptr() % 4 == 0), ctypes.byref(st), stream)
    _build.check(rc, "rns_fused_matmul")
    rns_fused_matmul.launches += 1
    return out


rns_fused_matmul.launches = 0
