"""Sharded fused launches, port of `repro/dist/rns_shard.py`.

Two partitionings of ONE launch over the "model" axis of the active
`dist.context.DistContext`, one process a rank:

channel (split C) — each rank holds a C/n slice of the residue stacks and
  runs `kernels.rns_fused.rns_fused_crt_partial` on it: Stage ②–④ and the
  CRT partial sum Σ_j |r_j·v_j|_{m_j}·(M/m_j) over its own channels, as
  ``(L1, M, N)`` int32 15-bit limb planes.  ONE all-reduce (SUM) of those
  planes, then `crt_finish`, which recovers the exact canonical value mod
  M and replays the fused kernel's signed float tail bit for bit, and the
  epilogue's ``(y·s_row)·s_col`` in its order.  Residues never cross:
  what crosses is the reduced value.  ``emit="residues"`` launches
  replicate (re-encoding needs every modulus).

column (split N) — every rank keeps the full basis and runs
  `rns_fused_matmul` on its N/n weight columns (bit-equal per column under
  any tiling), then gathers them along the last axis: each rank writes its
  columns into a zeroed full-width buffer, floats as their int32 bits, and
  one all-reduce (SUM) assembles it, every column having one non-zero
  contributor (``x + 0`` is bitwise on int32, where a float −0.0 would not
  survive).  The reference built its gather so for an XLA bug; here it is
  the collective ``gloo`` takes for CUDA tensors (it has no CUDA
  all-gather).  ``emit="residues"`` gathers the (C, M, N) slab, its
  requantize constant taken from the full column scale.

`sharded_fused_matmul` resolves each launch as the reference does:
``auto`` by `comms.choose_layout`, a forced layout falling back preferred
→ other → replicate, a channel-layout ``emit="residues"`` launch
replicating, and with no context (or one shard) it is `rns_fused_matmul`.
`rank_launch` is its launch on this rank in two steps, the rank's kernel
and then the collective with the epilogue, so that each can be timed.
A weight placed by `dist.engine.place_params` (an `RNSShard`) carries the
layout it was resolved to.  The reference's ``_isolate``, an XLA fusion
fence, has no counterpart: eager torch runs each op as written.

``crt_tables`` gives the per-channel CRT constants, ``local_plan`` the
plan every shard's launch is shaped by; ``channel_partials`` makes the n
slice launches of one linear and ``channel_sliced_matmul`` composes them
in one process (no collective).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import multiword as mw
from repro_torch.core.channel_plan import ChannelPlan, residue_dtype_for
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import requant_const
from repro_torch.core.rns import _modinv, basis_for_int8_matmul
from repro_torch.core.rns_tensor import RNSShard, RNSTensor
from repro_torch.kernels.ref import float_epilogue, rns_fused_crt_partial_ref
from repro_torch.kernels.rns_fused import (resolve_epilogue,
                                           rns_fused_crt_partial,
                                           rns_fused_matmul)

from . import comms
from .context import current

__all__ = ["sharded_fused_matmul", "rank_launch", "RankLaunch",
           "resolve_layout", "crt_tables",
           "local_plan", "crt_finish", "channel_partials",
           "channel_sliced_matmul"]


@functools.lru_cache(maxsize=64)
def _crt_tables_cached(moduli):
    M = 1
    for m in moduli:
        M *= m
    nlimbs = mw.nlimbs_for(len(moduli) * M)
    v = np.asarray([_modinv(M // m, m) for m in moduli], np.int32)
    mc = np.asarray([mw.to_limbs_const(M // m, nlimbs) for m in moduli],
                    np.int32)
    return v, mc, nlimbs


def crt_tables(basis):
    """Per-channel CRT constants of a basis: ``(v, mc, L1)``.

    ``v[j] = |(M/m_j)^{-1}|_{m_j}`` (C,) int32, the CRT reconstruction
    inverses, and ``mc[j] = limbs(M/m_j)`` (C, L1) int32 with
    ``L1 = nlimbs_for(C·M)``: the limb count of the un-reduced CRT sum
    Σ α_j·M_j < C·M, which is what the shards' planes add up to.
    """
    return _crt_tables_cached(tuple(int(m) for m in basis.moduli))


def local_plan(plan_g: ChannelPlan, nshards: int) -> ChannelPlan:
    """The plan every shard's launch is shaped by: shard 0's channel slice
    (C/n channels) with the global bound, rung count and ``n_sub`` (extra
    conditional subtracts are no-ops on channels that need fewer).  Each
    shard's own moduli and rung rows travel beside it.  Raises when n does
    not divide C, or when slices would select different residue dtypes."""
    C = plan_g.k
    if C % nshards:
        raise ValueError(f"mesh 'model' size {nshards} does not divide the "
                         f"channel count C={C}; channel sharding needs "
                         "C % model == 0")
    Cl = C // nshards
    gdt = residue_dtype_for(plan_g.moduli)
    for i in range(nshards):
        sl = plan_g.moduli[i * Cl:(i + 1) * Cl]
        if residue_dtype_for(sl) != gdt:
            raise ValueError(
                f"channel slice {sl} selects residue dtype "
                f"{residue_dtype_for(sl)}, global basis selects {gdt}; the "
                "SPMD kernel must cast every shard identically")
    return dataclasses.replace(plan_g, moduli=plan_g.moduli[:Cl],
                               channels=plan_g.channels[:Cl],
                               rungs=plan_g.rungs[:Cl])


@functools.lru_cache(maxsize=256)
def _slice_launch(moduli: tuple, K: int, signed: bool, nshards: int,
                  index: int):
    """(local plan, the slice's mods / sched / CRT rows, the channel
    slice) of shard ``index``'s launch."""
    plan_g = ChannelPlan.for_matmul(moduli, K, signed=signed)
    v, mc, _ = _crt_tables_cached(moduli)
    Cl = len(moduli) // nshards
    sl = slice(index * Cl, (index + 1) * Cl)
    return (local_plan(plan_g, nshards), plan_g.mods[sl], plan_g.sched[sl],
            v[sl], mc[sl], sl)


def crt_finish(total: torch.Tensor, conv_g: ConversionPlan,
               C: int) -> torch.Tensor:
    """Summed ``(L1, M, N)`` limb planes → the fused kernel's float32 value.

    The summed CRT value Σ α_j·M_j is < C·M, so at most C−1 conditional
    subtracts of M reach the canonical v; summed limbs are < n·2^15 and are
    carried back to 15-bit form first.  The truncated limbs then equal the
    fused kernel's MRC accumulator (both are the limbs of the same v < M),
    and the signed tail replays its float ops.  The caller multiplies by
    ``s_row``, then ``s_col``, as the fused kernel's epilogue does.
    """
    ls = mw._carry_propagate([total[i] for i in range(total.shape[0])])
    for _ in range(C - 1):
        ge = mw.limbs_ge_const(ls, conv_g.M)
        ls = mw.limbs_select(ge, mw.limbs_sub_const(ls, conv_g.M), ls)
    ls = ls[:conv_g.nlimbs]
    is_neg = mw.limbs_ge_const(ls, conv_g.half)
    pos = mw.limbs_to_float(ls)
    neg = mw.limbs_to_float(mw.limbs_const_minus(conv_g.M, ls))
    return torch.where(is_neg, -neg, pos)


def _basis_of(x, w, basis):
    """The launch's basis: the encoded weight's, the activation's, the one
    given, or `basis_for_int8_matmul(K)` for raw operands."""
    if isinstance(w, RNSTensor):
        return w.basis
    if isinstance(x, RNSTensor):
        return x.basis
    return basis if basis is not None else basis_for_int8_matmul(
        x.shape[-1])


def channel_partials(x, w, nshards: int, *, basis=None,
                     scale_row: torch.Tensor | None = None,
                     gate: torch.Tensor | None = None,
                     plain: bool = False) -> list[torch.Tensor]:
    """The n channel-slice launches of one fused linear, shard i taking
    channels ``[i·C/n, (i+1)·C/n)``: a list of n ``(L1, M, N)`` int32 limb
    planes, which sum to what the all-reduce computes.

    ``x`` is a float (M, K) block, quantized in the prologue by
    ``scale_row``, a raw int8 (M, K) block, or an `RNSTensor` of activation
    residues (optionally gated by a raw int8 (M, K) ``gate``); ``w`` is the
    encoded weight or a raw (K, N) int8 weight (every slice converts it in
    its own moduli; ``basis`` defaults to `basis_for_int8_matmul(K)`).
    ``plain=True`` runs each launch's plain version instead of
    `rns_fused_crt_partial`, to hold the kernel against it.
    """
    residue_in = isinstance(x, RNSTensor)
    moduli = tuple(int(m) for m in _basis_of(x, w, basis).moduli)
    xr = x.residues if residue_in else x
    quantize = not residue_in and xr.dtype != torch.int8
    srow = scale_row.to(torch.float32).reshape(-1, 1) if quantize else None
    parts = []
    for i in range(nshards):
        lp, mods, sched, v, mc, sl = _slice_launch(
            moduli, xr.shape[-1], not residue_in, nshards, i)
        xs = xr[sl] if residue_in else xr
        ws = _channel_weight(w, sl)
        kw = dict(plan=lp, mods=mods, sched=sched, crt_v=v, crt_mc=mc,
                  scale_row=srow, gate=gate)
        parts.append(
            rns_fused_crt_partial_ref(xs, ws, **kw) if plain
            else rns_fused_crt_partial(xs, ws, quantize=quantize, **kw))
    return parts


def channel_sliced_matmul(x, w, nshards: int, *, basis=None,
                          scale_row: torch.Tensor | None = None,
                          scale_col: torch.Tensor | None = None,
                          scale: torch.Tensor | None = None,
                          gate: torch.Tensor | None = None) -> torch.Tensor:
    """One fused linear over n channel slices in one process: the slices'
    planes summed, `crt_finish`, then the float epilogue in the fused
    kernel's order (``scale`` lowered as `rns_fused_matmul` lowers it).
    Bit-equal to `kernels.rns_fused_matmul` on the full basis with the same
    operands."""
    basis = _basis_of(x, w, basis)
    M = (x.residues if isinstance(x, RNSTensor) else x).shape[-2]
    _, srow, scol, sc = resolve_epilogue(x, M, w.shape[-1],
                                         scale_row=scale_row,
                                         scale_col=scale_col, scale=scale)
    parts = channel_partials(x, w, nshards, basis=basis, scale_row=scale_row,
                             gate=gate)
    val = crt_finish(sum(parts[1:], parts[0]),
                     ConversionPlan.for_basis(basis), len(basis.moduli))
    return float_epilogue(val, srow, scol, sc)


# ------------------------------------------------------- the collectives --
class RankLaunch(NamedTuple):
    """One launch of `sharded_fused_matmul` on this rank, in two steps:
    ``kernel()`` runs this rank's kernel and returns its output (the
    channel slice's limb planes, the column slice's output, or the whole
    launch's when it replicates); ``finish(out)`` runs the collective on
    that output, which it may overwrite, and the epilogue, and returns the
    launch's result."""

    layout: str
    kernel: Callable[[], Any]
    finish: Callable[[Any], Any]


def _channel_weight(w, sl):
    """This rank's weight operand: a placed channel shard's residues, the
    channel slice of a full encoded weight, or a raw (K, N) int8 weight as
    it is (the kernel converts it against the slice's moduli)."""
    if isinstance(w, RNSShard):
        return w.residues
    if isinstance(w, RNSTensor):
        return w.residues[sl]
    return w[sl] if w.ndim == 3 else w


def _channel_launch(ctx, x, w, basis, *, srow, scol, sc, gate):
    moduli = tuple(int(m) for m in basis.moduli)
    residue_in = isinstance(x, RNSTensor)
    xr = x.residues if residue_in else x
    quantize = not residue_in and xr.dtype != torch.int8
    lp, mods, sched, v, mc, sl = _slice_launch(
        moduli, xr.shape[-1], not residue_in, ctx.nshards, ctx.rank)
    xs = xr[sl] if residue_in else xr
    ws = _channel_weight(w, sl)

    def kernel():
        return rns_fused_crt_partial(
            xs, ws, plan=lp, mods=mods, sched=sched, crt_v=v, crt_mc=mc,
            quantize=quantize, scale_row=srow if quantize else None,
            gate=gate)

    def finish(part):
        total = comms.all_reduce(part, ctx.group)
        # the kernel epilogue's pinned dequant order: ((y·s_row)·s_col)·s
        val = crt_finish(total, ConversionPlan.for_basis(basis), len(moduli))
        return float_epilogue(val, srow, scol, sc)

    return RankLaunch("channel", kernel, finish)


def _column_runs(w, N: int, ctx):
    """(this rank's weight columns, their runs ``(global_start,
    local_start, width)``)."""
    if isinstance(w, RNSShard):
        return w.residues, w.cols
    Nl = N // ctx.nshards
    g = ctx.rank * Nl
    res = w.residues if isinstance(w, RNSTensor) else w
    return res[..., g:g + Nl], ((g, 0, Nl),)


def _gather_columns(local: torch.Tensor, runs, N: int, group):
    """The full-width tensor of every rank's columns: each rank's runs
    scattered into zeros (floats as their int32 bits), summed by one
    all-reduce."""
    f32 = local.dtype == torch.float32
    plane = local.view(torch.int32) if f32 else local
    buf = plane.new_zeros(plane.shape[:-1] + (N,))
    for g, lo, n in runs:
        buf[..., g:g + n] = plane[..., lo:lo + n]
    comms.all_reduce(buf, group)
    return buf.view(torch.float32) if f32 else buf


def _local_columns(t, runs, N: int):
    """A scale's columns of this rank's runs: a 2-D view whose last axis is
    N is sliced, anything else (a row scale, a scalar, None) passes."""
    if t is None:
        return None
    t2 = t.reshape((1,) * (2 - t.ndim) + tuple(t.shape)) if t.ndim < 2 \
        else t
    if t2.shape[-1] != N:
        return t
    return torch.cat([t2[:, g:g + n] for g, _, n in runs], -1)


def _column_launch(ctx, x, w, basis, *, N, quantize, scale_row, scale_col,
                   scale, gate, emit):
    w_loc, runs = _column_runs(w, N, ctx)
    w_loc = w_loc.contiguous()
    scol = (None if scale_col is None else
            scale_col.to(torch.float32).reshape(1, N))
    creq = None
    if emit == "residues":
        # the requantize constant of the FULL column scale: a slice-local
        # max would differ by rank
        K = (x.residues if isinstance(x, RNSTensor) else x).shape[-1]
        creq = requant_const(scol, K)
    # the rank's launch lowers its own slice of the scale as the full
    # launch would, so each column gets the same multiplies
    sc_loc = None if scale is None else _local_columns(
        torch.as_tensor(scale, dtype=torch.float32,
                        device=w_loc.device), runs, N)

    def kernel():
        return rns_fused_matmul(x, w_loc, basis, quantize=quantize,
                                scale_row=scale_row,
                                scale_col=_local_columns(scol, runs, N),
                                scale=sc_loc, gate=gate, emit=emit,
                                requant_creq=creq)

    def finish(out):
        if emit == "residues":
            return RNSTensor(residues=_gather_columns(out.residues, runs, N,
                                                      ctx.group),
                             scale=out.scale, basis=basis)
        return _gather_columns(out, runs, N, ctx.group)

    return RankLaunch("column", kernel, finish)


# ---------------------------------------------------------------- dispatch --
def resolve_layout(layout: str, *, C: int, N: int, nlimbs: int, ndev: int,
                   emit: str = "float", itemsize: int = 1, M: int = 1,
                   parts=None) -> str:
    """The layout one launch runs in: "channel", "column" or "replicate".

    ``layout`` "auto" asks `comms.choose_layout` (whose choice does not
    depend on M: both costs scale with M·N); a forced layout falls back
    preferred → other → replicate when the axis size does not divide C
    (resp. N, or one of ``parts``, the widths of weights side by side);
    a channel ``emit="residues"`` launch replicates."""
    parts = (N,) if parts is None else tuple(parts)
    cols_ok = all(p % ndev == 0 for p in parts)
    chan_ok = C % ndev == 0
    lay = layout
    if lay == "auto":
        lay = comms.choose_layout(C=C, M=M, N=N, nlimbs=nlimbs, ndev=ndev,
                                  emit=emit, itemsize=itemsize)
    if lay not in ("channel", "column", "replicate"):
        raise ValueError(f"unknown layout {lay!r}")
    if lay == "channel" and not chan_ok:
        lay = "column" if cols_ok else "replicate"
    elif lay == "column" and not cols_ok:
        lay = "channel" if chan_ok else "replicate"
    if lay == "channel" and emit == "residues":
        lay = "replicate"
    return lay


def rank_launch(x, w, basis=None, *, quantize: bool | None = None,
                gate: torch.Tensor | None = None, emit: str = "float",
                scale_row: torch.Tensor | None = None,
                scale_col: torch.Tensor | None = None,
                scale: torch.Tensor | None = None, ctx=None,
                layout: str | None = None) -> RankLaunch:
    """This rank's part of `sharded_fused_matmul`'s launch, its arguments
    resolved as it resolves them, as a :class:`RankLaunch`: what the
    sharded engine runs, split so that the kernel and the collective can
    be timed apart.  ``ctx`` must be a context of more than one shard."""
    ctx = ctx if ctx is not None else current()
    basis = _basis_of(x, w, basis)
    moduli = tuple(int(m) for m in basis.moduli)
    xr = x.residues if isinstance(x, RNSTensor) else x
    M = xr.shape[-2]
    N = w.shape[-1]
    if isinstance(w, RNSShard):
        if (w.nshards, w.index) != (ctx.nshards, ctx.rank):
            raise ValueError(f"weight shard {w.index} of {w.nshards} under a "
                             f"context of rank {ctx.rank} of {ctx.nshards}")
        lay = w.layout
        if lay == "channel" and emit == "residues":
            raise ValueError("an emit='residues' launch replicates under the "
                             "channel layout: its weight must be whole")
    else:
        lay = resolve_layout(
            layout or ctx.layout, C=len(moduli), M=M, N=N,
            nlimbs=crt_tables(basis)[2], ndev=ctx.nshards, emit=emit,
            itemsize=residue_dtype_for(moduli).itemsize)
    kw = dict(quantize=quantize, gate=gate, emit=emit, scale_row=scale_row,
              scale_col=scale_col, scale=scale)
    if lay == "replicate":
        return RankLaunch("replicate", functools.partial(
            rns_fused_matmul, x, w, basis, **kw), lambda out: out)
    if lay == "column":
        return _column_launch(ctx, x, w, basis, N=N, **kw)
    # the channel layout runs the epilogue after the collective; its
    # operands are checked and lowered as the full launch checks them
    _, srow, scol, sc = resolve_epilogue(x, M, N, quantize=quantize,
                                         scale_row=scale_row,
                                         scale_col=scale_col, scale=scale)
    return _channel_launch(ctx, x, w, basis, srow=srow, scol=scol, sc=sc,
                           gate=gate)


def sharded_fused_matmul(x, w, basis=None, *, ctx=None,
                         layout: str | None = None,
                         quantize: bool | None = None,
                         gate: torch.Tensor | None = None,
                         emit: str = "float",
                         scale_row: torch.Tensor | None = None,
                         scale_col: torch.Tensor | None = None,
                         scale: torch.Tensor | None = None):
    """Distribution-aware twin of `kernels.rns_fused.rns_fused_matmul`:
    its arguments and its bits, run as ONE launch split over
    ``ctx.axis`` (default: the active `dist.context.current()`).

    ``layout`` (default: the context's) is resolved per launch by
    `resolve_layout`; a placed `RNSShard` weight runs in the layout it was
    placed for.  Raw int8 x and the ``scale=`` forms run in both layouts:
    a channel rank runs the raw-int8 `rns_fused_crt_partial` and applies
    the scale after the collective in the kernel's order, a column rank
    the raw-int8 `rns_fused_matmul` on its columns with a scale's N axis
    sliced by them.  With no context or a one-shard axis this IS
    `rns_fused_matmul` (a shard then raises: it is not the whole weight).
    """
    ctx = ctx if ctx is not None else current()
    kw = dict(quantize=quantize, gate=gate, emit=emit, scale_row=scale_row,
              scale_col=scale_col, scale=scale)
    if ctx is None or ctx.nshards <= 1:
        if isinstance(w, RNSShard):
            raise ValueError("a placed weight shard runs only under the "
                             "DistContext it was placed for")
        return rns_fused_matmul(x, w, basis, **kw)
    launch = rank_launch(x, w, basis, ctx=ctx, layout=layout, **kw)
    return launch.finish(launch.kernel())
