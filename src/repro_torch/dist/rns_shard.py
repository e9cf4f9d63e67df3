"""Channel layout of a sharded fused launch: port of the collective-free
part of `repro/dist/rns_shard.py`.

Each of n shards holds a C/n slice of the residue stacks and runs
`kernels.rns_fused.rns_fused_crt_partial` on it: Stage ②–④ and the CRT
partial sum Σ_j |r_j·v_j|_{m_j}·(M/m_j) over its own channels, as
``(L1, M, N)`` int32 15-bit limb planes.  The sum of the shards' planes
(what one all-reduce computes) goes through `crt_finish`, which recovers
the exact canonical value mod M and replays the fused kernel's signed
float tail bit for bit.

``crt_tables`` gives the per-channel CRT constants, ``local_plan`` the
plan every shard's launch is shaped by.  ``channel_partials`` makes the n
slice launches of one linear and ``channel_sliced_matmul`` composes them in
one process; the sharded launch and the collective wait for the
`torch.distributed` layer.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import multiword as mw
from repro_torch.core.channel_plan import ChannelPlan, residue_dtype_for
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.rns import _modinv
from repro_torch.core.rns_tensor import RNSTensor
from repro_torch.kernels.ref import rns_fused_crt_partial_ref
from repro_torch.kernels.rns_fused import rns_fused_crt_partial

__all__ = ["crt_tables", "local_plan", "crt_finish", "channel_partials",
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


def channel_partials(x, w: RNSTensor, nshards: int, *,
                     scale_row: torch.Tensor | None = None,
                     gate: torch.Tensor | None = None,
                     plain: bool = False) -> list[torch.Tensor]:
    """The n channel-slice launches of one fused linear, shard i taking
    channels ``[i·C/n, (i+1)·C/n)``: a list of n ``(L1, M, N)`` int32 limb
    planes, which sum to what the all-reduce computes.

    ``x`` is a float (M, K) block, quantized in the prologue by
    ``scale_row``, or an `RNSTensor` of activation residues (optionally
    gated by a raw int8 (M, K) ``gate``); ``w`` is the encoded weight.
    ``plain=True`` runs each launch's plain version instead of
    `rns_fused_crt_partial`, to hold the kernel against it.
    """
    residue_in = isinstance(x, RNSTensor)
    moduli = w.basis.moduli
    C = len(moduli)
    plan_g = ChannelPlan.for_matmul(moduli, w.residues.shape[-2],
                                    signed=not residue_in)
    lp = local_plan(plan_g, nshards)
    v, mc, _ = crt_tables(w.basis)
    srow = None if residue_in else scale_row.to(torch.float32).reshape(-1, 1)
    Cl = C // nshards
    parts = []
    for i in range(nshards):
        sl = slice(i * Cl, (i + 1) * Cl)
        xs = x.residues[sl] if residue_in else x
        kw = dict(plan=lp, mods=plan_g.mods[sl], sched=plan_g.sched[sl],
                  crt_v=v[sl], crt_mc=mc[sl], scale_row=srow, gate=gate)
        parts.append(
            rns_fused_crt_partial_ref(xs, w.residues[sl], **kw) if plain
            else rns_fused_crt_partial(xs, w.residues[sl],
                                       quantize=not residue_in, **kw))
    return parts


def channel_sliced_matmul(x, w: RNSTensor, nshards: int, *,
                          scale_row: torch.Tensor, scale_col: torch.Tensor,
                          gate: torch.Tensor | None = None) -> torch.Tensor:
    """One fused linear over n channel slices in one process: the slices'
    planes summed, `crt_finish`, then ``(y·s_row)·s_col``.  Bit-equal to
    `kernels.rns_fused_matmul` on the full basis with the same operands."""
    parts = channel_partials(x, w, nshards, scale_row=scale_row, gate=gate)
    val = crt_finish(sum(parts[1:], parts[0]),
                     ConversionPlan.for_basis(w.basis), len(w.basis.moduli))
    return (val * scale_row.reshape(-1, 1)) * scale_col.reshape(1, -1)
