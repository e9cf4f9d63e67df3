"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with plain tensor
ops, so it runs on the CPU and on the card.  The wrappers take these only
for tensors that lie on the CPU; the tests and `chip_smoke.py` hold each
kernel against its plain version bit for bit.

Channel products run in float64 and are cast back to int32: every partial
sum is an integer below K·128·46 (signed operands) or K·46² (canonical
residues), far below 2^53, so the float64 product is exact on any device
and in any summation order.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import QMAX, quantize_int8, requant_const

__all__ = ["rns_forward_ref", "rns_fused_matmul_ref", "rns_matmul_ref",
           "rns_modmul_ref", "rns_reverse_ref", "rns_fused_chain_ref"]


def rns_forward_ref(x: torch.Tensor, moduli: Sequence[int],
                    dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(…,) int → (C, …) floored residues ``|x|_{m_c}`` in ``dtype``."""
    mods = torch.tensor([int(m) for m in moduli], dtype=torch.int32,
                        device=x.device).reshape((-1,) + (1,) * x.ndim)
    return torch.remainder(x.to(torch.int32)[None], mods).to(dtype)


def _channel_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def rns_fused_matmul_ref(x: torch.Tensor, w: torch.Tensor, basis, *,
                         scale_row: torch.Tensor, scale_col: torch.Tensor,
                         gate: torch.Tensor | None = None,
                         creq: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the fused kernel.

    ``x`` is (M, K) float (quantize prologue: round/clip by ``scale_row``,
    signed fold plan) or the (C, M, K) canonical int8 residues of an
    activation (residue-in: unsigned fold plan), whose channels are
    multiplied by ``|gate|_m`` when a raw int8 (M, K) ``gate`` is given.
    ``w`` is (C, K, N) canonical residues or (K, N) raw int8.  With
    ``creq`` (0-d) the epilogue requantizes in the domain and returns the
    (C, M, N) int8 residues of clip(round(y·s_col / creq), ±127); otherwise
    it returns (M, N) float32 ``(y·s_row)·s_col``.
    """
    moduli = tuple(int(m) for m in basis.moduli)
    K = x.shape[-1]
    residue_in = x.ndim == 3
    plan = ChannelPlan.for_matmul(moduli, K, signed=not residue_in)
    conv = ConversionPlan.for_basis(basis)
    w_res = w if w.ndim == 3 else rns_forward_ref(w, moduli)
    if not residue_in:
        q = torch.clamp(torch.round(x.to(torch.float32) / scale_row),
                        -QMAX, QMAX)
    res = []
    for c, m in enumerate(moduli):
        if residue_in:
            a = x[c].to(torch.int32)
            if gate is not None:
                a = torch.remainder(
                    torch.remainder(gate.to(torch.int32), m) * a, m)
        else:
            a = q
        res.append(plan.fold(_channel_dot(a, w_res[c]), c))
    val = conv.reverse_plain(torch.stack(res))
    if creq is not None:
        q = torch.clamp(torch.round((val * scale_col) / creq), -QMAX, QMAX)
        return rns_forward_ref(q.to(torch.int32), moduli, torch.int8)
    return (val * scale_row) * scale_col


def rns_matmul_ref(a_res: torch.Tensor, b_res: torch.Tensor,
                   moduli: Sequence[int], *, signed_a: bool = False,
                   plan: ChannelPlan | None = None) -> torch.Tensor:
    """(C or 1, M, K) × (C, K, N) → (C, M, N) int32 canonical residues of the
    per-channel products, folded once by ``plan`` (default
    ``for_matmul(moduli, K, signed=signed_a)``).  A one-plane ``a_res`` is
    the raw signed int8 activation shared by every channel."""
    mods = tuple(int(m) for m in moduli)
    plan = plan or ChannelPlan.for_matmul(mods, a_res.shape[-1],
                                          signed=signed_a)
    return torch.stack([
        plan.fold(_channel_dot(a_res[c if a_res.shape[0] > 1 else 0],
                               b_res[c]), c)
        for c in range(len(mods))])


def rns_modmul_ref(a_res: torch.Tensor, b_res: torch.Tensor,
                   moduli: Sequence[int]) -> torch.Tensor:
    """|a·b|_{m_c} elementwise over (C, …) residues: one int32 product and
    the ``ChannelPlan.for_product`` fold ladder → int32."""
    plan = ChannelPlan.for_product(tuple(int(m) for m in moduli))
    p = a_res.to(torch.int32) * b_res.to(torch.int32)
    return torch.stack([plan.apply_ladder(p[c], c) for c in range(plan.k)])


def rns_reverse_ref(residues: torch.Tensor, plan: ConversionPlan,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C, …) canonical residues → (…) float32 signed values (times
    ``scale``): `ConversionPlan.reverse_plain`."""
    return plan.reverse_plain(residues.to(torch.int32), scale)


def rns_fused_chain_ref(x: torch.Tensor, w_gate, w_up, w_down, basis,
                        act: Callable[[torch.Tensor], torch.Tensor]):
    """The residue-resident GLU MLP written as the UNCHAINED per-linear
    composition (port of `repro/kernels/ref.rns_fused_chain_ref`): each
    linear quantizes, forward-converts, multiplies canonical residues and
    leaves through the MRC reverse, and the up projection's exit applies the
    same `requant_const` round/clip as the chained ``emit="residues"``
    epilogue.  ``x`` is the float (M, K) input; the weights are
    :class:`RNSTensor`s in ``basis`` (the chain basis)."""
    moduli = tuple(int(m) for m in basis.moduli)
    conv = ConversionPlan.for_basis(basis)
    K, F = x.shape[-1], w_up.residues.shape[-1]
    plan_k = ChannelPlan.for_matmul(moduli, K, signed=False)
    plan_f = ChannelPlan.for_matmul(moduli, F, signed=False)

    def linear(a_res, wt, plan):
        return conv.reverse_plain(
            rns_matmul_ref(a_res, wt.residues, moduli, plan=plan))

    xq, sx = quantize_int8(x, dim=-1)
    x_res = rns_forward_ref(xq, moduli, torch.int8)
    y_gate = (linear(x_res, w_gate, plan_k) * sx) * w_gate.scale
    gq, sg = quantize_int8(act(y_gate), dim=-1)
    creq = requant_const(w_up.scale, K)
    t = linear(x_res, w_up, plan_k) * w_up.scale
    q_up = torch.clamp(torch.round(t / creq), -QMAX, QMAX)
    s_up = sx * creq
    u_res = rns_forward_ref(q_up.to(torch.int32), moduli, torch.int8)
    g_res = rns_forward_ref(gq, moduli, torch.int8)
    a_res = rns_modmul_ref(u_res, g_res, moduli).to(torch.int8)
    return (linear(a_res, w_down, plan_f) * (s_up * sg)) * w_down.scale
