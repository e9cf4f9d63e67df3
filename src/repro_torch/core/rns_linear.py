"""The RNS linear layer, port of `repro/core/rns_linear.py`.

``rns_dense(x, w)`` computes ``x @ w`` with the integer core in the paper's
residue channels: per-row activation quantization, the exact int8 product
through the ``basis_for_int8_matmul(K)`` channels, MRC reverse and the
``(y·s_x)·s_w`` dequant.  ``w`` is an encoded :class:`RNSTensor` (the
weight's quantize + forward conversion ran once at encode time) or a raw
float (K, N) weight quantized per call — the two give bit-identical
outputs.  On ``backend="pallas_fused"`` (and "auto") the whole linear is one
launch of the fused kernel; on ``"pallas"`` it runs the staged kernels:
forward conversion of the weight, the broadcast channel matmul and the MRC
reverse, with the activation quantized and the dequant applied in torch.

``rns_chain_linear`` is one launch of a residue-resident chain: it consumes
an activation :class:`RNSTensor` and leaves the domain (float) or stays in
it (``emit="residues"``), with an optional fused modular gate — fused on
"pallas_fused", as the staged twin (forward, modmul, canonical matmul,
reverse) on "pallas"; the two are bit-identical.

While a `repro_torch.dist` context is active (a sharded Engine's prefill
and decode), every fused launch goes through
`dist.rns_shard.sharded_fused_matmul`, which splits it over the mesh with
the same bits; the staged backend and the backward stay unsharded.  A
placed weight shard (`RNSShard`) is serving-only: it takes the forward
alone, without the estimator.

``rns_dense`` is differentiable with the reference's straight-through
estimator (two `torch.autograd.Function`s, one a weight form): gradients
flow as if the layer were a dense float32 matmul, ``gx = gy @ w.T`` and
``gw = x.T @ gy``, cast back to the operands' dtypes.  For an encoded
weight the estimator's weight is the dequantized ŵ = reverse(residues)·s
(the `rns_reverse` kernel on a CUDA tensor), and neither the residues nor
the scale receive a gradient.  Each Function's forward is the forward
above, unchanged, so served outputs do not change; the kernel's output is
only ever made inside it.  ``rns_chain_linear`` is forward-only, as in the
reference: training runs residue-domain configs per linear.
"""
from __future__ import annotations

import torch

from . import channel_plan as cp
from .conversion_plan import ConversionPlan, forward
from .linear_spec import BACKENDS
from .quant import QMAX, quant_scale, quantize_int8, requant_const
from .rns import RNSBasis, basis_for_int8_matmul
from .rns_tensor import RNSShard, RNSTensor

__all__ = ["rns_dense", "rns_int_matmul", "rns_chain_linear",
           "reconstruct_mrc"]


def _fused(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return backend != "pallas"


def _fused_matmul(x, w, basis=None, **kw):
    """One fused launch: `rns_fused_matmul`, or under an active
    distribution context (or for a placed shard) its sharded twin."""
    # deferred: dist imports the kernels, which import the core package
    from repro_torch.dist import context
    if context.current() is not None or isinstance(w, RNSShard):
        from repro_torch.dist.rns_shard import sharded_fused_matmul
        return sharded_fused_matmul(x, w, basis, **kw)
    from repro_torch.kernels.rns_fused import rns_fused_matmul
    return rns_fused_matmul(x, w, basis, **kw)


def reconstruct_mrc(residues: torch.Tensor, basis: RNSBasis, *,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C, …) canonical residues → signed value as float32, times ``scale``
    when given: `ConversionPlan.reverse` of ``basis`` (the `rns_reverse`
    kernel on a CUDA tensor)."""
    return ConversionPlan.for_basis(basis).reverse(residues, scale=scale)


def rns_int_matmul(xq: torch.Tensor, wq) -> torch.Tensor:
    """Exact (M, K) int8 × (K, N) int8 product through residue channels on
    the staged kernels, as float32 (M, N): the broadcast channel matmul
    (weights forward-converted unless ``wq`` is an encoded
    :class:`RNSTensor`) and the MRC reverse."""
    if isinstance(wq, RNSTensor):
        basis, res = wq.basis, cp.matmul_broadcast(xq, wq.residues,
                                                   wq.moduli, encoded=True)
    else:
        basis = basis_for_int8_matmul(xq.shape[-1])
        res = cp.matmul_broadcast(xq, wq, basis.moduli)
    return ConversionPlan.for_basis(basis).reverse(res)


def _dense_forward(x: torch.Tensor, w, backend: str) -> torch.Tensor:
    """The forward of `rns_dense` (no autograd)."""
    if not _fused(backend):
        xq, sx = quantize_int8(x, dim=-1)                 # per row
        if isinstance(w, RNSTensor):
            y, sw = rns_int_matmul(xq, w), w.scale
        else:
            wq, sw = quantize_int8(w, dim=0)              # per column
            y = rns_int_matmul(xq, wq)
        return ((y * sx) * sw).to(x.dtype)
    sx = quant_scale(x, dim=-1)                           # per row
    if isinstance(w, RNSTensor):
        y = _fused_matmul(x, w, scale_row=sx, scale_col=w.scale)
    else:
        wq, sw = quantize_int8(w, dim=0)                  # per column
        y = _fused_matmul(x, wq, basis_for_int8_matmul(x.shape[-1]),
                          scale_row=sx, scale_col=sw)
    return y.to(x.dtype)


class _DenseSTE(torch.autograd.Function):
    """Live float weight: the reference's `_rns_dense` custom_vjp."""

    @staticmethod
    def forward(ctx, x, w, backend):
        ctx.save_for_backward(x, w)
        return _dense_forward(x, w, backend)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy32 = gy.to(torch.float32)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (gy32 @ w.to(torch.float32).T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.to(torch.float32).T @ gy32).to(w.dtype)
        return gx, gw, None


class _EncodedSTE(torch.autograd.Function):
    """Encoded weight: the reference's `_rns_dense_enc` custom_vjp, the
    estimator's weight the dequantized ŵ; the residues and the scale get
    no gradient."""

    @staticmethod
    def forward(ctx, x, residues, scale, basis, backend):
        ctx.basis, ctx.x_dtype = basis, x.dtype
        ctx.save_for_backward(residues, scale)
        return _dense_forward(x, RNSTensor(residues, scale, basis), backend)

    @staticmethod
    def backward(ctx, gy):
        residues, scale = ctx.saved_tensors
        w_hat = ConversionPlan.for_basis(ctx.basis).reverse(residues) * scale
        gx = (gy.to(torch.float32) @ w_hat.T).to(ctx.x_dtype)
        return gx, None, None, None, None


def rns_dense(x: torch.Tensor, w, backend: str = "auto", *,
              broadcast: bool = True) -> torch.Tensor:
    """(M, K) float activations × weight → (M, N) in x's dtype, with the
    straight-through backward."""
    if not broadcast:
        raise NotImplementedError("the per-channel (broadcast=False) "
                                  "datapath is not ported")
    if isinstance(w, RNSShard):
        return _dense_forward(x, w, backend)
    if isinstance(w, RNSTensor):
        return _EncodedSTE.apply(x, w.residues, w.scale, w.basis, backend)
    return _DenseSTE.apply(x, w, backend)


def rns_chain_linear(x: RNSTensor, w: RNSTensor, *, gate: torch.Tensor | None = None,
                     gate_scale: torch.Tensor | None = None,
                     emit: str = "float", backend: str = "auto"):
    """One launch of a residue-resident linear chain.

    ``x`` is an activation :class:`RNSTensor` ((C, M, K) residues and the
    (M, 1) row scale), ``w`` a weight RNSTensor in the same basis.
    ``gate`` is a raw int8
    (M, K) factor applied per channel as |q_x·q_g|_m, its row scale
    ``gate_scale`` multiplying the row scale as ``x.scale·gate_scale``.
    ``emit="float"`` returns (M, N) float32 ``(y·s_row)·s_col``;
    ``emit="residues"`` the requantized product as the next launch's
    activation RNSTensor.
    """
    if emit not in ("float", "residues"):
        raise ValueError(f"emit must be 'float' or 'residues', got {emit!r}")
    if not isinstance(x, RNSTensor) or x.residues.ndim != 3:
        raise ValueError("rns_chain_linear consumes an unbatched (C, M, K) "
                         "activation RNSTensor from encode_activation")
    if gate is not None and emit == "residues":
        raise ValueError("gate= with emit='residues' is unsupported: the "
                         "requantize bound is sized for K·127², not the "
                         "gated K·127³ product")
    if gate_scale is not None and gate is None:
        raise ValueError("gate_scale= without gate=")
    basis, wt = x.basis, w
    if not isinstance(wt, RNSTensor) or wt.moduli != x.moduli:
        raise ValueError("rns_chain_linear needs a weight RNSTensor in the "
                         f"chain basis {x.moduli}; encode the chain's "
                         "weights with group_basis / basis_for_chain")
    M, K = x.residues.shape[-2:]
    N = wt.residues.shape[-1]
    srow = x.scale.to(torch.float32).reshape(M, 1)
    if gate is not None:
        srow = srow * gate_scale.to(torch.float32).reshape(M, 1)
    if _fused(backend):
        return _fused_matmul(x, wt, gate=gate, emit=emit, scale_row=srow,
                             scale_col=wt.scale)

    # The staged twin: the same pipeline as standalone kernels.
    moduli = x.moduli
    plan = cp.ChannelPlan.for_matmul(moduli, K, signed=False)
    x_res = x.residues
    if gate is not None:
        g_res = forward(gate, moduli, plan.residue_dtype)
        x_res = cp.modmul(x_res, g_res, moduli, out_dtype=plan.residue_dtype)
    res = cp.matmul(x_res, wt.residues, moduli, plan=plan)
    val = ConversionPlan.for_basis(basis).reverse(res)
    scol = wt.scale.to(torch.float32).reshape(1, N)
    if emit == "residues":
        creq = requant_const(scol, K)
        q = torch.clamp(torch.round((val * scol) / creq), -QMAX, QMAX)
        return RNSTensor(residues=forward(q.to(torch.int32), moduli,
                                          plan.residue_dtype),
                         scale=srow * creq, basis=basis)
    return (val * srow) * scol
