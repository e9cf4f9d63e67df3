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
from .rns_tensor import RNSShard, RNSTensor, encode

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


def rows_as(y, x):
    """A mesh run's (M, N) linear output (or (M, K) input gradient) with
    its rows sharded as the (M, K) input's and its columns as they came
    (else whole), so that the view back to (..., N) splits the rows as the
    input's were.  DTensor
    may leave the rows sharded over a second mesh dim (a row factor
    reduce-scattered there), which a view to (B, S, N) cannot undo
    evenly.  A plain tensor passes through."""
    pl = getattr(y, "placements", None)
    if pl is None:
        return y
    from torch.distributed.tensor import Replicate, Shard

    def shard(p, d):
        return isinstance(p, Shard) and p.dim == d

    new = [Shard(0) if shard(a, 0) else b if shard(b, 1) else Replicate()
           for a, b in zip(x.placements, pl)]
    return y if new == list(pl) else y.redistribute(y.device_mesh, new)


def reconstruct_mrc(residues: torch.Tensor, basis: RNSBasis, *,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C, …) canonical residues → signed value as float32, times ``scale``
    when given: `ConversionPlan.reverse` of ``basis`` (the `rns_reverse`
    kernel on a CUDA tensor)."""
    return ConversionPlan.for_basis(basis).reverse(residues, scale=scale)


def rns_int_matmul(xq: torch.Tensor, wq, basis: RNSBasis | None = None,
                   broadcast: bool = True, *, backend: str = "auto",
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """Exact (M, K) int8 × (K, N) int8 product through residue channels, as
    float32 (M, N), times ``scale`` (broadcast against (M, N)) when given.

    ``wq`` is a raw (K, N) int8 weight, converted per call, or an encoded
    :class:`RNSTensor` whose (C, K, N) residues feed the product as they
    are; ``basis`` defaults to the encoded weight's or to
    `basis_for_int8_matmul(K)`.  Three routes, as the reference's:

    - fused (``broadcast`` on "auto" or "pallas_fused"): one raw-int8
      `rns_fused_matmul` launch, the scale in its epilogue, or its sharded
      twin under an active distribution context;
    - staged broadcast (``broadcast`` on "pallas"): the broadcast channel
      matmul (the raw signed activations shared by every channel, only the
      weight forward-converted), then the MRC reverse with the scale;
    - per-channel (``broadcast=False`` on any backend, the paper-literal
      datapath): both operands forward-converted to canonical residues,
      the canonical channel matmul on the unsigned plan, the MRC reverse.

    All three give the same bits.  ``backend`` is one of `BACKENDS`; the
    reference's "jnp" and ``interpret`` have no counterpart.
    """
    fused = _fused(backend)
    if isinstance(wq, RNSTensor):
        if wq.residues.ndim != 3:
            raise ValueError("rns_int_matmul needs an unbatched (C, K, N) "
                             f"encoded weight, got {tuple(wq.residues.shape)}")
        if basis is not None and tuple(basis.moduli) != wq.moduli:
            raise ValueError(f"basis {basis.moduli} does not match encoded "
                             f"weight channels {wq.moduli}")
        if wq.bound > 128:
            raise ValueError(f"encoded weight bound {wq.bound} exceeds the "
                             "int8 operand range the basis is sized for")
        basis = wq.basis
    else:
        basis = basis or basis_for_int8_matmul(xq.shape[-1])
    moduli = tuple(int(m) for m in basis.moduli)
    if broadcast and fused:
        return _fused_matmul(xq, wq, basis, scale=scale)
    encoded = isinstance(wq, RNSTensor)
    if broadcast:
        res = cp.matmul_broadcast(xq, wq.residues if encoded else wq, moduli,
                                  encoded=encoded)
    else:
        plan = cp.ChannelPlan.for_matmul(moduli, xq.shape[-1])
        a_res = forward(xq, moduli, plan.residue_dtype)
        b_res = (wq.residues.to(plan.residue_dtype) if encoded
                 else forward(wq, moduli, plan.residue_dtype))
        res = cp.matmul(a_res, b_res, moduli, plan=plan)
    return ConversionPlan.for_basis(basis).reverse(res, scale=scale)


def _dense_forward(x: torch.Tensor, w, backend: str,
                   broadcast: bool = True) -> torch.Tensor:
    """The forward of `rns_dense` (no autograd)."""
    if not (broadcast and _fused(backend)):
        # the staged kernels: the broadcast or the per-channel datapath
        xq, sx = quantize_int8(x, dim=-1)                 # per row
        if isinstance(w, RNSTensor):
            y = rns_int_matmul(xq, w, broadcast=broadcast, backend="pallas")
            sw = w.scale
        else:
            wq, sw = quantize_int8(w, dim=0)              # per column
            y = rns_int_matmul(xq, wq, broadcast=broadcast, backend="pallas")
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
    def forward(ctx, x, w, backend, broadcast):
        ctx.save_for_backward(x, w)
        return _dense_forward(x, w, backend, broadcast)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy32 = gy.to(torch.float32)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = rows_as((gy32 @ w.to(torch.float32).T).to(x.dtype), x)
        if ctx.needs_input_grad[1]:
            gw = (x.to(torch.float32).T @ gy32).to(w.dtype)
        return gx, gw, None, None


class _EncodedSTE(torch.autograd.Function):
    """Encoded weight: the reference's `_rns_dense_enc` custom_vjp, the
    estimator's weight the dequantized ŵ; the residues and the scale get
    no gradient."""

    @staticmethod
    def forward(ctx, x, residues, scale, basis, backend, broadcast):
        ctx.basis, ctx.x_dtype = basis, x.dtype
        ctx.save_for_backward(residues, scale)
        return _dense_forward(x, RNSTensor(residues, scale, basis), backend,
                              broadcast)

    @staticmethod
    def backward(ctx, gy):
        residues, scale = ctx.saved_tensors
        w_hat = ConversionPlan.for_basis(ctx.basis).reverse(residues) * scale
        gx = (gy.to(torch.float32) @ w_hat.T).to(ctx.x_dtype)
        return gx, None, None, None, None, None


def rns_dense(x: torch.Tensor, w, backend: str = "auto", *,
              broadcast: bool = True) -> torch.Tensor:
    """(M, K) float activations × weight → (M, N) in x's dtype, with the
    straight-through backward.  ``broadcast=False`` takes the per-channel
    datapath of `rns_int_matmul` on the staged kernels, whatever the
    backend, as the reference does; the backward is the same."""
    if isinstance(w, RNSShard):
        if not broadcast:
            raise ValueError("a placed weight shard serves the fused "
                             "broadcast datapath only")
        return _dense_forward(x, w, backend)
    if isinstance(w, RNSTensor):
        if w.scale is None:
            raise ValueError("rns_dense needs a dequant scale on the encoded "
                             "weight; from_int8 tensors carry none")
        return _EncodedSTE.apply(x, w.residues, w.scale, w.basis, backend,
                                 broadcast)
    return _DenseSTE.apply(x, w, backend, broadcast)


def rns_chain_linear(x: RNSTensor, w: RNSTensor, *,
                     gate: torch.Tensor | None = None,
                     gate_scale: torch.Tensor | None = None,
                     scale_row: torch.Tensor | None = None,
                     emit: str = "float", backend: str = "auto"):
    """One launch of a residue-resident linear chain.

    ``x`` is an activation :class:`RNSTensor` ((C, M, K) residues and the
    (M, 1) row scale), ``w`` a weight RNSTensor in the same basis, or a
    raw float (K, N) weight encoded in it per call (`rns_tensor.encode`,
    the same bits as encoding it once).
    ``gate`` is a raw int8
    (M, K) factor applied per channel as |q_x·q_g|_m, its row scale
    ``gate_scale`` multiplying the row scale as ``x.scale·gate_scale``.
    ``scale_row`` replaces the activation's row scale (default
    ``x.scale``).  ``emit="float"`` returns (M, N) float32
    ``(y·s_row)·s_col``;
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
    if not isinstance(wt, RNSTensor):
        wt = encode(wt, basis)           # a raw float weight, per call
    if wt.moduli != x.moduli:
        raise ValueError("rns_chain_linear needs a weight RNSTensor in the "
                         f"chain basis {x.moduli}; encode the chain's "
                         "weights with group_basis / basis_for_chain")
    M, K = x.residues.shape[-2:]
    N = wt.residues.shape[-1]
    srow = (x.scale if scale_row is None else scale_row).to(
        torch.float32).reshape(M, 1)
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
