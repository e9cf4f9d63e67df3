"""RNSTensor: a quantized weight held as canonical residues, port of
`repro/core/rns_tensor.py`.

``residues`` has the channel axis at −3 — a plain weight is ``(C, K, N)``, a
per-layer stacked weight ``(n_blocks, C, K, N)`` — so indexing a stacked
tensor by layer gives a contiguous ``(C, K, N)`` weight.  ``scale`` is the
per-column dequant scale ``(…, 1, N)``.  `encode`/`encode_params` run the
weight's quantize + forward conversion ONCE; the linear layer then consumes
the residues directly (`core/rns_linear.rns_dense`).

An *activation* RNSTensor (`encode_activation`, or a fused launch with
``emit="residues"``) holds ``(C, M, K)`` residues quantized per row, with
the ``(M, 1)`` row scale: the operand of a residue-resident chain
(`core/rns_linear.rns_chain_linear`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .channel_plan import residue_dtype_for
from .conversion_plan import ConversionPlan
from .conversion_plan import forward as _forward_convert
from .quant import quantize_int8
from .rns import RNSBasis, basis_for_int8_matmul

__all__ = ["RNSTensor", "RNSShard", "cat_columns", "encode",
           "encode_activation", "encode_params", "ENCODED_LINEAR_LEAVES"]


@dataclasses.dataclass(frozen=True, eq=False)
class RNSTensor:
    """Canonical residues ``(*B, C, K, N)`` of int8 weights quantized to
    ±127, and their dequant scale ``(*B, 1, N)`` (None for raw int8 from
    `from_int8`).  ``bound`` is the largest |q| the residues encode: 127
    for `quantize_int8`'s output, 128 for any int8 (−128 included)."""

    residues: torch.Tensor
    scale: Optional[torch.Tensor]
    basis: RNSBasis
    bound: int = 127

    @property
    def moduli(self) -> Tuple[int, ...]:
        return tuple(int(m) for m in self.basis.moduli)

    @property
    def k(self) -> int:
        """The channel count C."""
        return len(self.basis.moduli)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The logical shape: the residues' without the channel axis."""
        shp = tuple(self.residues.shape)
        return shp[:-3] + shp[-2:]

    @property
    def residue_dtype(self) -> torch.dtype:
        return self.residues.dtype

    def __getitem__(self, i: int) -> "RNSTensor":
        """Layer ``i`` of a stacked tensor (a view, no copy)."""
        if self.residues.ndim < 4:
            raise IndexError("only stacked (n_blocks, C, K, N) tensors index")
        return dataclasses.replace(
            self, residues=self.residues[i],
            scale=None if self.scale is None else self.scale[i])

    def dequant(self) -> torch.Tensor:
        """The MRC reverse (`ConversionPlan.reverse`: the `rns_reverse`
        kernel on a CUDA tensor) times the scale when there is one: float32
        ``(*B, K, N)``.  Not on any served path."""
        q = ConversionPlan.for_basis(self.basis).reverse(
            self.residues.movedim(-3, 0))
        return q if self.scale is None else q * self.scale

    @classmethod
    def from_int8(cls, q: torch.Tensor, scale: Optional[torch.Tensor] = None,
                  basis: RNSBasis | None = None) -> "RNSTensor":
        """Encode an int8 tensor ``(…, K, N)`` given from outside: the
        forward conversion alone, into ``basis`` (default
        `basis_for_int8_matmul(K)`), ``bound`` 128 since any int8 may come
        (−128 included)."""
        basis = basis or basis_for_int8_matmul(q.shape[-2])
        res = _forward_convert(q, basis.moduli,
                               residue_dtype_for(basis.moduli))
        return cls(residues=res.movedim(0, -3).contiguous(), scale=scale,
                   basis=basis, bound=128)


@dataclasses.dataclass(frozen=True, eq=False)
class RNSShard(RNSTensor):
    """Shard ``index`` of ``nshards`` of an encoded weight.

    ``layout="channel"``: ``residues`` hold channels ``[index·C/n,
    (index+1)·C/n)`` of every column.  ``layout="column"``: every channel
    of some columns; ``cols`` maps them, each ``(global_start,
    local_start, width)`` a run of ``width`` global columns from
    ``global_start`` held at ``local_start`` (a stacked QKV weight holds
    one run a projection).  ``scale`` is the full ``(…, 1, N)`` column
    scale either way, ``n_global`` the full column count N."""

    layout: str = "channel"
    index: int = 0
    nshards: int = 1
    n_global: int = 0
    cols: Tuple[Tuple[int, int, int], ...] = ()

    @property
    def shape(self) -> Tuple[int, ...]:
        """The logical shape of the whole weight."""
        shp = tuple(self.residues.shape)
        return shp[:-3] + (shp[-2], self.n_global)


def cat_columns(ws) -> RNSTensor:
    """Weights in one basis side by side along the output columns (the
    stacked QKV launch): one :class:`RNSTensor`, or one :class:`RNSShard`
    when every weight is a shard of one placement."""
    ws = list(ws)
    res = torch.cat([w.residues for w in ws], -1)
    scale = torch.cat([w.scale for w in ws], -1)
    if not any(isinstance(w, RNSShard) for w in ws):
        return RNSTensor(residues=res, scale=scale, basis=ws[0].basis)
    first = ws[0]
    if not all(isinstance(w, RNSShard) and (w.layout, w.index, w.nshards)
               == (first.layout, first.index, first.nshards) for w in ws):
        raise ValueError("cat_columns needs every weight placed alike")
    cols, g0, l0 = [], 0, 0
    for w in ws:
        cols += [(g + g0, lo + l0, n) for g, lo, n in w.cols]
        g0 += w.n_global
        l0 += w.residues.shape[-1]
    return dataclasses.replace(first, residues=res, scale=scale,
                               n_global=g0, cols=tuple(cols))


def encode(w: torch.Tensor, basis: RNSBasis | None = None) -> RNSTensor:
    """Quantize (per column, over K) + forward-convert a float weight
    ``(…, K, N)`` once.  Residues come out in ``(…, C, K, N)`` layout."""
    if w.ndim < 2:
        raise ValueError(f"encode expects (..., K, N) weights, got "
                         f"{tuple(w.shape)}")
    basis = basis or basis_for_int8_matmul(w.shape[-2])
    wq, sw = quantize_int8(w, dim=-2)
    res = _forward_convert(wq, basis.moduli)            # (C, …, K, N)
    return RNSTensor(residues=res.movedim(0, -3).contiguous(), scale=sw,
                     basis=basis)


def encode_activation(x: torch.Tensor, basis: RNSBasis) -> RNSTensor:
    """Quantize (per row, over K) + forward-convert a float activation
    ``(M, K)`` once: the entry of a residue-resident chain, its one
    standalone forward conversion.  ``basis`` is the chain's, shared by
    every launch of the chain."""
    if x.ndim != 2:
        raise ValueError(f"encode_activation expects (M, K) activations, "
                         f"got {tuple(x.shape)}")
    xq, sx = quantize_int8(x, dim=-1)
    return RNSTensor(residues=_forward_convert(xq, basis.moduli), scale=sx,
                     basis=basis)


# Which weight leaves the linear datapath consumes, keyed by parent dict.
ENCODED_LINEAR_LEAVES: Dict[str, Tuple[str, ...]] = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
    "shared": ("w_gate", "w_up", "w_down"),       # MoE shared expert
}


def encode_params(params: Dict[str, Any], basis: RNSBasis | None = None, *,
                  group_basis: Dict[str, RNSBasis] | None = None
                  ) -> Dict[str, Any]:
    """Replace exactly the linear weight leaves (`ENCODED_LINEAR_LEAVES`) of
    a nested parameter dict with :class:`RNSTensor`s; stacked leaves encode
    per block.  Already-encoded leaves pass through.  ``group_basis``
    overrides the basis per parent group (``{"mlp":
    basis_for_chain(d_ff)}`` for a residue-resident MLP)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            leaves = ENCODED_LINEAR_LEAVES.get(k)
            if leaves is not None and isinstance(v, dict):
                b = (group_basis or {}).get(k, basis)
                out[k] = {kk: (encode(vv, b)
                               if kk in leaves and isinstance(vv, torch.Tensor)
                               else walk(vv))
                          for kk, vv in v.items()}
            else:
                out[k] = walk(v)
        return out

    return walk(params)
