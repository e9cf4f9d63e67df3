"""The RNS linear layer, port of `repro/core/rns_linear.py` (forward only).

``rns_dense(x, w)`` computes ``x @ w`` with the integer core in the paper's
residue channels, in one launch of the fused kernel: per-row activation
quantization (the scale on the host side, the round/clip in the kernel),
the exact int8 product through the ``basis_for_int8_matmul(K)`` channels,
MRC reverse and the ``(y·s_x)·s_w`` dequant.  ``w`` is an encoded
:class:`RNSTensor` (the serving path: the weight's quantize + forward
conversion ran once at encode time) or a raw float (K, N) weight quantized
per call — the two give bit-identical outputs.

The straight-through backward of the reference is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rns_fused import rns_fused_matmul

from .quant import quant_scale, quantize_int8
from .rns import basis_for_int8_matmul
from .rns_tensor import RNSTensor

__all__ = ["rns_dense"]


def rns_dense(x: torch.Tensor, w) -> torch.Tensor:
    """(M, K) float activations × weight → (M, N) in x's dtype."""
    sx = quant_scale(x, dim=-1)                       # per row
    if isinstance(w, RNSTensor):
        y = rns_fused_matmul(x, w, scale_row=sx, scale_col=w.scale)
    else:
        wq, sw = quantize_int8(w, dim=0)              # per column
        y = rns_fused_matmul(x, wq, basis_for_int8_matmul(x.shape[-1]),
                             scale_row=sx, scale_col=sw)
    return y.to(x.dtype)
