"""Symmetric int8 quantization, port of `repro/core/quant.py`.

q = clip(round(x / s), ±127) with s = max|x| / 127.  The reference divides
by the constant 127, and it always runs that divide compiled, where XLA
lowers it to a multiply by float32(1/127); an eager divide differs from that
in about 4% of inputs by one ulp.  The port therefore multiplies by the
float32 reciprocal, which reproduces the compiled reference bit for bit.
The divide by the (non-constant) scale stays a true IEEE divide, as it is in
the reference and in the CUDA prologue.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["QMAX", "quant_scale", "quantize_int8", "dequantize",
           "requant_const", "requant_scale"]

# Symmetric clip point: ±127 (−128 is never emitted).
QMAX = 127.0
# float32(1/127), exactly representable in float32 and in a Python float.
_INV_QMAX = float(np.float32(1.0 / 127.0))


def quant_scale(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """THE scale rule: max(max|x|, 1e-8) · float32(1/127), keepdim, float32."""
    amax = torch.amax(torch.abs(x.to(torch.float32)), dim=dim, keepdim=True)
    return torch.clamp_min(amax, 1e-8) * _INV_QMAX


def quantize_int8(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 quantization along ``dim``: (q int8, scale float32)."""
    scale = quant_scale(x, dim)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q · scale in float32, cast to ``dtype``."""
    return (q.to(torch.float32) * scale).to(dtype)


def requant_const(scale_col: torch.Tensor, k: int) -> torch.Tensor:
    """c = max(s_w)·K·127, the row-independent factor of the in-domain
    requantize: a K-deep product of ±127 operands scaled by its column
    scale satisfies |t| <= c·127, so clip(round(t / c), ±127) saturates by
    bound, which a tile-local kernel epilogue can apply.  0-d float32."""
    return torch.amax(scale_col.to(torch.float32)) * (float(k) * QMAX)


def requant_scale(scale_row: torch.Tensor, scale_col: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Dequant scale s_row·c of an in-domain requantized activation."""
    return scale_row.to(torch.float32) * requant_const(scale_col, k)
