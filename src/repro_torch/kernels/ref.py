"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with plain tensor
ops, so it runs on the CPU and on the card.  The wrappers take these only
for tensors that lie on the CPU; the tests and `chip_smoke.py` hold each
kernel against its plain version bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import QMAX

__all__ = ["rns_forward_ref", "rns_fused_matmul_ref"]


def rns_forward_ref(x: torch.Tensor, moduli: Sequence[int],
                    dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(…,) int → (C, …) floored residues ``|x|_{m_c}`` in ``dtype``."""
    mods = torch.tensor([int(m) for m in moduli], dtype=torch.int32,
                        device=x.device).reshape((-1,) + (1,) * x.ndim)
    return torch.remainder(x.to(torch.int32)[None], mods).to(dtype)


def rns_fused_matmul_ref(x: torch.Tensor, w: torch.Tensor, basis, *,
                         scale_row: torch.Tensor,
                         scale_col: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel (quantize + float-emit variant).

    ``x`` (M, K) float, ``w`` (C, K, N) canonical residues or (K, N) raw
    int8, ``scale_row`` (M, 1), ``scale_col`` (1, N) → (M, N) float32.
    The channel products run in float64 and are cast back: every partial
    sum is an integer of magnitude <= K·128·46, far below 2^53, so the
    float64 product is exact on any device and in any summation order.
    """
    moduli = tuple(int(m) for m in basis.moduli)
    K = x.shape[-1]
    plan = ChannelPlan.for_matmul(moduli, K, signed=True)
    conv = ConversionPlan.for_basis(basis)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale_row),
                    -QMAX, QMAX).to(torch.float64)
    w_res = w if w.ndim == 3 else rns_forward_ref(w, moduli)
    res = []
    for c in range(plan.k):
        acc = (q @ w_res[c].to(torch.float64)).to(torch.int32)
        res.append(plan.fold(acc, c))
    val = conv.reverse(torch.stack(res))
    return (val * scale_row) * scale_col
