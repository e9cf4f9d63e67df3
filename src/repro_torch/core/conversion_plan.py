"""ConversionPlan: the RNS conversion boundary, port of
`repro/core/conversion_plan.py`.

For one basis the plan holds the dense (k, k) MRC inverse table, the
dynamic range ``M``, the signed split ``half = ⌈M/2⌉`` and the limb count
covering M.  These tables are what the fused CUDA epilogue receives.

`forward` is THE forward converter (binary → canonical residues) and
`ConversionPlan.reverse` THE MRC reverse converter; on a CUDA tensor they
launch the `kernels/rns_convert` kernels `rns_forward` / `rns_reverse`, on a
CPU tensor they run those kernels' plain versions.
`ConversionPlan.reverse_plain` is the plain torch MRC reverse itself.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import multiword as mw
from .channel_plan import residue_dtype_for

__all__ = ["ConversionPlan", "forward"]


def forward(x: torch.Tensor, moduli: Sequence[int],
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """(…,) int → (C, …) canonical residues ``|x|_{m_c}`` (floored mod, so
    negative inputs map to the coset representative).  ``dtype`` defaults to
    the residue dtype rule (int8 when every residue fits)."""
    # deferred: the kernel modules import this one
    from repro_torch.kernels.rns_convert import rns_forward

    mods = tuple(int(m) for m in moduli)
    return rns_forward(x, mods, dtype=dtype or residue_dtype_for(mods))


@dataclasses.dataclass(frozen=True)
class ConversionPlan:
    """Frozen, hashable conversion plan for one RNS basis."""

    moduli: Tuple[int, ...]
    M: int
    inv_rows: Tuple[Tuple[int, ...], ...]     # dense (k, k) MRC inverses
    nlimbs: int

    @classmethod
    def for_basis(cls, basis) -> "ConversionPlan":
        return _build_plan(basis)

    @property
    def k(self) -> int:
        return len(self.moduli)

    @property
    def half(self) -> int:
        """Values >= ⌈M/2⌉ decode as negative."""
        return (self.M + 1) // 2

    @property
    def device_reversible(self) -> bool:
        """True iff every modulus admits the int32 limb-Horner step."""
        return max(self.moduli) <= mw.MAX_HORNER_MODULUS

    @functools.cached_property
    def inv(self) -> np.ndarray:
        return np.asarray(self.inv_rows, dtype=np.int32)

    @property
    def residue_dtype(self) -> torch.dtype:
        return residue_dtype_for(self.moduli)

    def reverse(self, residues: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
        """(k, …) canonical residues → signed value as float32, times
        ``scale`` (broadcast against the output) when given."""
        # deferred: the kernel modules import this one
        from repro_torch.kernels.rns_convert import rns_reverse

        return rns_reverse(residues, self, scale=scale)

    def reverse_plain(self, residues: torch.Tensor,
                      scale: torch.Tensor | None = None) -> torch.Tensor:
        """`reverse` in plain torch with the reference's op order: MRC
        digits (floored mod on a possibly negative product), limb Horner,
        signed fix, f32 Horner, then the optional scale multiply."""
        if not self.device_reversible:
            raise ValueError(
                f"moduli {self.moduli} exceed the int32 limb-Horner bound "
                f"m <= {mw.MAX_HORNER_MODULUS}")
        digits = []
        for j in range(self.k):
            t = residues[j].to(torch.int32)
            mj = self.moduli[j]
            for i in range(j):
                # d_i < m_i may exceed m_j, so t can stay negative after one
                # +m_j: the FLOORED remainder canonicalizes it.
                t = t - digits[i]
                t = torch.where(t < 0, t + mj, t)
                t = torch.remainder(t * self.inv_rows[j][i], mj)
            digits.append(t)
        acc = mw.limbs_from_scalar(digits[-1], self.nlimbs)
        for j in range(self.k - 2, -1, -1):
            acc = mw.limbs_horner(acc, self.moduli[j], digits[j])
        is_neg = mw.limbs_ge_const(acc, self.half)
        pos = mw.limbs_to_float(acc)
        neg = mw.limbs_to_float(mw.limbs_const_minus(self.M, acc))
        out = torch.where(is_neg, -neg, pos)
        return out if scale is None else out * scale


@functools.lru_cache(maxsize=256)
def _build_plan(basis) -> ConversionPlan:
    return ConversionPlan(moduli=tuple(int(m) for m in basis.moduli),
                          M=basis.M, inv_rows=basis.mrc_inverses,
                          nlimbs=mw.nlimbs_for(basis.M))
