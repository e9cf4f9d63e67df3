"""The reference's kernel entry names (`repro/kernels/ops.py`) over the
port's wrappers.

Each takes ``moduli`` as any sequence of integers (numpy ints, a tuple, a
basis' moduli) and hands the wrapper a tuple of Python ints; `rns_reverse`
takes the moduli and builds their conversion plan, as the reference's
does; `flash_attention` takes the window as any integer and the softcap as
any real, as its static arguments.  The reference's ``interpret`` switch has no counterpart: a wrapper
runs its plain version on CPU tensors and its kernel on CUDA tensors.
"""
from __future__ import annotations

from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.rns import RNSBasis

from . import ref
from .flash_attention import flash_attention as _flash_attention
from .fold import fold as _fold
from .rns_convert import rns_forward as _rns_forward
from .rns_convert import rns_reverse as _rns_reverse
from .rns_fused import rns_fused_matmul
from .rns_matmul import rns_matmul as _rns_matmul
from .rns_modmul import rns_modmul as _rns_modmul

__all__ = ["rns_matmul", "rns_fused_matmul", "rns_modmul", "rns_forward",
           "rns_reverse", "fold", "flash_attention", "ref"]


def _ints(moduli) -> tuple:
    return tuple(int(m) for m in moduli)


def rns_matmul(a_res, b_res, moduli, **kw):
    return _rns_matmul(a_res, b_res, _ints(moduli), **kw)


def rns_forward(x, moduli, **kw):
    return _rns_forward(x, _ints(moduli), **kw)


def rns_reverse(residues, moduli, **kw):
    basis = RNSBasis(name="ops", moduli=_ints(moduli))
    return _rns_reverse(residues, ConversionPlan.for_basis(basis), **kw)


def rns_modmul(a_res, b_res, moduli, **kw):
    return _rns_modmul(a_res, b_res, _ints(moduli), **kw)


def fold(x, moduli, bound, **kw):
    return _fold(x, _ints(moduli), int(bound), **kw)


def flash_attention(q, k, v, *, window=None, softcap=None, **kw):
    return _flash_attention(q, k, v,
                            window=None if window is None else int(window),
                            softcap=None if softcap is None
                            else float(softcap), **kw)
