"""Interval abstract interpretation over a traced call — overflow proofs on
the ops a call runs, port of `repro/analysis/absint.py`.

The config-level checker (`analysis.bounds`) proves the pipeline *as
designed*; this pass proves it *as run*: a ``TorchDispatchMode`` follows
every aten op of an eager call, propagating exact integer intervals
(`analysis.intervals`) from the inputs through the ops the port's integer
paths emit — ring ops, ``mm``/``bmm`` (an einsum's contraction; depth read
off the operand shapes), floored ``remainder``, shifts, masks, ``clamp``,
``where``, reductions, casts and the structural ops (views, ``cat``,
``index``) — and flags every integer-dtype result whose derived range
escapes its dtype.  A narrowing cast that can wrap is an error naming the
dtype.

An input takes its dtype's range or a given interval.  A tensor that
derives from no input is a constant (a moduli table, a rung schedule, a
literal): its interval is read from its values, as the reference reads
literals, so the proof covers the real channel set of the call.  A write
into a view widens its base, and a tensor whose storage was written since
its interval was derived falls back to its base's.

Soundness discipline: an op with no rule is ⊤ and everything derived from
it is *unproven*, warned about once; the pass never silently assumes a
range.  A kernel region (`kernels._build.kernel_region`) is not entered:
its outputs are ⊤, with one warning, and the in-kernel bound story is the
config-level checker's job.

Entry points: :func:`check_fn_bounds` runs a callable on example args and
checks it; :func:`interpret` takes explicit input intervals.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import _build

from .findings import Report
from .intervals import TOP, Interval, dtype_range
from .residency import RegionMode, decomposed, tensors

__all__ = ["check_fn_bounds", "interpret", "AbsintResult"]


@dataclasses.dataclass
class AbsintResult:
    report: Report
    out_intervals: List[Interval]
    unproven: int                 # integer results that left the domain


def _hull(lo: float, hi: float) -> Interval:
    """The integer interval holding the real range [lo, hi]."""
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return TOP
    return Interval(math.floor(lo), math.ceil(hi))


def _value_interval(t: torch.Tensor) -> Interval:
    """Interval of a constant tensor from its values."""
    if t.device.type == "meta" or t.numel() == 0 or t.is_complex():
        return TOP
    if t.dtype == torch.bool:
        return Interval(0, 1)
    lo, hi = torch.aminmax(t.detach().reshape(-1))
    return _hull(float(lo), float(hi))


def _scalar_interval(v) -> Interval:
    if isinstance(v, bool):
        return Interval.point(int(v))
    if isinstance(v, int):
        return Interval.point(v)
    if isinstance(v, float):
        return _hull(v, v)
    return TOP


def _union(ivs: Sequence[Interval]) -> Interval:
    out = ivs[0]
    for iv in ivs[1:]:
        out = out.union(iv)
    return out


def _numel(shape, dims) -> int:
    if dims is None or dims == []:
        return math.prod(shape)
    dims = [dims] if isinstance(dims, int) else dims
    return math.prod(shape[d] for d in dims)


def _clip(x: Interval, lo: Optional[int], hi: Optional[int]) -> Interval:
    """The range of clamp(x, lo, hi); a missing or unknown bound clips
    nothing on its side."""
    if x.is_top:
        return TOP if lo is None or hi is None else Interval(lo, hi)
    xlo, xhi = x.lo, x.hi
    if lo is not None:
        xlo, xhi = max(xlo, lo), max(xhi, lo)
    if hi is not None:
        xlo, xhi = min(xlo, hi), min(xhi, hi)
    return Interval(xlo, xhi)


def _written(func, args, kwargs) -> Optional[torch.Tensor]:
    """The tensor an op writes in place (``add_``, ``copy_``, ``out=``), by
    its schema, or None."""
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            t = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            if isinstance(t, torch.Tensor):
                return t
    return None


# ops whose outputs hold (a subset of) the values of their first argument
_STRUCTURAL = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "unsqueeze", "squeeze", "slice", "select", "alias",
    "clone", "contiguous", "as_strided", "detach", "flatten", "unflatten",
    "narrow", "diagonal", "repeat", "unbind", "split", "split_with_sizes",
    "chunk", "index", "index_select", "gather", "flip", "roll", "lift_fresh",
    "movedim", "amax", "amin", "_to_copy", "round", "floor", "ceil",
    "trunc"))
_BOOLEAN = frozenset((
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "isfinite", "isnan", "isinf", "signbit",
    "any", "all"))


class _AbsintMode(RegionMode):
    def __init__(self, report: Report):
        super().__init__()
        self.report = report
        self.unproven = 0
        self._warned: set = set()
        # tensor -> (interval, its storage's write count when derived)
        self.env = WeakIdKeyDictionary()
        self.writes: dict = {}            # storage -> in-place writes

    # ------------------------------------------------------------ state --
    def _writes(self, t: torch.Tensor) -> int:
        return self.writes.get(t.untyped_storage()._cdata, 0)

    def write(self, t: torch.Tensor, iv: Interval) -> None:
        self.env[t] = (iv, self._writes(t))

    def derived(self, t: torch.Tensor) -> bool:
        return t in self.env or (t._base is not None and t._base in self.env)

    def _fresh(self, t) -> Optional[Interval]:
        if t in self.env:
            iv, n = self.env[t]
            if n == self._writes(t):
                return iv
        return None

    def read(self, a) -> Interval:
        if not isinstance(a, torch.Tensor):
            return _scalar_interval(a)
        iv = self._fresh(a)
        if iv is not None:
            return iv
        base = a._base
        if base is not None and base in self.env:
            iv = self._fresh(base)
            return TOP if iv is None else iv
        if a in self.env:                   # written since, no base known
            return TOP
        return _value_interval(a)

    def _warn_once(self, key: str, msg: str) -> None:
        if key not in self._warned:
            self._warned.add(key)
            self.report.add("absint", key, msg, severity="warning")

    def _check_dtype(self, name: str, t: torch.Tensor,
                     iv: Interval) -> Interval:
        rng = dtype_range(t.dtype)
        if rng is None:
            return iv
        if iv.is_top:
            self.unproven += 1
            return iv
        if iv.lo < rng.lo or iv.hi > rng.hi:
            dt = str(t.dtype).removeprefix("torch.")
            self.report.add("absint", f"'{name}'",
                            f"possible {dt} overflow: derived range {iv} "
                            f"escapes {rng}")
            return rng                # the machine wraps: the dtype's range
        return iv

    # ---------------------------------------------------- kernel regions --
    def exit(self, name, out):
        self._warn_once("kernel region", "kernel bodies are proven by the "
                        "config-level bound pass, not entered here")
        for t in tensors(out):
            self.write(t, self._check_dtype(name, t, TOP))


    # -------------------------------------------------------------- ops --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = decomposed(self, func, args, kwargs)
        if out is not NotImplemented:
            return out
        if _build.region_depth() or not any(
                self.derived(t) for t in tensors((args, kwargs))):
            return func(*args, **kwargs)       # a kernel body, or constants
        name = func.overloadpacket.__name__
        mutated = _written(func, args, kwargs)
        base = mutated._base if mutated is not None else None
        prev_base = self.read(base) if base is not None else None
        iv = self.rule(func, name, args, kwargs)
        out = func(*args, **kwargs)
        if mutated is not None:               # every alias read before is stale
            key = mutated.untyped_storage()._cdata
            self.writes[key] = self.writes.get(key, 0) + 1
        outs = list(tensors(out))
        ivs = iv if isinstance(iv, list) else [iv] * len(outs)
        for t, v in zip(outs, ivs):
            self.write(t, self._check_dtype(name, t, v))
        if base is not None:
            self.write(base, prev_base.union(self.read(mutated)))
        return out

    def rule(self, func, name: str, args, kwargs):
        """The interval of ``func``'s outputs (one for all, or a list)."""
        ins = [self.read(a) for a in args]
        ovl = func._overloadname
        if name in ("add", "add_", "sub", "sub_", "rsub"):
            b = ins[1] * _scalar_interval(kwargs.get("alpha", 1))
            if name == "rsub":
                return b - ins[0]
            return ins[0] + b if name.startswith("add") else ins[0] - b
        if name in ("mul", "mul_"):
            return ins[0] * ins[1]
        if name in ("neg", "neg_"):
            return -ins[0]
        if name in ("abs", "abs_"):
            return ins[0].abs()
        if name in ("sign", "sgn"):
            return Interval(-1, 1)
        if name in ("maximum", "minimum", "fmax", "fmin") or (
                name in ("max", "min") and ovl == "other"):
            a, b = ins[0], ins[1]
            if a.is_top or b.is_top:
                return TOP
            pick = max if name in ("maximum", "fmax", "max") else min
            return Interval(pick(a.lo, b.lo), pick(a.hi, b.hi))
        if name in ("max", "min") and ovl == "dim":
            n = args[0].shape[args[1]] if args[0].ndim else 1
            return [ins[0], Interval(0, max(n - 1, 0))]
        if name in ("max", "min"):                  # over every element
            return ins[0]
        if name in ("argmax", "argmin"):
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            n = args[0].numel() if dim is None else args[0].shape[dim]
            return Interval(0, max(n - 1, 0))
        if name in ("remainder", "remainder_"):      # floored
            n, d = ins[0], ins[1]
            if d.is_top or d.lo <= 0:
                return TOP
            if not n.is_top and n.lo >= 0:
                if n.hi < d.lo:
                    return n                         # already canonical
                return Interval(0, min(d.hi - 1, n.hi))
            return Interval(0, d.hi - 1)
        if name in ("fmod", "fmod_"):                # truncated
            n, d = ins[0], ins[1]
            if d.is_top or d.lo <= 0:
                return TOP
            hi = d.hi - 1
            if not n.is_top and n.lo >= 0:
                return Interval(0, min(hi, n.hi))
            return Interval(-hi, hi)
        if name in ("mm", "bmm", "dot", "mv", "vdot"):
            return ins[0].dot(ins[1], args[0].shape[-1])
        if name in ("addmm", "baddbmm", "addmv"):
            beta = _scalar_interval(kwargs.get("beta", 1))
            alpha = _scalar_interval(kwargs.get("alpha", 1))
            return ins[0] * beta + ins[1].dot(ins[2], args[1].shape[-1]) \
                * alpha
        if name in ("sum", "nansum"):
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            return ins[0] * Interval.point(_numel(args[0].shape, dims))
        if name in ("cumsum", "cumsum_"):
            n = args[0].shape[args[1]] if args[0].ndim else 1
            return ins[0] if ins[0].is_top else \
                ins[0] * Interval(1, max(n, 1))
        if name in ("clamp", "clamp_", "clamp_min", "clamp_min_",
                    "clamp_max", "clamp_max_"):
            def bound(i, key):
                v = args[i] if len(args) > i else kwargs.get(key)
                return None if v is None else self.read(v)
            if name.startswith("clamp_min"):
                lo, hi = bound(1, "min"), None
            elif name.startswith("clamp_max"):
                lo, hi = None, bound(1, "max")
            else:
                lo, hi = bound(1, "min"), bound(2, "max")
            return _clip(ins[0], None if lo is None else lo.lo,
                         None if hi is None else hi.hi)
        if name == "where":
            return ins[1].union(ins[2])
        if name in ("masked_fill", "masked_fill_"):
            return ins[0].union(ins[2])
        if name in ("index_put", "index_put_"):
            if len(args) > 3 and args[3]:
                return TOP                           # accumulate
            return ins[0].union(ins[2])
        if name in ("scatter", "scatter_"):
            src = ins[3] if len(args) > 3 else self.read(kwargs.get("value"))
            return ins[0].union(src)
        if name in ("copy_",):
            return ins[1]
        if name in ("fill_", "fill"):
            return ins[1]
        if name in ("zero_", "zeros_like"):
            return Interval.point(0)
        if name == "ones_like":
            return Interval.point(1)
        if name == "full_like":
            return ins[1]
        if name in ("cat", "stack", "hstack", "vstack"):
            return _union([self.read(t) for t in args[0]])
        if name == "constant_pad_nd":
            value = args[2] if len(args) > 2 else kwargs.get("value", 0)
            return ins[0].union(_scalar_interval(value))
        if name in ("bitwise_right_shift", "__rshift__", "__irshift__",
                    "bitwise_right_shift_"):
            s = ins[1]
            if s.is_top or s.lo != s.hi or s.lo < 0:
                return TOP
            return ins[0].rshift(s.lo)
        if name in ("bitwise_left_shift", "__lshift__", "__ilshift__",
                    "bitwise_left_shift_"):
            s = ins[1]
            if s.is_top or s.lo != s.hi or s.lo < 0:
                return TOP
            return ins[0] * Interval.point(1 << s.lo)
        if name in ("bitwise_and", "bitwise_and_", "__and__", "__iand__"):
            nonneg = [iv.hi for iv in ins[:2]
                      if not iv.is_top and iv.lo >= 0]
            return Interval(0, min(nonneg)) if nonneg else TOP
        if name in ("bitwise_or", "bitwise_xor", "bitwise_or_",
                    "bitwise_xor_", "__or__", "__xor__"):
            a, b = ins[0], ins[1]
            if a.is_top or b.is_top or a.lo < 0 or b.lo < 0:
                return TOP
            return Interval(0, (1 << max(a.hi, b.hi).bit_length()) - 1)
        if name in _BOOLEAN:
            return Interval(0, 1)
        if name in _STRUCTURAL:
            return ins[0]
        self._warn_once(name, f"no interval rule for op '{name}' — its "
                        f"outputs are unproven")
        return TOP


def interpret(fn, *example_args, in_intervals: Sequence[Interval],
              subject: str = "fn") -> AbsintResult:
    """Run ``fn`` on example args with the given intervals of their
    tensors (in `residency.tensors` order) and check every op."""
    rep = Report(subject=f"absint:{subject}")
    mode = _AbsintMode(rep)
    ins = list(tensors(example_args))
    if len(in_intervals) != len(ins):
        raise ValueError(f"{len(in_intervals)} intervals for {len(ins)} "
                         "input tensors")
    for t, iv in zip(ins, in_intervals):
        mode.write(t, iv)
    with mode:
        out = fn(*example_args)
    outs = [mode.read(t) for t in tensors(out)]
    return AbsintResult(report=rep, out_intervals=outs,
                        unproven=mode.unproven)


def check_fn_bounds(fn, *example_args,
                    bounds: Optional[Sequence[Optional[Tuple[int, int]]]]
                    = None, subject: str = "fn") -> AbsintResult:
    """Run ``fn`` on example args and interval-check every op.

    ``bounds`` gives (lo, hi) per input tensor (in `residency.tensors`
    order); ``None`` entries (and a ``None`` bounds) default to the
    tensor's dtype range for integer tensors — int8 operands start at
    [−128, 127], exactly the external-operand contract — and ⊤ for floats.
    """
    ivs: List[Any] = []
    for i, t in enumerate(tensors(example_args)):
        b = bounds[i] if bounds is not None and i < len(bounds) else None
        if b is not None:
            ivs.append(Interval(int(b[0]), int(b[1])))
        else:
            rng = dtype_range(t.dtype)
            ivs.append(rng if rng is not None else TOP)
    return interpret(fn, *example_args, in_intervals=ivs, subject=subject)
