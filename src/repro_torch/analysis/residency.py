"""Residency pass — structural invariants of one traced call, port of
`repro/analysis/residency.py`.

The reference walks a closed jaxpr; here :class:`TraceMode`, a
``TorchDispatchMode``, records every aten op an eager call runs, and the
kernel wrappers' regions (`kernels._build.kernel_region`) stand for
``pallas_call``: an op inside a region is "inside" (on the CPU the plain
version's ops; on the card the ctypes launch is invisible to dispatch),
and each outermost region is a kernel call, recorded by wrapper name.
Autograd's backward, and the recompute of a checkpointed layer, run under
the same mode.  :func:`summarize_fn` returns a :class:`TraceSummary`; the
check_* helpers turn it into findings with the invariant named — "no
modular reduction outside a kernel", "exactly N kernel calls", "no host
sync in the step" (the precondition of capturing a step as a CUDA graph,
the port's stand-in for the reference's decode scan).

Collectives (`torch.distributed`'s ``c10d`` ops, which reach the
dispatcher) run outside a kernel are recorded by name and operands
(shape, dtype) in ``TraceSummary.collectives``: `check_reduced_wire`
holds a sharded step to the channel layout's wire contract, and
`dist.comms.collective_wire_bytes` prices what crossed.

The mode also counts what the dry run reads (`launch/dryrun.py`): the
float flops outside the regions by `torch.utils.flop_counter`'s formulas,
each kernel call's operations from its shapes (`kernel_ops`), and the peak
of live bytes of the storages the call makes, tracked by storage.

With ``dtensor=True`` (the mesh dry run) the mode steps aside for every op
on a DTensor (it returns NotImplemented, so DTensor dispatches the op and
its local ops reach the mode at local shapes: the counts are per device),
and leaves out the ops DTensor's sharding propagation runs at global
shapes to learn an output's shape (`_hook_propagation`).  The functional
collectives DTensor issues, those of a redistribution inside an op too,
are recorded in ``TraceSummary.wire`` as (op, output bytes, group size),
the group size read from the process group (`launch/roofline.
collective_bytes` prices them).

`expected_launches` and its helpers give the kernel calls a config's
dispatch implies for a generate, a decode step, a prefill and a train
step of the dense stack (the smollm family).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import Counter
from typing import Dict, Iterable, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

from .findings import Report

__all__ = [
    "TraceSummary", "TraceMode", "RegionMode", "summarize_fn", "check_resident",
    "check_kernel_count", "check_no_callbacks", "check_reduced_wire",
    "kernel_ops", "COLLECTIVES", "FUNCTIONAL",
    "expected_launches", "expected_step", "expected_prefill",
    "expected_train_step", "kernel_calls", "tensors", "MODULAR_OPS",
    "SYNC_OPS", "TO_HOST", "WRAPPERS", "COUNTED", "decomposed",
]

# Ops that perform a modular reduction: on a resident path every one of
# them must run inside a kernel region (any overload).
MODULAR_OPS = ("aten.remainder", "aten.fmod")
# Ops that read the device on the host: ``.item()``, a data-dependent
# shape, a Python bool of a comparison.  A copy from the card to the host
# is recorded as "copy to host".
SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.equal",
            "aten.unique_consecutive", "aten._unique2", "aten.masked_select")
TO_HOST = "copy to host"
# the kernel wrappers (`repro_torch.kernels`)
WRAPPERS = ("rns_fused_matmul", "rns_fused_crt_partial", "rns_matmul",
            "rns_modmul", "rns_forward", "rns_reverse", "fold",
            "flash_attention")
# the launch counters of `chip_smoke.py`: the wrappers, and the residue-in
# launches among rns_fused_matmul's
COUNTED = ("rns_fused_matmul", "residue_in", "rns_forward", "rns_matmul",
           "rns_reverse", "rns_modmul", "flash_attention", "fold",
           "rns_fused_crt_partial")

# the c10d ops recorded as collectives: op -> (name, the argument holding
# the operands this process contributes)
COLLECTIVES = {
    "c10d.allreduce_": ("all_reduce", 0),
    "c10d.allreduce_coalesced_": ("all_reduce", 0),
    "c10d.broadcast_": ("broadcast", 0),
    "c10d.allgather_": ("all_gather", 1),
    "c10d._allgather_base_": ("all_gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all_gather", 1),
    "c10d.reduce_scatter_": ("reduce_scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce_scatter", 1),
    "c10d.alltoall_": ("all_to_all", 1),
    "c10d.alltoall_base_": ("all_to_all", 1),
}


# the functional collectives (DTensor's) recorded in `TraceSummary.wire`:
# op -> the reference's HLO name (`launch/roofline.collective_bytes`)
FUNCTIONAL = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
}

_NAMES: Dict = {}                 # op overload -> "aten.<name>"
_COMPOSITE: Dict = {}             # op overload -> has a decomposition


def decomposed(mode, func, args, kwargs):
    """The op run as its decomposition under ``mode`` when it has one
    (``matmul``, ``einsum``: inference mode hands a dispatch mode the
    composite op itself), so its ops reach the mode one by one;
    NotImplemented otherwise."""
    comp = _COMPOSITE.get(func)
    if comp is None:
        comp = _COMPOSITE[func] = \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
    if not comp:
        return NotImplemented
    with mode:
        return func.decompose(*args, **kwargs)


class _Propagating(threading.local):
    depth = 0


_prop = _Propagating()
_hooked: list = []


def _hook_propagation() -> None:
    """Mark the ops DTensor's sharding propagation runs to learn an
    output's global shape (its ``_propagate_tensor_meta_non_cached``,
    cached per op schema, so they appear on an op's first call only):
    while it runs, ``_prop.depth`` is non-zero.  Installed once a
    process."""
    if _hooked:
        return
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    inner = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        _prop.depth += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _prop.depth -= 1

    setattr(ShardingPropagator, name, marked)
    _hooked.append(name)


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def tensors(obj):
    """The tensors of a nested structure (dicts, lists, tuples and
    :class:`RNSTensor`s, residues then scale), in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)
    elif hasattr(obj, "residues") and hasattr(obj, "scale"):
        yield obj.residues
        yield obj.scale


@dataclasses.dataclass
class TraceSummary:
    """Op census of one traced call, split by kernel region."""

    outside: Counter              # aten op -> count outside kernel regions
    inside: Counter               # aten op -> count inside kernel regions
    kernel_calls: Counter         # wrapper -> outermost calls
    syncs: Counter                # host-sync op -> count outside regions
    flops: Counter                # aten op -> float flops outside regions
    kernel_ops: Counter           # wrapper -> operations of its calls
    peak_bytes: int = 0           # peak live bytes of storages made
    failed_op: Optional[str] = None   # the op that raised, if any
    # one entry a collective outside the regions: (name, ((shape, dtype
    # name), ...)) of the operands this process contributes
    collectives: list = dataclasses.field(default_factory=list)
    # one entry a functional collective: (the reference's HLO op name,
    # output bytes, group size)
    wire: list = dataclasses.field(default_factory=list)

    def count_outside(self, names: Iterable[str]) -> int:
        return sum(self.outside.get(n, 0) for n in names)

    @property
    def kernel_total(self) -> int:
        return sum(self.kernel_calls.values())


def _channels(w, x, basis) -> int:
    """Channels of an rns_fused_matmul call, as the wrapper resolves them."""
    for t in (w, x):
        res = getattr(t, "residues", t)
        if res.ndim == 3:
            return res.shape[0]
    if basis is not None:
        return len(basis.moduli)
    from repro_torch.core.rns import basis_for_int8_matmul
    return basis_for_int8_matmul(x.shape[-1]).k


def kernel_ops(name: str, args, kwargs) -> float:
    """Operations of one wrapper call from its argument shapes: 2·M·K·N a
    channel for the channel matmuls; the analytic model's (C + 1) an
    element for the forward conversion and C·(C + 1)/2 + 3·C for the
    reverse; C an element for `rns_modmul` and `fold`; 4·B·H·Sq·Sk·D float
    flops for `flash_attention`."""
    if name in ("rns_fused_matmul", "rns_fused_crt_partial", "rns_matmul"):
        x, w = args[0], args[1]
        xr, wr = getattr(x, "residues", x), getattr(w, "residues", w)
        M, K = xr.shape[-2:]
        N = wr.shape[-1]
        if name == "rns_fused_matmul":
            basis = args[2] if len(args) > 2 else kwargs.get("basis")
            C = _channels(w, x, basis)
        else:
            C = wr.shape[0]
        return 2.0 * M * K * N * C
    if name == "rns_forward":
        C = len(args[1] if len(args) > 1 else kwargs["moduli"])
        return (C + 1.0) * args[0].numel()
    if name == "rns_reverse":
        r = args[0]
        C = r.shape[0]
        return (C * (C + 1) / 2.0 + 3.0 * C) * (r.numel() // max(C, 1))
    if name in ("rns_modmul", "fold"):
        return float(args[0].numel())
    if name == "flash_attention":
        q, k = args[0], args[1]
        B, H, Sq, D = q.shape
        return 4.0 * B * H * Sq * k.shape[2] * D
    return 0.0


class RegionMode(TorchDispatchMode):
    """A dispatch mode that hears the kernel regions (`kernels._build.
    kernel_region`) while it is entered: ``enter(name, args, kwargs)`` and
    ``exit(name, out)`` of each outermost wrapper call.  Re-entering it (a
    decomposition run under it) registers nothing twice."""

    _entered = 0

    def enter(self, name, args, kwargs):
        pass

    def exit(self, name, out):
        pass

    def __enter__(self):
        if not self._entered:
            _build.add_observer(self)
        self._entered += 1
        try:
            return super().__enter__()
        except BaseException:
            self._leave()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._leave()

    def _leave(self):
        self._entered -= 1
        if not self._entered:
            _build.remove_observer(self)


class TraceMode(RegionMode):
    """Records the aten ops of the calls made inside it (see the module
    docstring); ``flops`` and ``memory`` turn on the dry run's counts."""

    def __init__(self, *, flops: bool = False, memory: bool = False,
                 dtensor: bool = False):
        super().__init__()
        self._dtensor = None
        if dtensor:
            _hook_propagation()
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor
        self.summary = TraceSummary(Counter(), Counter(), Counter(),
                                    Counter(), Counter(), Counter())
        self._flops, self._memory = flops, memory
        self._live: Dict[int, int] = {}     # storage key -> bytes
        self._bytes = 0

    # kernel regions (`kernels._build.add_observer`)
    def enter(self, name, args, kwargs):
        self.summary.kernel_calls[name] += 1
        if self._flops:
            self.summary.kernel_ops[name] += kernel_ops(name, args, kwargs)

    def exit(self, name, out):
        pass


    def _free(self, key):
        self._bytes -= self._live.pop(key, 0)

    def _track(self, args, outs):
        new = {}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in self._live:
                new[st._cdata] = st
        if not new:
            return
        for t in tensors(args):                # an argument, a view, a write
            new.pop(t.untyped_storage()._cdata, None)
        for key, st in new.items():
            self._live[key] = st.nbytes()
            self._bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.summary.peak_bytes = max(self.summary.peak_bytes, self._bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None:
            if any(issubclass(t, self._dtensor) for t in types):
                return NotImplemented
            if _prop.depth:                     # a global-shape shadow op
                return func(*args, **kwargs)
            if func is torch.ops.aten.equal.default and any(
                    t.device.type == "meta" for t in tensors(args)):
                # DTensor's own bookkeeping (a MaskPartial's buffer checks
                # that a re-materialized mask is the one it holds); the
                # step's ops never compare whole tensors on meta
                return True
        out = decomposed(self, func, args, kwargs)
        if out is not NotImplemented:
            return out
        name = _NAMES.get(func)
        if name is None:
            name = _NAMES[func] = str(func.overloadpacket)
        inside = _build.region_depth() > 0
        s = self.summary
        (s.inside if inside else s.outside)[name] += 1
        coll = COLLECTIVES.get(name)
        if coll is not None and not inside:
            s.collectives.append((coll[0], tuple(
                (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for t in tensors(args[coll[1]]))))
        if not inside and name in SYNC_OPS:
            s.syncs[name] += 1
        try:
            out = func(*args, **kwargs)
        except Exception:
            s.failed_op = s.failed_op or name
            raise
        outs = list(tensors(out))
        if name in FUNCTIONAL and not inside:
            s.wire.append((FUNCTIONAL[name],
                           sum(t.numel() * t.element_size() for t in outs),
                           _group_size(args)))
        if not inside:
            if any(t.device.type == "cpu" for t in outs) and any(
                    t.device.type == "cuda" for t in tensors((args, kwargs))):
                s.syncs[TO_HOST] += 1
            if self._flops and func.overloadpacket in flop_registry:
                s.flops[name] += flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out)
        if self._memory:
            self._track((args, kwargs), outs)
        return out


def summarize_fn(fn, *example_args, **example_kwargs) -> TraceSummary:
    """Run ``fn`` on example args under a :class:`TraceMode` and summarize
    the ops it ran."""
    with TraceMode() as mode:
        fn(*example_args, **example_kwargs)
    return mode.summary


# ----------------------------------------------------------------- checks --
def check_resident(summary: TraceSummary, *, min_kernel_calls: int = 1,
                   subject: str = "trace") -> Report:
    """Resident-path invariant: every modular reduction lives in a kernel.

    Errors when any ``remainder``/``fmod`` op runs outside a kernel region
    (a standalone conversion escaped fusion) or when no kernel was called
    at all (the "resident" trace never reached a kernel, so the invariant
    would hold vacuously).
    """
    rep = Report(subject=f"residency:{subject}")
    stray = summary.count_outside(MODULAR_OPS)
    if stray:
        per = {n: summary.outside[n] for n in MODULAR_OPS
               if summary.outside.get(n)}
        rep.add("residency", "resident path",
                f"{stray} modular-reduction op(s) outside a kernel region "
                f"({per}) — a standalone conversion escaped the fused "
                f"kernel")
    if summary.kernel_total < min_kernel_calls:
        rep.add("residency", "resident path",
                f"only {summary.kernel_total} kernel call(s) in the trace "
                f"(expected >= {min_kernel_calls}) — the resident invariant "
                f"would hold vacuously")
    return rep


def check_kernel_count(summary: TraceSummary,
                       expected: Union[int, Dict[str, int]], *,
                       subject: str = "trace") -> Report:
    """Fused-launch invariant: exactly N kernel calls, in all or (a dict,
    as `expected_step` gives it) by wrapper."""
    rep = Report(subject=f"residency:{subject}")
    if isinstance(expected, dict):
        want = kernel_calls(expected)
        got = dict(summary.kernel_calls)
        if got != want:
            rep.add("residency", "kernel launches",
                    f"kernel calls {got} in the trace, expected exactly "
                    f"{want} — fusion split or duplicated a launch")
    elif summary.kernel_total != expected:
        rep.add("residency", "kernel launches",
                f"{summary.kernel_total} kernel call(s) in the trace, "
                f"expected exactly {expected} — fusion split or duplicated "
                f"a launch")
    return rep


def check_no_callbacks(summary: TraceSummary, *,
                       subject: str = "trace") -> Report:
    """Captured-step invariant: no host sync inside the step, so the step
    can be captured as a CUDA graph and tokens cross to the host once,
    after it."""
    rep = Report(subject=f"residency:{subject}")
    if summary.syncs:
        rep.add("residency", "host boundary",
                f"host sync(s) in the step: {dict(summary.syncs)} — a "
                f"captured step cannot read the device on the host")
    return rep


def check_reduced_wire(summary: TraceSummary, channels: Iterable[int], *,
                       nlimbs: Optional[Iterable[int]] = None,
                       subject: str = "trace") -> Report:
    """Channel-sharded wire invariant: residues never cross between ranks.

    A channel-sharded launch communicates only its reduced result: the
    narrow (L1, M, N) int32 CRT limb planes, or a float output.  A
    collective whose operand is an integer stack of 3+ dims led by a
    launch basis' channel count (``channels``) means a residue slab was on
    the wire.  ``nlimbs`` lists the limb-plane leading dims, so a basis
    whose L1 equals another basis' C does not false-positive.
    """
    rep = Report(subject=f"residency:{subject}")
    chans = set(int(c) for c in channels)
    limbs = set(int(v) for v in (nlimbs or ()))
    for name, operands in summary.collectives:
        for shape, dtype in operands:
            if (len(shape) >= 3 and shape[0] in chans
                    and shape[0] not in limbs
                    and "int" in dtype and "uint" not in dtype[:4]):
                rep.add("residency", "reduced wire",
                        f"collective '{name}' moves an integer {shape} "
                        f"{dtype} stack whose leading dim matches a launch "
                        f"basis' channel count — residues crossed between "
                        f"ranks instead of the reduced result")
    return rep


# ------------------------------------------- launches a dispatch implies --
def expected_launches(cfg, steps: int) -> Dict[str, int]:
    """Kernel calls of a ``steps``-step generate (prefill + steps−1 decode
    steps) including the weight encodes at Engine init (one a weight leaf),
    by `COUNTED` name, for the dense stack (7 linears a layer): the fused
    kernel once a linear, or for a residue-domain config a fused launch a
    linear with the QKV and gate/up inputs encoded once each; the staged
    kernels (the weight's forward conversion unless encoded, the channel
    matmul, the reverse) on backend "pallas"."""
    spec, L = cfg.linear_spec, cfg.num_layers
    want = dict.fromkeys(COUNTED, 0)
    if not spec.is_rns:                       # plain bf16 matmuls
        return want
    n = 7 * L * steps
    if spec.encode_weights:
        want["rns_forward"] = 7
    if spec.backend == "pallas":
        want.update(rns_matmul=n, rns_reverse=n)
        if not spec.encode_weights:
            want["rns_forward"] += n
    elif spec.domain == "residue":            # QKV + wo + gate/up/down
        want.update(rns_fused_matmul=5 * L * steps,
                    residue_in=4 * L * steps)
        want["rns_forward"] += 2 * L * steps
    else:
        want["rns_fused_matmul"] = n
    return want


def expected_step(cfg) -> Dict[str, int]:
    """Kernel calls of one decode step (a host-loop step or the captured
    one)."""
    one, two = expected_launches(cfg, 1), expected_launches(cfg, 2)
    return {k: two[k] - one[k] for k in COUNTED}


def expected_prefill(cfg) -> Dict[str, int]:
    """Kernel calls of one eager prefill (a generate's first step, less
    the weight encodes at Engine init)."""
    one, init = expected_launches(cfg, 1), expected_launches(cfg, 0)
    return {k: one[k] - init[k] for k in COUNTED}


# RNS-linear forwards a layer a train step under each remat policy: the
# forward, and the recompute of the whole layer ("full") or of all but
# `wo` and `w_down` ("save_ar")
_TRAIN_FORWARDS = {"full": 14, "save_ar": 12, "none": 7}


def expected_train_step(cfg) -> Dict[str, int]:
    """Kernel calls of one train step (loss, backward, update) of the dense
    stack: the live weights take the per-linear path (`train/trainstep.
    _train_cfg`), one fused launch a linear, or the staged forward, matmul
    and reverse; the straight-through backward launches none."""
    spec = cfg.linear_spec
    want = dict.fromkeys(COUNTED, 0)
    if not spec.is_rns:
        return want
    policy = cfg.remat_policy if cfg.remat else "none"
    n = _TRAIN_FORWARDS[policy] * cfg.num_layers
    if spec.backend == "pallas":
        for k in ("rns_forward", "rns_matmul", "rns_reverse"):
            want[k] = n
    else:
        want["rns_fused_matmul"] = n
    return want


def kernel_calls(launches: Dict[str, int]) -> Dict[str, int]:
    """The calls by wrapper a `COUNTED` dict implies, without zeros and
    without the residue-in share of the fused launches: what
    `TraceSummary.kernel_calls` holds."""
    return {k: v for k, v in launches.items() if k != "residue_in" and v}
