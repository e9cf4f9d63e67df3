"""The kernel entries on DTensor arguments: one sharding rule an entry.

The reference's kernels run under GSPMD, which partitions a ``pallas_call``
like any other op: each device runs the kernel on its local blocks, and
the partitioner moves what the kernel's operands need.  Here a kernel
wrapper (`_build.kernel_region`) given a ``torch.distributed.tensor.
DTensor`` among its arguments hands the call to :func:`run`: the entry's
rule names the placement of every operand and of the output, each operand
is redistributed to its placement (DTensor issues the collectives that
takes, which a trace sees), the wrapper runs once on the local shards (one
kernel call, at the local shapes, so a trace counts per-device work), and
the outputs come back as DTensors with the rule's placements.

The rules, by entry:

- ``rns_fused_matmul`` / ``rns_fused_crt_partial`` / ``rns_matmul``
  (x (M, K) or residues (C, M, K), w (K, N) or (C, K, N)): the output
  keeps x's row sharding and the weight's column sharding (the column
  layout of `dist/rns_shard.py`: a column needs only its own column
  scale).  Everything else is gathered: the contraction dim K of both
  operands (the row's quantize scale and a live weight's column scale each
  need all of K, so a K-sharded weight cannot run as a partial sum), a
  residue stack's channels, and a weight column sharding on a mesh dim
  that already shards x's rows.  An in-domain exit (``emit="residues"``)
  gathers the columns too: its requantize constant is the largest column
  scale.  Row factors follow x, column factors the weight, a full (M, N)
  ``scale`` both.
- ``rns_forward`` (elementwise, a channel axis in front): x's shardings,
  one dim further right.
- ``rns_reverse`` and ``rns_modmul`` (a channel axis in front): the
  channels gathered (the MRC reads every channel; a channel slice would
  need its own moduli), every other dim as it is; ``scale`` is
  sharded where it spans the output dim, else whole.
- ``fold`` ((C, S)): the channels gathered, S as it is.
- ``flash_attention`` (q, k, v (B, H, S, D)): q's batch and head
  shardings kept on all three (and on ``pad`` / 2-D ``qpos``, ``kpos``),
  the sequences and D gathered.

Partial placements are reduced (an all-reduce or reduce-scatter) before a
kernel reads them.
"""
from __future__ import annotations

import inspect
import sys
from typing import Callable, Dict

import torch

__all__ = ["RULES", "has_dtensor", "run"]

RULES: Dict[str, Callable] = {}
_SIGS: Dict[Callable, inspect.Signature] = {}


def _rule(*names):
    def reg(fn):
        for n in names:
            RULES[n] = fn
        return fn
    return reg


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif hasattr(obj, "residues") and hasattr(obj, "scale"):
        yield obj.residues
        if obj.scale is not None:
            yield obj.scale


def has_dtensor(args, kwargs) -> bool:
    """Whether a DTensor is among the arguments.  No DTensor exists before
    `torch.distributed.tensor` is imported, so until then (every run
    without a mesh) this is one dictionary lookup."""
    if "torch.distributed.tensor" not in sys.modules:
        return False
    for a in _leaves((args, tuple(kwargs.values()))):
        if type(a) is not torch.Tensor and isinstance(a, _dtensor_type()):
            return True
    return False


class _Call:
    """One call's mesh and operand placements."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.ndim

    def keep(self, t, dims: Dict[int, int]):
        """Placements: Shard(dims[i]) on mesh dim i, Replicate elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(dims[i]) if i in dims else Replicate()
                for i in range(self.n)]

    def sharded(self, t, dim: int) -> Dict[int, int]:
        """The mesh dims on which ``t`` is sharded along ``dim``."""
        from torch.distributed.tensor import Shard
        if not isinstance(t, _dtensor_type()):
            return {}
        dim = dim % t.ndim
        return {i: dim for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim == dim}

    def local(self, t, dims: Dict[int, int]):
        """``t`` redistributed to Shard(dims) / Replicate, as its local
        shard; a plain tensor is taken as replicated."""
        if t is None:
            return None
        DTensor = _dtensor_type()
        if not isinstance(t, DTensor):
            from torch.distributed.tensor import Replicate
            t = DTensor.from_local(t, self.mesh, [Replicate()] * self.n,
                                   run_check=False)
        return t.redistribute(self.mesh, self.keep(t, dims)).to_local()

    def along(self, t, out_dims: Dict[int, int], out_ndim: int):
        """Placements of a factor broadcast against an output sharded by
        ``out_dims`` (right-aligned): sharded where it spans the dim."""
        if t is None or not isinstance(t, torch.Tensor):
            return t
        off = out_ndim - t.ndim
        dims = {i: d - off for i, d in out_dims.items()
                if d - off >= 0 and t.shape[d - off] > 1}
        return self.local(t, dims)

    def rns(self, x, res_dims: Dict[int, int], scale_dims: Dict[int, int]):
        """An `RNSTensor` operand with its residues and scale placed."""
        import dataclasses
        return dataclasses.replace(
            x, residues=self.local(x.residues, res_dims),
            scale=self.local(x.scale, scale_dims))


def _shift(dims: Dict[int, int], by: int) -> Dict[int, int]:
    return {i: d + by for i, d in dims.items() if d + by >= 0}


@_rule("rns_fused_matmul", "rns_fused_crt_partial", "rns_matmul")
def _matmul_rule(c: _Call, a: dict, name: str):
    """Rows of x and columns of the weight kept; K, channels gathered."""
    xkey, wkey = ("a_res", "b_res") if name == "rns_matmul" else ("x", "w")
    x, w = a[xkey], a[wkey]
    xr = getattr(x, "residues", x)
    wr = getattr(w, "residues", w)
    rows = c.sharded(xr, -2)
    cols = {i: d for i, d in c.sharded(wr, -1).items() if i not in rows}
    if a.get("emit") == "residues" and a.get("requant_creq") is None:
        cols = {}
    row_dims = {i: xr.ndim - 2 for i in rows}
    col_dims = {i: wr.ndim - 1 for i in cols}
    if hasattr(x, "residues"):
        a[xkey] = c.rns(x, row_dims, {i: 0 for i in rows})
    else:
        a[xkey] = c.local(x, row_dims)
    if hasattr(w, "residues"):
        sdim = None if w.scale is None else w.scale.ndim - 1
        a[wkey] = c.rns(w, col_dims, {i: sdim for i in cols})
    else:
        a[wkey] = c.local(w, col_dims)
    out2 = {**{i: 0 for i in rows}, **{i: 1 for i in cols}}
    for k in ("scale_row", "gate"):
        if a.get(k) is not None:
            a[k] = c.local(a[k], {i: 0 for i in rows})
    for k in ("scale_col", "scale"):
        if a.get(k) is not None:
            a[k] = c.along(a[k], out2, 2)
    if name == "rns_fused_matmul" and a.get("emit") == "residues":
        return ("rns", {i: 1 for i in rows}, {i: 0 for i in rows})
    if name == "rns_fused_matmul":
        return ("tensor", out2)
    return ("tensor", _shift(out2, 1))        # (C | L1, M, N)


@_rule("rns_forward")
def _forward_rule(c: _Call, a: dict, name: str):
    x = a["x"]
    keep = {}
    for d in range(x.ndim):
        keep.update(c.sharded(x, d))
    a["x"] = c.local(x, keep)
    return ("tensor", _shift(keep, 1))


@_rule("rns_reverse", "rns_modmul", "fold")
def _channel_rule(c: _Call, a: dict, name: str):
    key = {"rns_reverse": "residues", "rns_modmul": "a_res",
           "fold": "x"}[name]
    r = a[key]
    keep = {}
    for d in range(1, r.ndim):
        keep.update(c.sharded(r, d))
    a[key] = c.local(r, keep)
    if name == "rns_modmul":
        a["b_res"] = c.local(a["b_res"], keep)
    if name != "rns_reverse":
        return ("tensor", keep)
    out = _shift(keep, -1)
    if a.get("scale") is not None:
        a["scale"] = c.along(a["scale"], out, r.ndim - 1)
    return ("tensor", out)


@_rule("flash_attention")
def _flash_rule(c: _Call, a: dict, name: str):
    q = a["q"]
    keep = {**c.sharded(q, 0), **c.sharded(q, 1)}
    for k in ("q", "k", "v"):
        a[k] = c.local(a[k], keep)
    lead = {i: 0 for i, d in keep.items() if d == 0}
    if a.get("pad") is not None:
        a["pad"] = c.local(a["pad"], lead)
    for k in ("qpos", "kpos"):
        t = a.get(k)
        if isinstance(t, torch.Tensor):
            a[k] = c.local(t, lead if t.ndim == 2 else {})
    return ("tensor", keep)


def _mesh_of(args, kwargs):
    DTensor = _dtensor_type()
    for t in _leaves((args, tuple(kwargs.values()))):
        if isinstance(t, DTensor):
            return t.device_mesh
    raise ValueError("no DTensor among the arguments")


def run(name: str, fn: Callable, args, kwargs):
    """Call the kernel wrapper ``fn`` (entry ``name``) on the local shards
    of DTensor arguments by the entry's rule; the outputs come back as
    DTensors."""
    from torch.distributed.tensor import DTensor
    sig = _SIGS.get(fn)
    if sig is None:
        sig = _SIGS[fn] = inspect.signature(fn)
    bound = sig.bind(*args, **kwargs)
    a = dict(bound.arguments)
    c = _Call(_mesh_of(args, kwargs))
    kind, *dims = RULES[name](c, a, name)
    bound.arguments.update(a)
    out = fn(*bound.args, **bound.kwargs)

    def wrap(t, d):
        return DTensor.from_local(t, c.mesh, c.keep(t, d), run_check=False)

    if kind == "rns":
        import dataclasses
        return dataclasses.replace(out, residues=wrap(out.residues, dims[0]),
                                   scale=wrap(out.scale, dims[1]))
    return wrap(out, dims[0])
