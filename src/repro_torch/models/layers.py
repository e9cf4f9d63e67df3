"""Shared layers of the decoder stack, port of `repro/models/layers.py`:
the linear dispatch (with the residue-resident chains `linear_qkv` and
`mlp_chain`), RMSNorm, RoPE and sinusoidal positions, GQA attention with
sliding windows and score softcaps, the full and ring KV caches and the
paged KV pool's per-slot write and gather.

Layouts follow the reference: activations (B, S, d), attention heads
(B, S, H, D), weights (d_in, d_out).

The row reductions that see padding — the attention scores, the softmax
denominator, the probability-weighted sum of values, the RMSNorm mean, a
prefill's plain (bf16) linears (`matmul_exact`, which the prefill selects)
and the SSM's prefill state — accumulate in float64 and round once to the
working type.  Left padding only
adds exact zeros to those sums, and a float64 sum of these terms is exact or
off by ~2^-53, so the rounded result does not depend on where the real keys
sit or how many pad slots there are: greedy outputs are batch-invariant by
construction, on the CPU and on the card alike.  (The reference gets its
batch invariance from XLA's shape-stable reductions instead.)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.linear_spec import LinearSpec
from repro_torch.core.quant import quantize_int8
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.core.rns_linear import rns_chain_linear, rns_dense, rows_as
from repro_torch.core.rns_tensor import (RNSTensor, cat_columns,
                                         encode_activation)

__all__ = ["linear", "linear_qkv", "mlp_chain", "rms_norm", "rope",
           "apply_rope", "sinusoidal", "attention", "update_cache_full",
           "update_cache_ring", "silu", "gelu", "act_fn", "paged_write",
           "paged_gather", "paged_kpos", "Leaf", "dense_leaf",
           "materialize", "matmul", "matmul_exact", "embed_rows",
           "even_shards", "local_block", "local_weight", "local_matmul",
           "from_local_blocks", "tp_matmul", "merge_heads",
           "split_dim", "lookup"]

NEG_INF = -1e30
FULL_WINDOW = 1 << 30       # the window of a full causal layer


@dataclasses.dataclass(frozen=True)
class Leaf:
    """How one parameter is made: its shape (without the stacked block
    axis), its init (``"zeros"``, ``"ones"``, ``"normal"`` with ``std``, or
    ``"log_arange"``: log(1..n) along the last axis, the SSM's A_log) and
    its dtype (None: the config's parameter dtype)."""
    shape: tuple
    init: str = "zeros"
    std: float = 0.0
    dtype: Optional[torch.dtype] = None


def dense_leaf(d_in: int, d_out: int) -> Leaf:
    """A (d_in, d_out) linear weight, N(0, 1/d_in) as the reference's
    `make_dense_params`."""
    return Leaf((d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def materialize(tree: Dict[str, Any], generator: torch.Generator, device,
                dtype: torch.dtype, lead: tuple = ()) -> Dict[str, Any]:
    """Tensors on ``device`` for a nested dict of :class:`Leaf`s, each with
    the leading axes ``lead`` (the stacked block axis), normal draws taken
    from ``generator`` in the dict's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = materialize(v, generator, device, dtype, lead)
            continue
        shape, dt = lead + tuple(v.shape), v.dtype or dtype
        if v.init == "normal":
            t = (torch.randn(shape, generator=generator, device=device)
                 * v.std).to(dt)
        elif v.init == "log_arange":
            n = shape[-1]
            t = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)).expand(shape) \
                .to(dt).contiguous()
        else:
            t = (torch.ones if v.init == "ones" else torch.zeros)(
                shape, dtype=dt, device=device)
        out[k] = t
    return out


class _EmbedRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums each id's rows deterministically.
    Indexing's own backward accumulates with atomics on CUDA, in an order
    that changes between runs; here the rows of each distinct id are summed
    by a one-hot float64 matmul, one block of ids at a time, and rounded
    once to the table's dtype."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        ctx.placements = getattr(table, "placements", None)
        return lookup(table, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        if hasattr(g, "placements"):
            return _embed_grad_on_shards(ctx, g, ids), None
        flat = ids.reshape(-1)
        g64 = g.reshape(flat.numel(), -1).to(torch.float64)
        if g.device.type == "meta":
            # a dry run has no ids to read: take the most distinct ids the
            # batch can hold, so the shapes bound the work
            uniq = flat.new_empty(min(ctx.rows, flat.numel()))
            inv = torch.empty_like(flat)
        else:
            uniq, inv = torch.unique(flat, return_inverse=True)
        out = torch.zeros((ctx.rows, g64.shape[1]), dtype=ctx.dtype,
                          device=g.device)
        step = max(1, (1 << 24) // max(1, flat.numel()))
        for s in range(0, uniq.numel(), step):
            cols = torch.arange(s, min(s + step, uniq.numel()),
                                device=g.device)
            onehot = (inv[None, :] == cols[:, None]).to(torch.float64)
            out[uniq[s:s + step]] = (onehot @ g64).to(ctx.dtype)
        return out, None


def _embed_grad_on_shards(ctx, g, ids):
    """A mesh run's (DTensor) table gradient: each rank's one-hot float64
    product over its own tokens (the ids' batch sharding) and its own
    vocab rows (the table's vocab sharding), summed over the token shards
    into the table's placement.  DTensor's own strategy for the global
    product gathers the vocab, and the model ranks each repeat it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = g.device_mesh
    nd = mesh.ndim
    tpl = ctx.placements or [Replicate()] * nd
    vocab = [i for i, p in enumerate(tpl) if isinstance(p, Shard)
             and p.dim == 0]
    n_v = math.prod(mesh.size(i) for i in vocab)
    if ctx.rows % n_v:
        vocab, n_v = [], 1
    ipl = getattr(ids, "placements", [Replicate()] * nd)
    tok, n = [], 1
    for i, p in enumerate(ipl):
        if isinstance(p, Shard) and p.dim == 0 and i not in vocab \
                and ids.shape[0] % (n * mesh.size(i)) == 0:
            tok.append(i)
            n *= mesh.size(i)
    rows_pl = [Shard(0) if i in tok else Replicate() for i in range(nd)]

    li = local_block(ids, mesh, rows_pl).reshape(-1)
    gl = local_block(g, mesh, rows_pl).reshape(li.numel(), -1).to(
        torch.float64)
    rows = ctx.rows // n_v
    start = 0
    for i in vocab:
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= rows
    cols = torch.arange(start, start + rows, device=li.device)
    onehot = (li[:, None] == cols[None, :]).to(torch.float64)
    out = DTensor.from_local(
        onehot.T @ gl, mesh, [Shard(0) if i in vocab else Partial() if i in tok
                              else Replicate() for i in range(nd)],
        run_check=False)
    return out.redistribute(mesh, tpl).to(ctx.dtype)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A mesh run's (DTensor) table is looked up on its
    local shard, as GSPMD partitions a gather: a table sharded on the
    vocab over a mesh dim gives each rank the rows of the ids it holds
    (zeros elsewhere), summed over that dim (an all-reduce of the (..., d)
    rows) where indexing would gather the whole table; one sharded on d
    keeps that sharding; the ids keep their batch sharding."""
    pl = getattr(table, "placements", None)
    if pl is None:
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh

    def on(p, d):
        return isinstance(p, Shard) and p.dim == d

    vocab = [i for i, p in enumerate(pl) if on(p, 0)]
    if len(vocab) > 1 or (vocab and table.shape[0] % mesh.size(vocab[0])):
        return table[ids]
    v = vocab[0] if vocab else None
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ipl = [p if isinstance(p, Shard) and i != v else Replicate()
           for i, p in enumerate(ids.placements)]
    tpl = [p if i == v or (on(p, 1) and not isinstance(ipl[i], Shard))
           else Replicate() for i, p in enumerate(pl)]
    ids, table = ids.redistribute(mesh, ipl), table.redistribute(mesh, tpl)
    local, li = table.to_local(), ids.to_local()
    if v is None:
        out = local[li]
    else:
        rows = local.shape[0]
        start = mesh.get_local_rank(v) * rows
        hit = ((li >= start) & (li < start + rows))[..., None]
        out = torch.where(hit, local[(li - start).clamp(0, rows - 1)],
                          torch.zeros((), dtype=local.dtype,
                                      device=li.device))
    place = [Partial() if i == v else q if isinstance(q, Shard) else
             Shard(out.ndim - 1) if on(tpl[i], 1) else Replicate()
             for i, q in enumerate(ipl)]
    out = DTensor.from_local(out, mesh, place, run_check=False)
    if v is None:
        return out
    return out.redistribute(mesh, [Replicate() if i == v else p
                                   for i, p in enumerate(place)])


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup) with a deterministic backward."""
    return _EmbedRows.apply(table, ids)


def linear(x: torch.Tensor, w, spec="bf16", exact: bool = False
           ) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) under ``spec`` (a
    :class:`LinearSpec` or its string): mode "bf16" is a plain matmul
    (`matmul_exact` when ``exact``, as a prefill asks), "rns_int8" the RNS
    datapath (`core/rns_linear.rns_dense`) on the spec's backend, exact by
    construction; an encoded :class:`RNSTensor` weight needs the RNS
    mode."""
    spec = LinearSpec.parse(spec)
    if isinstance(w, RNSTensor) and not spec.is_rns:
        raise ValueError(f"encoded (RNSTensor) weights need mode "
                         f"'rns_int8', got {spec}")
    if not spec.is_rns:
        return matmul(x, w, exact)
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    y = rows_as(rns_dense(x2, w, spec.backend, broadcast=spec.broadcast),
                x2)
    return y.reshape(*shp[:-1], y.shape[-1])


def matmul(x: torch.Tensor, w: torch.Tensor, exact: bool = False
           ) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in x's dtype: `matmul_exact` when
    ``exact``, the library GEMM otherwise.  On DTensors it runs as tensor
    and data parallelism place it (`tp_matmul`)."""
    if hasattr(x, "placements") and hasattr(w, "placements") and w.ndim == 2:
        return tp_matmul(x, w, exact)
    return matmul_exact(x, w) if exact else torch.matmul(x, w)


def tp_matmul(x: torch.Tensor, w: torch.Tensor, exact: bool = False
              ) -> torch.Tensor:
    """A mesh run's (DTensor) x (..., d_in) @ w (d_in, d_out), forward and
    backward each on every rank's own blocks (`_TPMatmul`)."""
    return _TPMatmul.apply(x, w, exact)


def _tp_plan(x, w):
    """Per mesh dim, the placements (x, w, y) of x @ w under tensor and
    data parallelism.  Along "model": where it shards w's output columns,
    x is whole (features gathered, partial sums reduced) and y keeps the
    column sharding; where it shards w's input rows, x's features are
    sharded the same way and y is a partial sum.  Along any other dim w is
    whole (an FSDP shard gathered), x keeps a batch-dim sharding and y
    with it, and x's features are gathered.  DTensor's own strategies
    price only the bytes they move: they may gather a weight along
    "model", which repeats the product and its gradient products on every
    model rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = w.device_mesh.mesh_dim_names or ()
    last = x.ndim - 1
    xp, wp, yp = [], [], []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        model = i < len(names) and names[i] == "model"
        if model and isinstance(pw, Shard) and pw.dim == 1:
            xp.append(Replicate())
            wp.append(pw)
            yp.append(Shard(last))
        elif model and isinstance(pw, Shard):
            xp.append(Shard(last))
            wp.append(pw)
            yp.append(Partial())
        elif isinstance(px, Shard) and px.dim % x.ndim != last:
            xp.append(Shard(px.dim % x.ndim))
            wp.append(Replicate())
            yp.append(xp[-1])
        else:
            xp.append(Replicate())
            wp.append(Replicate())
            yp.append(Replicate())
    return xp, wp, yp


class _TPMatmul(torch.autograd.Function):
    """x @ w on DTensors (`_tp_plan`), forward and backward each a local
    product on every rank's blocks.  Backward: dy is placed as y (a
    partial y's gradient whole), dx = dy @ wᵀ is a partial sum where w's
    columns are sharded, and dw = xᵀ @ dy a partial sum over the batch
    shards, each redistributed to its operand's placement (the data
    ranks' gradient all-reduce, or a reduce-scatter into an FSDP shard).
    DTensor's own backward strategies choose their placements anew and
    may gather a weight there even where the forward did not."""

    @staticmethod
    def forward(ctx, x, w, exact):
        from torch.distributed.tensor import Replicate
        mesh = w.device_mesh
        xp, wp, yp = _tp_plan(x, w)
        xl = x.redistribute(mesh, xp).to_local()
        wl = w.redistribute(mesh, wp).to_local()
        yl = matmul_exact(xl, wl) if exact else torch.matmul(xl, wl)
        ctx.save_for_backward(xl, wl)
        ctx.mesh, ctx.plan = mesh, (xp, wp, yp)
        ctx.shapes = (x.shape, w.shape)
        ctx.back = ([Replicate() if p.is_partial() else p
                     for p in x.placements],
                    [Replicate() if p.is_partial() else p
                     for p in w.placements])
        return from_local_blocks(yl, mesh, yp,
                                 (*x.shape[:-1], w.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate, Shard
        xl, wl = ctx.saved_tensors
        mesh, (xp, wp, yp) = ctx.mesh, ctx.plan
        xshape, wshape = ctx.shapes
        last = len(xshape) - 1
        gp = [Replicate() if p.is_partial() else p for p in yp]
        gl = g.redistribute(mesh, gp).to_local()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # w's columns sharded: a partial sum; its rows: x's features
            dxp = [p if not isinstance(q, Shard) else
                   Partial() if q.dim == 1 else Shard(last)
                   for p, q in zip(xp, wp)]
            dx = from_local_blocks(torch.matmul(gl, wl.T), mesh, dxp,
                                   xshape).redistribute(mesh, ctx.back[0])
        if ctx.needs_input_grad[1]:
            dwl = torch.matmul(xl.reshape(-1, xl.shape[-1]).T,
                               gl.reshape(-1, gl.shape[-1]))
            dwp = [q if isinstance(q, Shard) else
                   Partial() if isinstance(p, Shard) else Replicate()
                   for p, q in zip(xp, wp)]
            dw = from_local_blocks(dwl.to(wl.dtype), mesh, dwp,
                                   wshape).redistribute(mesh, ctx.back[1])
        return dx, dw, None


def matmul_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out), summed in float64 and rounded once
    to x's dtype.  Each output row then comes out the same whatever the
    call's row count (a prefill's bucketed prompt length times its lanes),
    which a library GEMM does not promise: it picks its K split by shape.
    The prefill selects it for its plain linears; a decode step, whose
    shape the pinned lanes fix, takes the library GEMM.  It runs at the
    card's FP64 rate."""
    return torch.matmul(x.to(torch.float64),
                        w.to(torch.float64)).to(x.dtype)


def _chain_basis_of(*ws):
    """The shared basis of a chain's encoded weights, or None when every
    weight is a raw float one (each then encoded per call, in the chain's
    default basis, as the reference does); mixed forms raise."""
    enc = [w for w in ws if isinstance(w, RNSTensor)]
    if not enc:
        return None
    if len(enc) != len(ws):
        raise ValueError("a residue-resident chain needs all its weights "
                         "encoded (encode_params with group_basis) or none "
                         "— mixed raw and RNSTensor weights cannot share "
                         "the chain basis")
    b = enc[0].basis
    for w in enc[1:]:
        if w.moduli != tuple(b.moduli):
            raise ValueError(f"chain weights encoded in different bases "
                             f"({b.moduli} vs {w.moduli}); encode them with "
                             "a shared group_basis")
    return b


def mlp_chain(x: torch.Tensor, w_gate, w_up, w_down, spec, act):
    """Residue-resident GLU MLP, act(x·Wg) ⊙ (x·Wu) · Wd, in one trip
    through the domain: the activation is encoded once, gate and up run as
    residue-in launches (the up exit requantizes in the domain, no MRC), and
    the down launch multiplies the re-quantized gate in per channel and
    takes the chain's one MRC exit.  The gate branch leaves the domain at its
    own boundary (the nonlinearity is not residue-safe).  Weights are
    RNSTensors in the chain basis (`basis_for_chain(d_ff)`), or raw floats
    encoded in it per call (the same bits)."""
    spec = LinearSpec.parse(spec)
    shp = x.shape
    xf = x.reshape(-1, shp[-1]).to(torch.float32)
    F = w_down.shape[-2]
    basis = _chain_basis_of(w_gate, w_up, w_down) or basis_for_chain(F)
    if basis.M <= 2 * F * 127 ** 3:
        raise ValueError(
            f"basis {tuple(basis.moduli)} (M={basis.M}) cannot hold the "
            f"chained down-projection bound 2·{F}·127³; encode the MLP "
            "weights in basis_for_chain(d_ff)")
    xa = encode_activation(xf, basis)
    gate_f = rns_chain_linear(xa, w_gate, backend=spec.backend)
    up = rns_chain_linear(xa, w_up, emit="residues", backend=spec.backend)
    gq, sg = quantize_int8(act(gate_f), dim=-1)
    o = rns_chain_linear(up, w_down, gate=gq, gate_scale=sg,
                         backend=spec.backend)
    return o.reshape(*shp[:-1], o.shape[-1]).to(x.dtype)


def linear_qkv(x: torch.Tensor, ws, spec):
    """Stacked Q/K/V projection: the three shared-operand projections
    concatenated along the output axis and run as ONE residue-in launch
    after one activation encode.  Bit-identical to three separate linears:
    per-column weight quantization and the per-column epilogue do not mix
    columns.  ``ws`` is (wq, wk, wv), RNSTensors in one basis or raw
    floats (concatenated and encoded per call in
    `basis_for_int8_matmul(K)`); returns (q, k, v) with x's leading
    dims."""
    spec = LinearSpec.parse(spec)
    shp = x.shape
    xf = x.reshape(-1, shp[-1]).to(torch.float32)
    basis = _chain_basis_of(*ws)
    if basis is None:
        basis = basis_for_int8_matmul(shp[-1])
        w_cat = torch.cat(list(ws), -1)
    else:
        w_cat = cat_columns(ws)
    xa = encode_activation(xf, basis)
    y = rns_chain_linear(xa, w_cat, backend=spec.backend)
    y = y.reshape(*shp[:-1], y.shape[-1]).to(x.dtype)
    return tuple(torch.split(y, [w.shape[-1] for w in ws], dim=-1))


def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x`` with ``dim`` split into ``sizes`` (a reshape: heads out of
    H·dh, or GQA groups out of H).  A DTensor (a mesh run) sharded along
    ``dim`` over a mesh dim that does not divide ``sizes[0]`` is gathered
    along that mesh dim first: DTensor refuses a view that splits a head
    across shards, where GSPMD moves the data itself."""
    dim = dim % x.ndim
    pl = getattr(x, "placements", None)
    if pl is not None:
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        new = [Replicate() if isinstance(p, Shard) and p.dim == dim
               and sizes[0] % mesh.size(i) else p for i, p in enumerate(pl)]
        if new != list(pl):
            x = x.redistribute(mesh, new)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) → (B, S, H·dh).  On a DTensor (a mesh run) the
    gradient is placed as the output was before the backward's view
    splits H·dh again: the projection's backward may shard H·dh over a
    mesh dim that does not divide H, and DTensor refuses that view."""
    if not hasattr(o, "placements"):
        return o.reshape(*o.shape[:2], -1)
    return _MergeHeads.apply(o)


class _MergeHeads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, o):
        y = o.reshape(*o.shape[:2], -1)
        ctx.shape, ctx.placements = o.shape, y.placements
        return y

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        pl = [Replicate() if p.is_partial() else p for p in ctx.placements]
        if list(g.placements) != pl:
            g = g.redistribute(g.device_mesh, pl)
        return g.reshape(ctx.shape)


def even_shards(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every dim that a mesh dim shards but does not divide
    gathered along that mesh dim (a DTensor, a mesh run; anything else as
    it is): DTensor refuses to flatten an unevenly sharded dim into a view,
    where GSPMD pads it.  The gather is a collective the trace prices."""
    pl = getattr(x, "placements", None)
    if pl is None:
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    new, parts = [], {}
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            parts[p.dim] = parts.get(p.dim, 1) * mesh.size(i)
            if x.shape[p.dim] % parts[p.dim]:
                p = Replicate()
        new.append(p)
    return x if new == list(pl) else x.redistribute(mesh, new)


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``t`` (a DTensor, or a plain tensor taken as
    replicated) redistributed to ``placements`` on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local()


def local_weight(w: torch.Tensor, mesh, placements, over) -> torch.Tensor:
    """`local_block` of a weight that each rank applies to its own share
    of the tokens, which mesh dims ``over`` split: its local gradient is a
    partial sum there, reduced into the weight's own placement in the
    backward (the data ranks' all-reduce, or a reduce-scatter into an
    FSDP shard; `to_local` alone would take it as whole)."""
    if not hasattr(w, "placements"):
        return local_block(w, mesh, placements)
    return _LocalWeight.apply(w, mesh, tuple(placements), tuple(over))


class _LocalWeight(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, mesh, placements, over):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.shape = mesh, w.shape
        ctx.grad_pl = (placements, over)
        ctx.back = [Replicate() if p.is_partial() else p
                    for p in w.placements]
        return w.redistribute(mesh, list(placements)).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial
        placements, over = ctx.grad_pl
        pl = [Partial() if i in over else p for i, p in enumerate(placements)]
        dw = from_local_blocks(g, ctx.mesh, pl, ctx.shape)
        return dw.redistribute(ctx.mesh, ctx.back), None, None, None


def local_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., n, k) @ b (..., k, m), the batch dims broadcast.  On
    DTensors (a mesh run over a sharded key sequence) each rank multiplies
    its own blocks: torch's matmul flattens the batch dims into a view,
    which DTensor refuses where a batch dim past the first is sharded
    (torch 2.11) or unevenly sharded.  Per mesh dim: a batch dim either
    operand shards is sliced from the other (a local chunk), a sharded
    contraction dim leaves a partial sum, a sharded row or column dim
    stays; any other pair gathers the smaller operand first, as a partial
    one is reduced (the collectives the trace prices).  Plain tensors go
    to torch.matmul."""
    if not (hasattr(a, "placements") and hasattr(b, "placements")):
        return torch.matmul(a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, r = a.device_mesh, a.ndim
    pa, pb, out = list(a.placements), list(b.placements), []

    def dim(p):
        return p.dim % r if isinstance(p, Shard) else None

    for i in range(mesh.ndim):
        for _ in range(3):      # reduce partials, gather one, then place
            da, db = dim(pa[i]), dim(pb[i])
            if pa[i].is_partial() or pb[i].is_partial():
                if pa[i].is_partial():
                    pa[i] = Replicate()
                if pb[i].is_partial():
                    pb[i] = Replicate()
                continue
            if da is None and db is None:
                out.append(Replicate())
            elif da is not None and da == db and da < r - 2:
                out.append(Shard(da))
            elif da == r - 1 and db == r - 2:
                out.append(Partial())
            elif db is None and da < r - 2:
                if b.shape[da] > 1:
                    pb[i] = Shard(da)
                out.append(Shard(da))
            elif da is None and db < r - 2:
                if a.shape[db] > 1:
                    pa[i] = Shard(db)
                out.append(Shard(db))
            elif db is None and da == r - 2:
                out.append(Shard(r - 2))
            elif da is None and db == r - 1:
                out.append(Shard(r - 1))
            elif db is None:                       # a shards k
                pb[i] = Shard(r - 2)
                out.append(Partial())
            elif da is None:                       # b shards k
                pa[i] = Shard(r - 1)
                out.append(Partial())
            else:
                if a.numel() <= b.numel():
                    pa[i] = Replicate()
                else:
                    pb[i] = Replicate()
                continue
            break
    la = a.redistribute(mesh, pa).to_local()
    lb = b.redistribute(mesh, pb).to_local()
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (
        a.shape[-2], b.shape[-1])
    return from_local_blocks(torch.matmul(la, lb), mesh, out, shape)


def from_local_blocks(t: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose block on each rank is ``t``
    made contiguous, as its global strides say (`DTensor.from_local` alone
    takes a sharded dim as evenly split)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as XLA lowers it: x · 1/(1 + exp(−x)), each op rounded
    to x's dtype (bit-equal in bfloat16; F.silu rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation (torch's default is
    the erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def act_fn(name: str):
    return silu if name == "silu" else gelu


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).to(torch.float64).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var.to(torch.float32) + eps) \
        * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # the reference's numpy float32 frequencies, bit for bit; cached per
    # device so decode steps do not copy (and sync) from the host
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(freqs).to(device)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions (...,) int → (cos, sin) of shape (..., head_dim // 2)."""
    ang = positions.to(torch.float32)[..., None] \
        * _rope_freqs(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic sinusoidal embeddings (musicgen): positions (...,) →
    (..., d_model) float32, [sin | cos] of the reference's numpy float32
    frequencies."""
    ang = positions.to(torch.float32)[..., None] \
        * _sin_freqs(d_model, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@functools.lru_cache(maxsize=16)
def _sin_freqs(d_model: int, device) -> torch.Tensor:
    # cached per device, as `_rope_freqs`: a captured step copies nothing
    # from the host
    half = d_model // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32)
                   / half)                  # float64, taken as float32
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def _mask(qpos, kpos, window):
    """Causal and sliding-window mask over valid keys (kpos >= 0): a key
    is seen by a query at qpos iff qpos − window < kpos <= qpos.  qpos
    (Bm, Sq), kpos (Bm, Sk) → (Bm, Sq, Sk).  A full layer's window (2^30)
    masks nothing, so its term is left out."""
    kp, qp = kpos[:, None, :], qpos[:, :, None]
    m = (kp <= qp) & (kp >= 0)
    if window < FULL_WINDOW:
        m &= kp > qp - window
    return m


def _scores(qg, kg, scale, softcap):
    """(…, Sq, D) · (…, Sk, D) → float32 scores, summed in float64 and
    rounded to the operands' dtype as the reference's einsum is, then
    capped to softcap·tanh(s / softcap) when a softcap is given."""
    s = local_matmul(qg.to(torch.float64),
                     kg.to(torch.float64).transpose(-1, -2))
    s = s.to(qg.dtype).to(torch.float32) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s


def _attention_on_shards(q, k, v, qpos, kpos, **kw):
    """A mesh run's (DTensor) attention on each rank's own block, as GSPMD
    partitions a batched attention: the batch and the heads keep their
    sharding (a KV head sharding that does not divide the KV heads gathers
    the query heads too), the sequences and D are gathered, and each rank
    attends its (batch, head) block with the plain ops, exactly.  A mesh
    dim that shards neither takes a share of the batch where it divides
    it, else of the query rows (each row attends every key, and the rows
    are gathered after), so no rank repeats another's work.  None when a key sequence is sharded (a
    decode cache): DTensor's own ops run it, without gathering the
    cache."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def shard(t, d):
        return {i for i, p in enumerate(getattr(t, "placements", ()))
                if isinstance(p, Shard) and p.dim == d}

    if shard(k, 1) or shard(v, 1):
        return None
    mesh = q.device_mesh
    batch = shard(q, 0)
    heads = {i for i in shard(q, 2) - batch
             if k.shape[2] % mesh.size(i) == 0}
    nb = math.prod(mesh.size(i) for i in batch)
    nr, rows_q = 1, set()
    for i in sorted(set(range(mesh.ndim)) - batch - heads):
        if q.shape[0] % (nb * mesh.size(i)) == 0:
            batch.add(i)
            nb *= mesh.size(i)
        elif q.shape[1] % (nr * mesh.size(i)) == 0 and q.shape[1] > 1:
            rows_q.add(i)
            nr *= mesh.size(i)
    kv = [Shard(0) if i in batch else Shard(2) if i in heads
          else Replicate() for i in range(mesh.ndim)]
    place = [Shard(1) if i in rows_q else p for i, p in enumerate(kv)]
    rows = [Shard(0) if i in batch else Replicate()
            for i in range(mesh.ndim)]

    def pos(t, pl):
        return local_block(t, mesh, pl if t.ndim == 2 else [
            Shard(0) if p == Shard(1) else Replicate() for p in pl])

    qrows = [Shard(1) if i in rows_q else p for i, p in enumerate(rows)]
    out = attention(local_block(q, mesh, place), local_block(k, mesh, kv),
                    local_block(v, mesh, kv), pos(qpos, qrows),
                    pos(kpos, rows), **kw)
    out = from_local_blocks(out, mesh, place, q.shape)
    # the query rows gathered again: a sequence split would reach the
    # flattened (B·S) rows of the projections as a strided sharding, whose
    # strategies DTensor's propagation searches for minutes on a 3-D mesh
    return out.redistribute(mesh, kv) if rows_q else out


def attention(q, k, v, qpos, kpos, *, window: int = FULL_WINDOW,
              softcap=None, block_kv: int = 1024, kv_valid_from: int = 0):
    """GQA attention over absolute positions.

    q (B, Sq, Hq, D); k, v (B, Sk, Hk, D), query head h reads kv head
    h // (Hq/Hk).  qpos (Sq,) or (B, Sq), kpos (Sk,) or (B, Sk) int
    positions; a key at a negative position (−1 marks pad and unwritten
    ring slots) is invalid, and so is one ``window`` or more positions
    behind the query, and so is a key below position ``kv_valid_from``
    (>= 0).  ``softcap`` caps the scores.  Short keys (or one query) take
    the direct branch; longer prefills the blocked online softmax, in
    float32 like the reference's.
    """
    if kv_valid_from < 0:
        raise ValueError(f"kv_valid_from must be >= 0 (negative positions "
                         f"mark invalid keys), got {kv_valid_from}")
    if kv_valid_from:
        kpos = torch.where(kpos >= kv_valid_from, kpos, -1)
    if hasattr(q, "placements"):
        out = _attention_on_shards(q, k, v, qpos, kpos, window=window,
                                   softcap=softcap, block_kv=block_kv)
        if out is not None:
            return out
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = float(np.float32(1.0 / np.sqrt(D)))
    qpos = qpos[None] if qpos.ndim == 1 else qpos
    kpos = kpos[None] if kpos.ndim == 1 else kpos
    qg = split_dim(q, 2, (Hk, G)).permute(0, 2, 3, 1, 4)     # (B,Hk,G,Sq,D)
    kg = k.permute(0, 2, 1, 3)[:, :, None]                   # (B,Hk,1,Sk,D)
    vg = v.permute(0, 2, 1, 3)[:, :, None]

    if Sk <= 2 * block_kv or Sq == 1:
        s = _scores(qg, kg, scale, softcap)
        m = _mask(qpos, kpos, window)[:, None, None]
        s = torch.where(m, s, NEG_INF)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
        o = local_matmul(p.to(v.dtype).to(torch.float64),
                         vg.to(torch.float64)).to(v.dtype)
    else:
        m_run = torch.full((B, Hk, G, Sq, 1), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((B, Hk, G, Sq, D), dtype=torch.float32,
                          device=q.device)
        for start in range(0, Sk, block_kv):
            sl = slice(start, min(Sk, start + block_kv))
            s = _scores(qg, kg[..., sl, :], scale, softcap)
            msk = _mask(qpos, kpos[:, sl], window)
            s = torch.where(msk[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vg[..., sl, :].to(
                torch.float32))
            m_run = m_new
        l_run = torch.where(l_run == 0.0, 1.0, l_run)
        o = (acc / l_run).to(v.dtype)
    # a mesh run: the reshape flattens (Hk, G), which DTensor refuses where
    # a mesh dim shards Hk unevenly (hymba's 5 KV heads over the pod axis)
    o = even_shards(o)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)


def update_cache_full(cache_k, cache_v, k, v, pos):
    """Write k, v (B, S, Hk, D) at slot ``pos`` of (B, smax, Hk, D) caches.
    Updates in place (the reference returns new arrays) and returns them.

    ``pos`` is an int, checked against the cache length, or a 0-d integer
    tensor on the caches' device, written through an indexed copy along
    the slot axis without reading it on the host (a captured decode step);
    its caller checks the bound before the step."""
    S = k.shape[1]
    if isinstance(pos, torch.Tensor):
        idx = pos.to(torch.int64) + torch.arange(S, device=cache_k.device)
        cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
        cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
        return cache_k, cache_v
    if pos + S > cache_k.shape[1]:
        raise ValueError(f"cache of {cache_k.shape[1]} slots cannot hold "
                         f"positions {pos}..{pos + S - 1}")
    if S == 1 and hasattr(cache_k, "placements"):
        # a mesh run (DTensor): the slot axis may be sharded, and a slice
        # write would gather the whole cache; select the slot instead
        hit = (torch.arange(cache_k.shape[1], device=cache_k.device)
               == pos)[None, :, None, None]
        cache_k.copy_(torch.where(hit, k.to(cache_k.dtype), cache_k))
        cache_v.copy_(torch.where(hit, v.to(cache_v.dtype), cache_v))
        return cache_k, cache_v
    cache_k[:, pos:pos + S] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + S] = v.to(cache_v.dtype)
    return cache_k, cache_v


def update_cache_ring(cache_k, cache_v, cache_pos, k, v, pos):
    """Ring-buffer write of one step's k, v (B, 1, Hk, D) at slot
    ``pos mod W`` of (B, W, Hk, D) caches, and ``pos`` into the (W,) slot
    positions (−1 where unwritten), in place; returns the three.  The
    bounded cache of a sliding-window layer: memory O(window), not
    O(sequence).  ``pos`` is an int or a 0-d integer tensor on the caches'
    device, never read on the host."""
    W = cache_k.shape[1]
    if isinstance(pos, torch.Tensor):
        slot = (pos.to(torch.int64) % W).reshape(1)
        cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
        cache_pos.index_copy_(0, slot, pos.to(cache_pos.dtype).reshape(1))
        return cache_k, cache_v, cache_pos
    slot = pos % W
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    cache_pos[slot] = pos
    return cache_k, cache_v, cache_pos


def paged_write(pool_k, pool_v, k, v, block_table, pos):
    """Write one token's k, v (B, Hk, D) per slot into the physical pools
    (n_phys, block, Hk, D), in place, at slot b's position ``pos[b]``:
    block ``block_table[b, pos // block]``, offset ``pos % block``.  A slot
    whose block is unmapped (−1) or past the table writes to the trash
    block 0, which is never read unmasked.  Every index is a device
    tensor; nothing is read on the host."""
    bs, nlog = pool_k.shape[1], block_table.shape[1]
    blk = pos // bs
    phys = torch.gather(block_table, 1, blk.clamp(max=nlog - 1)[:, None])
    phys = torch.where(blk < nlog, phys[:, 0], 0).clamp_min(0)
    off = pos % bs
    pool_k.index_put_((phys, off), k.to(pool_k.dtype))
    pool_v.index_put_((phys, off), v.to(pool_v.dtype))


def paged_gather(pool, block_table):
    """Each slot's logical view of a pool: (B, nlog·block, Hk, D), unmapped
    blocks read from the trash block (their keys are masked by
    `paged_kpos`)."""
    B, nlog = block_table.shape
    g = pool[block_table.clamp_min(0)]
    return g.reshape(B, nlog * pool.shape[1], *pool.shape[2:])


def paged_kpos(block_table, pos, block: int):
    """(B, nlog·block) key positions of the gathered view: the logical
    index where the block is mapped and the key is at or before the slot's
    position, −1 (invalid) elsewhere."""
    nlog = block_table.shape[1]
    kpad = torch.arange(nlog * block, dtype=torch.int64,
                        device=block_table.device)
    mapped = block_table[:, kpad // block] >= 0
    return torch.where(mapped & (kpad[None] <= pos[:, None]), kpad[None], -1)
