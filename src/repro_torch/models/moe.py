"""Mixture-of-Experts block, port of `repro/models/moe.py`: top-k routing
with capacity dispatch, the experts as one batched matmul over the expert
axis, an optional shared expert and the Switch-style load-balancing loss.

Capacity is C = ceil(T·top_k / E · capacity_factor) for the T = B·S tokens
of the call, so what a token gets depends on its batchmates (dummy lanes and
pad tokens take slots too), as in the reference.  A kept token writes its
own slot of its expert's buffer; a token past capacity goes to the
overflow row, which is dropped.  Nothing here reads a tensor on the host
(no `nonzero`, no boolean indexing): the block runs inside a captured
decode step.  The combine adds a token's K expert outputs in pick order in
float32, the order of the reference's scatter-add, with no atomics.

On DTensors (a mesh run) the block runs on each rank's own blocks
(`_moe_on_shards`): its tokens (the batch's sharding), and the experts its
weights' expert sharding gives it.  Capacity, queue places and drops stay
global: a rank's picks are placed after the picks of the token shards
before it, read off an all-gather of each shard's per-expert counts.  Each
rank runs the capacity dispatch and the expert matmuls for the picks of
its own experts only, and an all-reduce over the expert ranks hands every
pick its one expert output, so the combine adds the same values in the
same order as the plain call.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .layers import (Leaf, act_fn, dense_leaf, linear, local_block,
                     local_weight, materialize)

__all__ = ["moe_param_spec", "make_moe_params", "moe_apply", "top_k"]


def moe_param_spec(cfg) -> Dict:
    """One MoE block's parameters in the reference's layout and init: the
    float32 router, the (E, d, f) / (E, f, d) expert weights and, with
    ``shared_expert``, one dense GLU expert."""
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": Leaf((d, e), "normal", 1.0 / math.sqrt(d), torch.float32),
        "w_gate": Leaf((e, d, f), "normal", 1.0 / math.sqrt(d)),
        "w_up": Leaf((e, d, f), "normal", 1.0 / math.sqrt(d)),
        "w_down": Leaf((e, f, d), "normal", 1.0 / math.sqrt(f)),
    }
    if cfg.shared_expert:
        p["shared"] = {"w_gate": dense_leaf(d, f), "w_up": dense_leaf(d, f),
                       "w_down": dense_leaf(f, d)}
    return p


def make_moe_params(cfg, generator: torch.Generator, device="cuda"):
    return materialize(moe_param_spec(cfg), generator, device,
                       getattr(torch, cfg.param_dtype))


def top_k(probs: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest in descending order,
    ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x: torch.Tensor, cfg, exact: bool = False):
    """x (B, S, d) → (y (B, S, d), aux loss (0-d float32)).  ``exact``
    sums the shared expert's plain linears in float64 (`layers.linear`).
    On DTensors it runs on each rank's blocks (`_moe_on_shards`)."""
    if any(hasattr(t, "placements") for t in (x, params["w_gate"])):
        return _moe_on_shards(params, x, cfg, exact)
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    cap = max(int(math.ceil(T * K / E * cfg.capacity_factor)), 1)
    act = act_fn(cfg.act)

    xt = x.reshape(T, d)
    logits = torch.matmul(xt.to(torch.float32), params["router"])  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # each pick's place in its expert's queue: the earlier picks of that
    # expert, in (token, pick) order
    sel = (gate_idx[..., None] == torch.arange(E, device=x.device)).long()
    flat = sel.reshape(T * K, E)
    pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1)          # (T*K,)
    keep = pos < cap
    gates = gate_vals * keep.reshape(T, K)

    back = _experts(params, xt, gate_idx, pos, keep, gates, cap, cfg)
    y = _combine(back.to(torch.float32), T, K, d).to(x.dtype)

    if cfg.shared_expert:
        sp, spec = params["shared"], cfg.linear_spec
        hs = act(linear(xt, sp["w_gate"], spec, exact))
        if cfg.glu:
            hs = hs * linear(xt, sp["w_up"], spec, exact)
        y = y + linear(hs, sp["w_down"], spec, exact)

    frac_tokens = sel.sum(1).to(torch.float32).mean(0)             # (E,)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y.reshape(B, S, d), aux


def _experts(params, xt, gate_idx, pos, keep, gates, cap: int, cfg,
             local=None):
    """The capacity dispatch, the experts and the gate: (T·K, d) in x's
    dtype, a pick's expert output times its gate (0 for a dropped pick).
    ``local`` = (first expert, expert count) of a rank that holds only those
    experts' weights: the other experts' picks go to the overflow row and
    come back 0."""
    T, K = gate_idx.shape
    d = xt.shape[-1]
    E = params["w_gate"].shape[0]
    act = act_fn(cfg.act)
    # dispatch: one row of (E·(cap+1), d) per kept pick, spills to each
    # expert's overflow row cap
    e_flat = gate_idx.reshape(T * K)
    slot = torch.where(keep, pos, cap)
    if local is not None:
        e_flat = e_flat - local[0]
        mine = (e_flat >= 0) & (e_flat < local[1])
        e_flat = torch.where(mine, e_flat, 0)
        slot = torch.where(mine, slot, cap)
    row = e_flat * (cap + 1) + slot
    xe = torch.zeros((E * (cap + 1), d), dtype=xt.dtype, device=xt.device)
    xe.index_copy_(0, row, xt[:, None].expand(T, K, d).reshape(T * K, d))
    xe = xe.reshape(E, cap + 1, d)[:, :cap]
    h = act(torch.bmm(xe, params["w_gate"]))
    if cfg.glu:
        h = h * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])                            # (E,cap,d)
    ye = torch.nn.functional.pad(ye, (0, 0, 0, 1))                 # overflow→0
    back = ye.reshape(E * (cap + 1), d)[row]                       # (T*K, d)
    return back * gates.reshape(T * K, 1).to(ye.dtype)


def _combine(back, T: int, K: int, d: int):
    """A token's K picks added in pick order (float32 in, as the
    reference's scatter-add)."""
    back = back.reshape(T, K, d)
    y = back[:, 0]
    for j in range(1, K):
        y = y + back[:, j]
    return y


def _index(mesh, dims) -> tuple:
    """(this rank's index, count) over mesh ``dims``, the first outermost
    (DTensor's order for one tensor dim sharded over several mesh dims)."""
    idx, n = 0, 1
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return idx, n


def _moe_on_shards(params, x, cfg, exact: bool):
    """`moe_apply` on DTensors: each rank routes its own tokens (x's batch
    sharding), places its picks in the global queues after the earlier
    token shards' (an all-gather of the (E,) counts), and runs the
    dispatch and the experts for its own experts (the expert weights'
    sharding); an all-reduce over the expert ranks brings every pick its
    one nonzero output.  Capacity, drops and the combine's order are the
    plain call's.  The load-balance loss sums each shard's counts and
    probabilities and all-reduces them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    cap = max(int(math.ceil(T * K / E * cfg.capacity_factor)), 1)
    mesh = next(t.device_mesh for t in (x, params["w_gate"])
                if isinstance(t, DTensor))
    nd = mesh.ndim

    def shard0(t):
        return [i for i, p in enumerate(getattr(t, "placements", ()))
                if isinstance(p, Shard) and p.dim == 0]

    exp = shard0(params["w_gate"])
    if E % _index(mesh, exp)[1]:
        exp = []
    tok, n = [], 1
    for i in shard0(x):
        if i not in exp and B % (n * mesh.size(i)) == 0:
            tok.append(i)
            n *= mesh.size(i)
    rows = [Shard(0) if i in tok else Replicate() for i in range(nd)]
    experts = [Shard(0) if i in exp else Replicate() for i in range(nd)]
    rep = [Replicate()] * nd
    xl = local_block(x, mesh, rows)
    w = {k: local_weight(params[k], mesh, experts, tok)
         for k in ("w_gate", "w_up", "w_down") if k in params}
    q, n_exp = _index(mesh, exp)
    r, _ = _index(mesh, tok)
    E_l = E // n_exp
    Tl = xl.shape[0] * S

    xt = xl.reshape(Tl, d)
    router = local_weight(params["router"], mesh, rep, tok)
    logits = torch.matmul(xt.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    sel = (gate_idx[..., None] == torch.arange(E, device=xt.device)).long()
    flat = sel.reshape(Tl * K, E)
    pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1)
    counts = flat.sum(0)                                           # (E,)
    if tok:
        every = DTensor.from_local(counts[None], mesh, rows,
                                   run_check=False).full_tensor()
        counts = every.sum(0)
        pos = pos + (every[:r].sum(0)[None, :] * flat).sum(-1)
    keep = pos < cap
    gates = gate_vals * keep.reshape(Tl, K)
    back = _experts(w, xt, gate_idx, pos, keep, gates, cap, cfg,
                    local=(q * E_l, E_l))
    if exp:
        # one expert rank holds each pick's output, the others 0: the sum
        # is that output exactly
        part = [Partial() if i in exp else p for i, p in enumerate(rows)]
        back = DTensor.from_local(back, mesh, part, run_check=False)
        back = back.redistribute(mesh, rows).to_local()
    y = _combine(back.to(torch.float32), Tl, K, d).to(x.dtype)
    y = DTensor.from_local(y.reshape(-1, S, d), mesh, rows, run_check=False)
    if cfg.shared_expert:
        sp, spec = params["shared"], cfg.linear_spec
        act = act_fn(cfg.act)
        xs = x.reshape(T, d)
        hs = act(linear(xs, sp["w_gate"], spec, exact))
        if cfg.glu:
            hs = hs * linear(xs, sp["w_up"], spec, exact)
        y = y + linear(hs, sp["w_down"], spec, exact).reshape(B, S, d)

    frac_tokens = counts.to(torch.float32) / T                     # (E,)
    psum = probs.sum(0)
    if tok:
        psum = DTensor.from_local(
            psum, mesh, [Partial() if i in tok else Replicate()
                         for i in range(nd)],
            run_check=False).redistribute(mesh, rep).to_local()
    aux = E * torch.sum(frac_tokens * (psum / T))
    return y, DTensor.from_local(aux, mesh, rep, run_check=False)
