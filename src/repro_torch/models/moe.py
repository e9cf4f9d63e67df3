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
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .layers import Leaf, act_fn, dense_leaf, linear, materialize

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
    sums the shared expert's plain linears in float64 (`layers.linear`)."""
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

    # dispatch: one row of (E·(cap+1), d) per kept pick, spills to each
    # expert's overflow row cap
    e_flat = gate_idx.reshape(T * K)
    row = e_flat * (cap + 1) + torch.where(keep, pos, cap)
    xe = torch.zeros((E * (cap + 1), d), dtype=x.dtype, device=x.device)
    xe.index_copy_(0, row, xt[:, None].expand(T, K, d).reshape(T * K, d))
    xe = xe.reshape(E, cap + 1, d)[:, :cap]
    h = act(torch.bmm(xe, params["w_gate"]))
    if cfg.glu:
        h = h * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])                            # (E,cap,d)
    ye = torch.nn.functional.pad(ye, (0, 0, 0, 1))                 # overflow→0
    back = ye.reshape(E * (cap + 1), d)[row]                       # (T*K, d)
    back = (back * gates.reshape(T * K, 1).to(ye.dtype)).to(torch.float32)
    back = back.reshape(T, K, d)
    y = back[:, 0]
    for j in range(1, K):
        y = y + back[:, j]
    y = y.to(x.dtype)

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
