"""Mamba2 mixer, port of `repro/models/ssm.py`: SSD (state-space duality)
in its chunked dual form for prefill and the one-token recurrence for
decode (Dao & Gu, arXiv:2405.21060), as mamba2-1.3b and hymba-1.5b use it.

  prefill — the sequence splits into chunks of Q = ``ssm_chunk``; inside a
    chunk the output is a decay-weighted attention-like product, across
    chunks a small recurrence over the (B, H, N, P) state runs.  The
    reference scans the chunks with `lax.scan`; here a Python loop over
    the chunks does the same in float32.
  decode — S_t = exp(dt_t·A)·S_{t−1} + dt_t·B_t ⊗ x_t, y_t = C_t·S_t + D∘x_t.

One B/C group broadcast over the heads, a depthwise causal conv (width
``ssm_conv``) over the (x, B, C) streams and a gated output norm.  The
projections are plain matmuls in the parameter dtype, as in the reference
(the SSM does not take the RNS datapath); ``exact`` sums them in float64
(`layers.matmul_exact`), as the prefill asks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .layers import (Leaf, dense_leaf, even_shards, from_local_blocks,
                     local_block, local_weight, materialize, matmul, rms_norm,
                     silu)

__all__ = ["ssm_param_spec", "make_ssm_params", "ssm_apply",
           "ssm_decode_step", "init_ssm_cache"]


def ssm_param_spec(cfg) -> Dict[str, Leaf]:
    """One SSM mixer's parameters in the reference's layout and init."""
    d, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    conv_dim = di + 2 * N                      # x plus the B and C streams
    f32 = torch.float32
    return {
        # in_proj emits [z (gate), x, B, C, dt]
        "in_proj": dense_leaf(d, 2 * di + 2 * N + H),
        "conv_w": Leaf((cfg.ssm_conv, conv_dim), "normal", 0.1),
        "conv_b": Leaf((conv_dim,)),
        "A_log": Leaf((H,), "log_arange", dtype=f32),
        "D": Leaf((H,), "ones", dtype=f32),
        "dt_bias": Leaf((H,), dtype=f32),
        "norm": Leaf((di,)),
        "out_proj": dense_leaf(di, d),
    }


def make_ssm_params(cfg, generator: torch.Generator, device="cuda"):
    return materialize(ssm_param_spec(cfg), generator, device,
                       getattr(torch, cfg.param_dtype))


def _split_proj(cfg, proj):
    di, N = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * N],
            proj[..., 2 * di + 2 * N:])


def _conv(xBC, w, b, state=None):
    """Depthwise causal conv along S with SiLU.  xBC (B, S, C); ``state``
    (B, k−1, C) is the previous inputs (decode), else zeros lead."""
    if hasattr(xBC, "placements"):
        return _conv_on_shards(xBC, w, b, state)
    k = w.shape[0]
    if state is not None:
        xBC = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    else:
        xBC = torch.nn.functional.pad(xBC, (0, 0, k - 1, 0))
    S = xBC.shape[1] - (k - 1)
    out = xBC[:, :S] * w[0]
    for j in range(1, k):
        out = out + xBC[:, j:j + S] * w[j]
    return silu(out + b)


def _conv_on_shards(xBC, w, b, state):
    """`_conv` on DTensors (a mesh run), on each rank's block: the batch and
    the channels keep their sharding, a sharded S is gathered and a
    partial sum reduced (the collectives the trace prices), and the
    weights are sliced to the block's channels.  DTensor's own pad
    (torch 2.11) fails to redistribute, and the conv is depthwise."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = xBC.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim % 3 != 1 else Replicate()
          for p in xBC.placements]
    chan = [isinstance(p, Shard) and p.dim % 3 == 2 for p in pl]
    rows = [i for i, p in enumerate(pl) if isinstance(p, Shard)
            and p.dim % 3 == 0]

    out = _conv(local_block(xBC, mesh, pl),
                local_weight(w, mesh, [Shard(1) if c else Replicate()
                                       for c in chan], rows),
                local_weight(b, mesh, [Shard(0) if c else Replicate()
                                       for c in chan], rows),
                None if state is None else local_block(state, mesh, pl))
    return from_local_blocks(out, mesh, pl, xBC.shape)


def _gates(params, dt):
    """(dt, dt·A) in float32: dt = softplus(dt + dt_bias), A = −exp(A_log)."""
    A = -torch.exp(params["A_log"])
    x = dt.to(torch.float32) + params["dt_bias"]
    dt = torch.logaddexp(x, torch.zeros_like(x))    # jax.nn.softplus
    return dt, dt * A


def _mask_ssm_inputs(xBC, valid):
    """Zero the (x, B, C) streams at invalid (left-pad) slots.  Pads are a
    prefix, so the causal conv sees the zeros an unpadded sequence's left
    padding gives; dt and dA are masked after `_gates` as well, which makes
    a pad step an identity step of the recurrence."""
    if valid is None:
        return xBC
    return torch.where(valid[..., None], xBC, torch.zeros_like(xBC))


def _streams(params, x, cfg, valid, exact=False):
    """The projection, the masked raw (x, B, C) streams, their conv and the
    masked gates: (z, xBC_raw, xBC, dt, dA)."""
    z, xBC_raw, dt = _split_proj(cfg, matmul(x, params["in_proj"], exact))
    xBC_raw = _mask_ssm_inputs(xBC_raw, valid)
    xBC = _conv(xBC_raw, params["conv_w"], params["conv_b"])
    dt, dA = _gates(params, dt)
    if valid is not None:
        v32 = valid[..., None].to(torch.float32)
        dt, dA = dt * v32, dA * v32
    return z, xBC_raw, xBC, dt, dA


def _out(params, y, z, cfg, dtype, exact=False):
    """Gated RMSNorm and the output projection of (B, S, d_inner) y."""
    y = y.to(dtype) * silu(z.to(torch.float32)).to(dtype)
    return matmul(rms_norm(y, params["norm"], cfg.norm_eps),
                  params["out_proj"], exact)


def _cumsum_q(t):
    """torch.cumsum over dim 1; on DTensors (a mesh run) on each rank's
    block, dim 1 gathered: torch 2.11's DTensor has no rule for the flip
    in its gradient."""
    if not hasattr(t, "placements"):
        return torch.cumsum(t, dim=1)
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim % t.ndim != 1 else Replicate()
          for p in t.placements]
    return from_local_blocks(torch.cumsum(local_block(t, mesh, pl), dim=1),
                             mesh, pl, t.shape)


def _ssd(params, x, cfg, valid=None, exact=False):
    """Chunked SSD forward; returns (out (B, S, d_model), the streams)."""
    B, S, _ = x.shape
    H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must be divisible by ssm chunk {Q}")
    streams = z, _, xBC, dt, dA = _streams(params, x, cfg, valid, exact)
    xi = xBC[..., :di].reshape(B, S, H, P)
    xf = xi.to(torch.float32)
    Bv = xBC[..., di:di + N].to(torch.float32)
    Cv = xBC[..., di + N:].to(torch.float32)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    s = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq, dtq = xf[:, sl], Bv[:, sl], Cv[:, sl], dt[:, sl]
        cum = _cumsum_q(dA[:, sl])                               # (B,Q,H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B,Q,Q,H)
        decay = torch.where(tril[None, :, :, None], torch.exp(diff), 0.0)
        cb = torch.einsum("bqn,btn->bqt", Cq, Bq)
        w = decay * cb[..., None] * dtq[:, None, :, :]
        y = torch.einsum("bqth,bthp->bqhp", w, xq)
        # the incoming state's contribution, then the state passed on
        y = y + torch.einsum("bqn,bqh,bhnp->bqhp", Cq, torch.exp(cum), s)
        tail = torch.exp(cum[:, -1:, :] - cum)
        upd = torch.einsum("bth,btn,bthp->bhnp", tail * dtq, Bq, xq)
        s = s * torch.exp(cum[:, -1, :])[..., None, None] + upd
        ys.append(y)
    y = torch.cat(ys, dim=1) + params["D"][None, None, :, None] * xf
    return (_out(params, y.reshape(B, S, di), z, cfg, x.dtype, exact),
            streams)


def ssm_apply(params, x, cfg, valid=None, exact=False):
    """Chunked SSD forward: x (B, S, d_model) → (B, S, d_model).

    ``valid`` ((B, S) bool, optional) marks the real slots of a left-padded
    ragged batch: pad slots add nothing to the recurrence (their own output
    rows are not meaningful).  ``exact`` sums the projections in float64
    (`layers.matmul_exact`)."""
    return _ssd(params, x, cfg, valid, exact)[0]


def init_ssm_cache(cfg, batch: int, device, dtype=None) -> Dict[str, Any]:
    """Zeroed decode state: the (B, H, N, P) float32 SSM state and the
    (B, k−1, conv_dim) conv inputs."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N
    return {"state": torch.zeros((batch, H, N, P), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def ssm_decode_step(params, x, cache, cfg):
    """One-token recurrence: x (B, 1, d) → (y (B, 1, d), cache), the cache's
    state and conv inputs updated in place."""
    B = x.shape[0]
    H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, xBC, dt = _split_proj(cfg, torch.matmul(x, params["in_proj"]))
    conv = cache["conv"]
    new_conv = torch.cat([conv[:, 1:], xBC.to(conv.dtype)], dim=1)
    xBC = _conv(xBC, params["conv_w"], params["conv_b"], state=conv)
    xi = xBC[:, 0, :di].reshape(B, H, P).to(torch.float32)
    Bv = xBC[:, 0, di:di + N].to(torch.float32)
    Cv = xBC[:, 0, di + N:].to(torch.float32)
    dt, dA = _gates(params, dt[:, 0])                             # (B,H)
    s_new = (cache["state"] * torch.exp(dA)[..., None, None]
             + torch.einsum("bh,bn,bhp->bhnp", dt, Bv, xi))
    if hasattr(s_new, "placements"):
        # a mesh run (DTensor): the contraction over the state dim as a
        # product and a sum, which keep the state's sharding; einsum's bmm
        # flattens (heads, P), and DTensor refuses that view where a mesh
        # dim shards heads it does not divide (hymba's 50 over 16)
        y = (Cv[:, None, :, None] * s_new).sum(2)
        y = even_shards(y + params["D"][None, :, None] * xi)
    else:
        y = torch.einsum("bn,bhnp->bhp", Cv, s_new)
        y = y + params["D"][None, :, None] * xi
    cache["state"].copy_(s_new)
    conv.copy_(new_conv)
    return _out(params, y.reshape(B, 1, di), z, cfg, x.dtype), cache
