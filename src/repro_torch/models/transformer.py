"""The dense decoder stack, port of the dense family of
`repro/models/transformer.py`: parameters in the reference's layout,
prefill, one-token decode and the tied LM head.

Parameters are a nested dict with the reference's key names and stacked
``(n_blocks, …)`` leaves under ``params["blocks"]["sub0"]`` (one layer per
block); after `core/rns_tensor.encode_params` the linear leaves are
:class:`RNSTensor`s.  The reference scans over layers; here a Python loop
indexes each layer's slice (views, no copies).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig

from .layers import (apply_rope, attention, linear, linear_qkv, mlp_chain,
                     paged_gather, paged_kpos, paged_write, rms_norm, rope,
                     silu, update_cache_full)

__all__ = ["make_params", "init_cache", "prefill", "decode_step"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def make_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in the reference's layout and init distribution
    (linear weights N(0, 1/d_in), embedding N(0, 0.02²), norms zero), drawn
    from ``generator`` (which lives on ``device``)."""
    dtype = _dtype(cfg)
    L, d = cfg.n_blocks, cfg.d_model
    H, Hk, dh, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dtype)

    def dense(d_in, d_out):
        return normal((L, d_in, d_out), 1.0 / math.sqrt(d_in))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "blocks": {"sub0": {
            "norm_mix": zeros(L, d), "norm_mlp": zeros(L, d),
            "attn": {"wq": dense(d, H * dh), "wk": dense(d, Hk * dh),
                     "wv": dense(d, Hk * dh), "wo": dense(H * dh, d)},
            "mlp": {"w_gate": dense(d, f), "w_up": dense(d, f),
                    "w_down": dense(f, d)},
        }},
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size),
                                   1.0 / math.sqrt(d))
    return params


def _layer(node, b: int):
    """Layer ``b``'s slice of the stacked block parameters."""
    return {k: _layer(v, b) if isinstance(v, dict) else v[b]
            for k, v in node.items()}


def _embed(params, batch):
    """Token embedding + positions: ``arange(S) − pad[i]`` per sequence when
    ``batch["pad"]`` (left-pad counts) is given, negative at pad slots."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    h = params["embed"][tokens]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    pad = batch.get("pad")
    if pad is not None:
        positions = positions[None] - pad[:, None].to(torch.int32)
    return h, positions


def _qkv(p, x, spec):
    """Q, K and V projections: one stacked residue-in launch when the spec
    keeps activations in the residue domain, three linears otherwise."""
    ws = (p["attn"]["wq"], p["attn"]["wk"], p["attn"]["wv"])
    if spec.is_rns and spec.domain == "residue":
        return linear_qkv(x, ws, spec)
    return tuple(linear(x, w, spec) for w in ws)


def _attn_full(p, h, cfg: ModelConfig, positions):
    """Full-sequence attention sublayer; returns (out, (k, v))."""
    B, S, _ = h.shape
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rms_norm(h, p["norm_mix"], cfg.norm_eps)
    spec = cfg.linear_spec
    q, k, v = _qkv(p, x, spec)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hk, dh)
    v = v.reshape(B, S, Hk, dh)
    cos, sin = rope(positions, dh, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = attention(q, k, v, positions, positions, block_kv=cfg.attn_block_kv)
    return linear(o.reshape(B, S, H * dh), p["attn"]["wo"], spec), (k, v)


def _attn_decode(p, h, cfg: ModelConfig, pos, cache_k, cache_v,
                 positions=None, block_table=None):
    """One-token attention; writes this step's K/V at slot ``pos`` (an int
    or a 0-d integer tensor on the device, never read on the host).

    ``positions`` ((B,), optional) are the per-sequence real positions
    ``pos − pad[i]`` of a left-padded batch: they drive RoPE and the mask.

    ``block_table`` ((B, nlog) int64, optional) switches to the paged
    layout (`serve/paged_cache.py`): ``cache_k``/``cache_v`` are physical
    pools (n_phys, block, Hk, dh) shared by all slots, ``pos`` is the
    per-slot (B,) write position and ``positions`` equals it.  Each slot
    attends over its gathered logical view, nlog·block keys long; keys of
    unmapped blocks or past the slot's position are masked.
    """
    B = h.shape[0]
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rms_norm(h, p["norm_mix"], cfg.norm_eps)
    spec = cfg.linear_spec
    q, k, v = _qkv(p, x, spec)
    q = q.reshape(B, 1, H, dh)
    k = k.reshape(B, 1, Hk, dh)
    v = v.reshape(B, 1, Hk, dh)
    if positions is None:
        qpos = (pos.reshape(1).to(torch.int32)
                if isinstance(pos, torch.Tensor)
                else torch.full((1,), pos, dtype=torch.int32,
                                device=h.device))
    else:
        qpos = positions[:, None]
    cos, sin = rope(qpos, dh, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if block_table is not None:
        paged_write(cache_k, cache_v, k[:, 0], v[:, 0], block_table, pos)
        ck, cv = (paged_gather(c, block_table) for c in (cache_k, cache_v))
        kpos = paged_kpos(block_table, pos, cache_k.shape[1])
    else:
        ck, cv = update_cache_full(cache_k, cache_v, k, v, pos)
        kpos = torch.arange(ck.shape[1], dtype=torch.int32, device=h.device)
        if positions is not None:
            # slot-aligned padded indices → real positions; pad slots are −1
            kpos = kpos[None] - (pos - positions)[:, None]
            kpos = torch.where(kpos >= 0, kpos, -1)
    o = attention(q, ck.to(q.dtype), cv.to(q.dtype), qpos, kpos,
                  block_kv=cfg.attn_block_kv)
    return linear(o.reshape(B, 1, H * dh), p["attn"]["wo"], spec)


def _mlp(p, h, cfg: ModelConfig):
    x = rms_norm(h, p["norm_mlp"], cfg.norm_eps)
    spec = cfg.linear_spec
    if spec.is_rns and spec.domain == "residue":
        return mlp_chain(x, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"], spec, silu)
    g = silu(linear(x, p["mlp"]["w_gate"], spec))
    g = g * linear(x, p["mlp"]["w_up"], spec)
    return linear(g, p["mlp"]["w_down"], spec)


def _lm_head(cfg: ModelConfig, params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w).to(torch.float32)


def init_cache(cfg: ModelConfig, batch: int, smax: int, device):
    """Zeroed KV caches, stacked over layers: {"sub0": {"k", "v"}} of
    (n_blocks, B, smax, Hk, dh)."""
    shape = (cfg.n_blocks, batch, smax, cfg.num_kv_heads, cfg.head_dim)
    return {"sub0": {"k": torch.zeros(shape, dtype=_dtype(cfg),
                                      device=device),
                     "v": torch.zeros(shape, dtype=_dtype(cfg),
                                      device=device)}}


def prefill(cfg: ModelConfig, params, batch, smax: int, cache=None):
    """Forward over the prompt + cache build.

    ``batch``: {"tokens": (B, S) int, optional "pad": (B,) left-pad
    counts}.  Returns (last-token logits (B, vocab) float32, cache, S).
    Prompts are right-aligned, so the last position is always real; only
    it goes through the LM head.  ``cache`` (as from `init_cache`) is
    zeroed and written in place instead of allocating one, so a captured
    decode step keeps reading the buffers it was captured on.
    """
    h, positions = _embed(params, batch)
    B, S = h.shape[0], h.shape[1]
    if cache is None:
        cache = init_cache(cfg, B, smax, h.device)
    else:
        shape = (cfg.n_blocks, B, smax, cfg.num_kv_heads, cfg.head_dim)
        for t in cache["sub0"].values():
            if tuple(t.shape) != shape or t.device != h.device:
                raise ValueError(f"cache {tuple(t.shape)} on {t.device}, "
                                 f"prefill needs {shape} on {h.device}")
            t.zero_()
    ck, cv = cache["sub0"]["k"], cache["sub0"]["v"]
    blocks = params["blocks"]["sub0"]
    for b in range(cfg.n_blocks):
        p = _layer(blocks, b)
        o, (k, v) = _attn_full(p, h, cfg, positions)
        h = h + o
        h = h + _mlp(p, h, cfg)
        update_cache_full(ck[b], cv[b], k, v, 0)
    return _lm_head(cfg, params, h[:, -1:])[:, 0], cache, S


def decode_step(cfg: ModelConfig, params, cache, batch, pos,
                positions=None, block_tables=None):
    """One decode step: batch {"tokens": (B, 1)}, ``pos`` the shared cache
    slot (an int, or a 0-d integer tensor on the device that the step never
    reads on the host, as a captured step needs), ``positions`` ((B,),
    optional) the real per-sequence positions.  Returns (logits (B, vocab)
    float32, cache updated in place).

    ``block_tables`` ((B, nlog) int64, optional) selects the paged layout:
    ``cache`` holds the physical pools of `serve/paged_cache.
    init_paged_cache`, ``pos`` becomes the per-slot (B,) write position and
    the real positions default to it (scheduler slots carry no pad)."""
    h = params["embed"][batch["tokens"]]
    if block_tables is not None:
        pos = torch.as_tensor(pos, device=h.device).expand(h.shape[0])
        positions = pos if positions is None else positions
    elif isinstance(pos, torch.Tensor) and pos.ndim:
        raise ValueError("per-slot (B,) decode positions need block_tables "
                         "paging; the contiguous cache layout shares one "
                         "scalar write position")
    ck, cv = cache["sub0"]["k"], cache["sub0"]["v"]
    blocks = params["blocks"]["sub0"]
    for b in range(cfg.n_blocks):
        p = _layer(blocks, b)
        h = h + _attn_decode(p, h, cfg, pos, ck[b], cv[b], positions,
                             block_tables)
        h = h + _mlp(p, h, cfg)
    return _lm_head(cfg, params, h)[:, 0], cache
