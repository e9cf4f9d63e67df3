"""The decoder stack, port of `repro/models/transformer.py`: parameters in
the reference's layout, prefill, one-token decode and the LM head, for
every family the reference serves.

Per-layer structure follows the reference:

  * mixers — attention ("attn"), Mamba2 SSD ("ssm", attention "none") or
    both in parallel on the same normed input ("hybrid", hymba: each
    branch RMS-normed, then h + 0.5·(attn + ssm));
  * windows — full causal, sliding window (every layer but
    ``global_layers``) or gemma2's local/global alternation
    (`window_array`); a layer whose window is shorter than the cache keeps
    a ring buffer of ``window`` slots;
  * MLPs — a GLU or plain MLP (silu or tanh-gelu), a MoE block, or none
    (mamba2); llama4 alternates dense and MoE layers, so a block holds two
    layers, ``sub0`` and ``sub1``.

Parameters are a nested dict with the reference's key names and stacked
``(n_blocks, …)`` leaves under ``params["blocks"]["sub{i}"]``; after
`core/rns_tensor.encode_params` the linear leaves are :class:`RNSTensor`s.
Caches use the reference's layout too: ``cache["sub{i}"]`` is stacked over
blocks when every block's cache has the same shapes, else
``{"per_block": [one dict a block]}`` (hymba's three global layers among
its ring layers).  The reference scans over layers; here a Python loop
indexes each layer's slice (views, no copies) and updates its cache in
place, so a captured decode step reads and writes persistent buffers.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .layers import (FULL_WINDOW, Leaf, act_fn, apply_rope, attention,
                     dense_leaf, embed_rows, linear, linear_qkv, lookup,
                     materialize, matmul, merge_heads, mlp_chain, paged_gather,
                     paged_kpos, paged_write, rms_norm, rope, sinusoidal,
                     split_dim, update_cache_full, update_cache_ring)
from .moe import moe_apply, moe_param_spec
from .ssm import (_ssd, init_ssm_cache, ssm_apply, ssm_decode_step,
                  ssm_param_spec)

__all__ = ["make_params", "param_spec", "init_cache", "reset_cache",
           "cache_leaves", "forward", "prefill", "decode_step",
           "window_array", "count_params", "active_params"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _mixer_kind(cfg: ModelConfig) -> str:
    if cfg.hybrid:
        return "hybrid"
    if cfg.ssm and cfg.attention == "none":
        return "ssm"
    return "attn"


# ------------------------------------------------------------------ params --
def _layer_spec(cfg: ModelConfig, layer: int) -> Dict[str, Any]:
    """One layer's parameters (as `_make_layer_params` of the reference)."""
    d = cfg.d_model
    H, Hk, dh, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    p: Dict[str, Any] = {"norm_mix": Leaf((d,)), "norm_mlp": Leaf((d,))}
    if cfg.post_norm:
        p["norm_mix_post"] = Leaf((d,))
        p["norm_mlp_post"] = Leaf((d,))
    kind = _mixer_kind(cfg)
    if kind in ("attn", "hybrid"):
        p["attn"] = {"wq": dense_leaf(d, H * dh), "wk": dense_leaf(d, Hk * dh),
                     "wv": dense_leaf(d, Hk * dh), "wo": dense_leaf(H * dh, d)}
        if cfg.qk_norm:
            p["attn"]["q_norm"] = Leaf((dh,))
            p["attn"]["k_norm"] = Leaf((dh,))
    if kind in ("ssm", "hybrid"):
        p["ssm"] = ssm_param_spec(cfg)
    if kind == "hybrid":
        p["norm_attn_out"] = Leaf((d,))
        p["norm_ssm_out"] = Leaf((d,))
    if cfg.mlp_kind(layer) == "moe":
        p["moe"] = moe_param_spec(cfg)
    elif f > 0:
        p["mlp"] = {"w_gate": dense_leaf(d, f), "w_up": dense_leaf(d, f),
                    "w_down": dense_leaf(f, d)}
    else:                      # attention-free mamba2: mixer-only layers
        del p["norm_mlp"]
        p.pop("norm_mlp_post", None)
    return p


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """Every parameter as a :class:`Leaf`; the block leaves lack their
    leading ``n_blocks`` axis."""
    spec = {"embed": Leaf((cfg.vocab_size, cfg.d_model), "normal", 0.02),
            "blocks": {f"sub{i}": _layer_spec(cfg, i)
                       for i in range(cfg.layers_per_block)},
            "final_norm": Leaf((cfg.d_model,))}
    if not cfg.tie_embeddings:
        spec["lm_head"] = dense_leaf(cfg.d_model, cfg.vocab_size)
    return spec


def make_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in the reference's layout and init distribution
    (linear weights N(0, 1/d_in), embedding N(0, 0.02²), norms zero, the
    SSM's A_log = log(1..H), D = 1), drawn from ``generator`` (which lives
    on ``device``)."""
    dtype = _dtype(cfg)
    out = {}
    for k, v in param_spec(cfg).items():
        lead = (cfg.n_blocks,) if k == "blocks" else ()
        out[k] = materialize({k: v}, generator, device, dtype, lead)[k]
    return out


def _leaves(node, lead=()):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, lead)
        else:
            yield lead + tuple(v.shape)


def count_params(cfg: ModelConfig) -> int:
    """Total parameter count (exact, from the shapes)."""
    spec = param_spec(cfg)
    blocks = spec.pop("blocks")
    return (sum(math.prod(s) for s in _leaves(spec))
            + sum(math.prod(s) for s in _leaves(blocks, (cfg.n_blocks,))))


def active_params(cfg: ModelConfig) -> int:
    """Parameters a token uses (MoE: the top_k experts, the shared expert
    and the backbone)."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = (3 if cfg.glu else 2) * cfg.d_model * f
    n_moe = sum(1 for l in range(cfg.num_layers) if cfg.mlp_kind(l) == "moe")
    return total - n_moe * (cfg.num_experts - cfg.top_k) * per_expert


def window_array(cfg: ModelConfig, seq_len: int) -> np.ndarray:
    """(n_blocks, layers_per_block) int32 effective windows."""
    out = np.zeros((cfg.n_blocks, cfg.layers_per_block), np.int32)
    for b in range(cfg.n_blocks):
        for i in range(cfg.layers_per_block):
            w = cfg.window_for_layer(b * cfg.layers_per_block + i, seq_len)
            out[b, i] = min(w, FULL_WINDOW)
    return out


def _window(cfg: ModelConfig, layer: int) -> int:
    return min(cfg.window_for_layer(layer, FULL_WINDOW), FULL_WINDOW)


def _map(fn, node):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in node.items()}


def _layer(node, b: int):
    """Layer ``b``'s slice of the stacked block parameters."""
    return _map(lambda v: v[b], node)


# --------------------------------------------------------------- sublayers --
def _qkv(p, x, spec, exact=False):
    """Q, K and V projections: one stacked residue-in launch when the spec
    keeps activations in the residue domain, three linears otherwise
    (``exact``: see `layers.linear`)."""
    ws = (p["attn"]["wq"], p["attn"]["wk"], p["attn"]["wv"])
    if spec.is_rns and spec.domain == "residue":
        return linear_qkv(x, ws, spec)
    return tuple(linear(x, w, spec, exact) for w in ws)


def _project(p, h, cfg: ModelConfig, qpos, exact=False):
    """Normed input → q (B, S, H, dh), k, v (B, S, Hk, dh), with the
    optional per-head q/k norms and RoPE at ``qpos``."""
    B, S, _ = h.shape
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rms_norm(h, p["norm_mix"], cfg.norm_eps)
    q, k, v = _qkv(p, x, cfg.linear_spec, exact)
    q = split_dim(q, -1, (H, dh))
    k = split_dim(k, -1, (Hk, dh))
    v = split_dim(v, -1, (Hk, dh))
    if cfg.qk_norm:
        q = rms_norm(q, p["attn"]["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["attn"]["k_norm"], cfg.norm_eps)
    if cfg.pos == "rope":
        cos, sin = rope(qpos, dh, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _attn_out(p, o, cfg: ModelConfig, exact=False):
    B, S = o.shape[:2]
    o = linear(o.reshape(B, S, -1), p["attn"]["wo"], cfg.linear_spec, exact)
    if cfg.post_norm:
        o = rms_norm(o, p["norm_mix_post"], cfg.norm_eps)
    return o


def _attn_full(p, h, cfg: ModelConfig, window: int, positions,
               exact=False):
    """Full-sequence attention sublayer; returns (out, (k, v)).  ``exact``
    sums plain linears in float64 (`layers.linear`), as the prefill asks."""
    q, k, v = _project(p, h, cfg, positions, exact)
    o = attention(q, k, v, positions, positions, window=window,
                  softcap=cfg.softcap_attn, block_kv=cfg.attn_block_kv)
    return _attn_out(p, o, cfg, exact), (k, v)


_RING_PAGED = ("paged decode does not support ring (SWA) caches: the ring's "
               "cache_pos is one (W,) vector shared across the batch, so "
               "per-slot write positions have nowhere to live — serve "
               "SWA/hybrid-SWA architectures through the static engine")


def _attn_decode(p, h, cfg: ModelConfig, window: int, pos, cache,
                 positions=None, block_table=None):
    """One-token attention; writes this step's K/V into ``cache`` at slot
    ``pos`` (an int or a 0-d integer tensor on the device, never read on
    the host): the full cache's slot ``pos``, or a ring's ``pos mod W``.

    ``positions`` ((B,), optional) are the per-sequence real positions
    ``pos − pad[i]`` of a left-padded batch: they drive RoPE, the window and
    the mask.

    ``block_table`` ((B, nlog) int64, optional) switches to the paged
    layout (`serve/paged_cache.py`): ``cache["k"]``/``["v"]`` are physical
    pools (n_phys, block, Hk, dh) shared by all slots, ``pos`` is the
    per-slot (B,) write position and ``positions`` equals it.  Each slot
    attends over its gathered logical view, nlog·block keys long; keys of
    unmapped blocks or past the slot's position are masked.
    """
    if positions is None:
        qpos = (pos.reshape(1).to(torch.int32)
                if isinstance(pos, torch.Tensor)
                else torch.full((1,), pos, dtype=torch.int32,
                                device=h.device))
    else:
        qpos = positions[:, None]
    q, k, v = _project(p, h, cfg, qpos)
    if block_table is not None:
        if "pos" in cache:
            raise ValueError(_RING_PAGED)
        paged_write(cache["k"], cache["v"], k[:, 0], v[:, 0], block_table,
                    pos)
        ck, cv = (paged_gather(cache[n], block_table) for n in ("k", "v"))
        kpos = paged_kpos(block_table, pos, cache["k"].shape[1])
    else:
        if "pos" in cache:                  # ring buffer (sliding window)
            ck, cv, kpad = update_cache_ring(cache["k"], cache["v"],
                                             cache["pos"], k, v, pos)
        else:
            ck, cv = update_cache_full(cache["k"], cache["v"], k, v, pos)
            kpad = torch.arange(ck.shape[1], dtype=torch.int32,
                                device=h.device)
        kpos = kpad
        if positions is not None:
            # slot-aligned padded indices → real positions; pad slots and
            # unwritten ring slots are −1
            kpos = kpad[None] - (pos - positions)[:, None]
            kpos = torch.where((kpad[None] >= 0) & (kpos >= 0), kpos, -1)
    o = attention(q, ck.to(q.dtype), cv.to(q.dtype), qpos, kpos,
                  window=window, softcap=cfg.softcap_attn,
                  block_kv=cfg.attn_block_kv)
    return _attn_out(p, o, cfg)


def _call(fn, *args):
    return fn(*args)


def _mlp_hidden(p, h, cfg: ModelConfig, exact=False):
    """The GLU (or plain) MLP up to the down projection's input."""
    x = rms_norm(h, p["norm_mlp"], cfg.norm_eps)
    spec, act, w = cfg.linear_spec, act_fn(cfg.act), p["mlp"]
    g = act(linear(x, w["w_gate"], spec, exact))
    if cfg.glu:
        g = g * linear(x, w["w_up"], spec, exact)
    return g


def _mlp(p, h, cfg: ModelConfig, exact=False, ck=_call):
    """The MLP sublayer (its branch, no residual); ``ck`` runs the part
    before the down projection (`_layer_remat`'s checkpoint)."""
    spec, w = cfg.linear_spec, p["mlp"]
    if spec.is_rns and spec.domain == "residue" and cfg.glu:
        x = rms_norm(h, p["norm_mlp"], cfg.norm_eps)
        o = mlp_chain(x, w["w_gate"], w["w_up"], w["w_down"], spec,
                      act_fn(cfg.act))
    else:
        o = linear(ck(_mlp_hidden, p, h, cfg, exact), w["w_down"], spec,
                   exact)
    if cfg.post_norm:
        o = rms_norm(o, p["norm_mlp_post"], cfg.norm_eps)
    return o


def _moe(p, h, cfg: ModelConfig, exact=False):
    x = rms_norm(h, p["norm_mlp"], cfg.norm_eps)
    o, aux = moe_apply(p["moe"], x, cfg, exact)
    if cfg.post_norm:
        o = rms_norm(o, p["norm_mlp_post"], cfg.norm_eps)
    return o, aux


def _ffn_branch(p, h, cfg: ModelConfig, layer_in_block: int, exact=False,
                ck=_call):
    """The layer's MLP or MoE branch without its residual: (out, MoE
    load-balance aux), or (None, None) for a mixer-only layer.  ``ck`` runs
    the MoE block, or the MLP up to its down projection."""
    if cfg.mlp_kind(layer_in_block) == "moe":
        return ck(_moe, p, h, cfg, exact)
    if cfg.d_ff > 0:
        return _mlp(p, h, cfg, exact, ck), None
    return None, None


def _ffn(p, h, cfg: ModelConfig, layer_in_block: int, exact=False):
    """The layer's MLP or MoE sublayer, residual added."""
    o, _ = _ffn_branch(p, h, cfg, layer_in_block, exact)
    return h if o is None else h + o


def _fuse(p, h, oa, os_, cfg: ModelConfig):
    """Hymba's fusion of the parallel branches: h + 0.5·(rms(oa) + rms(os))."""
    oa = rms_norm(oa, p["norm_attn_out"], cfg.norm_eps)
    os_ = rms_norm(os_, p["norm_ssm_out"], cfg.norm_eps)
    return h + 0.5 * (oa + os_)


def _ssm_prefill(ssm_params, x, cfg: ModelConfig, valid=None, exact=True):
    """SSD forward that also returns the decode cache: the state after the
    last token and the conv's last ``ssm_conv − 1`` inputs.  ``valid``
    ((B, S) bool) zeroes pad inputs as `ssm_apply` does, so the cache
    holds no pad contribution.  The state is the reference's one-pass
    sum over the whole sequence, taken in float64 (its terms and length
    include the pad) and rounded once; ``exact`` sums the projections in
    float64 too (`layers.matmul_exact`)."""
    B, S, _ = x.shape
    H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    y, (_, xBC_raw, xBC, dt, dA) = _ssd(ssm_params, x, cfg, valid, exact)
    f64 = torch.float64
    xi = xBC[..., :di].reshape(B, S, H, P).to(f64)
    Bv = xBC[..., di:di + N].to(f64)
    cum = torch.cumsum(dA.to(f64), dim=1)
    tail = torch.exp(cum[:, -1:, :] - cum)
    state = torch.einsum("bth,btn,bthp->bhnp", tail * dt.to(f64), Bv,
                         xi).to(torch.float32)
    conv = xBC_raw[:, S - (cfg.ssm_conv - 1):].to(_dtype(cfg))
    return y, {"state": state, "conv": conv}


def _embed(cfg: ModelConfig, params, batch):
    """Token (or embedding) frontend + positions: ``arange(S) − pad[i]`` per
    sequence when ``batch["pad"]`` (left-pad counts) is given, negative at
    pad slots; sinusoidal position embeddings added where the config asks."""
    if cfg.frontend == "embeddings":
        h = batch["embeds"].to(_dtype(cfg))
    else:
        h = embed_rows(params["embed"], batch["tokens"])
    S = h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    pad = batch.get("pad")
    if pad is not None:
        positions = positions[None] - pad[:, None].to(torch.int32)
    if cfg.pos == "sinusoidal":
        pe = sinusoidal(positions, cfg.d_model)
        h = h + (pe[None] if positions.ndim == 1 else pe).to(h.dtype)
    return h, positions


def _lm_head(cfg: ModelConfig, params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # a mesh run (DTensor): the product keeps the head's vocab sharding
    # (`layers.tp_matmul`)
    logits = matmul(h, w).to(torch.float32)
    if cfg.softcap_final is not None:
        logits = torch.tanh(logits / cfg.softcap_final) * cfg.softcap_final
    return logits


# ------------------------------------------------------------------ forward -
def _attn_core(p, h, cfg: ModelConfig, window: int, positions):
    """Attention over the whole sequence up to the output projection's
    input (B, S, H·dh)."""
    q, k, v = _project(p, h, cfg, positions)
    o = attention(q, k, v, positions, positions, window=window,
                  softcap=cfg.softcap_attn, block_kv=cfg.attn_block_kv)
    return merge_heads(o)


def _ssm_branch(p, h, cfg: ModelConfig, valid):
    o = ssm_apply(p["ssm"], rms_norm(h, p["norm_mix"], cfg.norm_eps), cfg,
                  valid)
    if cfg.post_norm:
        o = rms_norm(o, p["norm_mix_post"], cfg.norm_eps)
    return o


def _mix(p, h, cfg: ModelConfig, window: int, positions, valid, ck=_call):
    """``h`` plus the mixer's branch over the whole sequence: attention, the
    SSM, or hymba's fusion (`_fuse`).  ``ck`` runs the attention up to its
    output projection, and the SSM branch."""
    kind = _mixer_kind(cfg)
    if kind in ("attn", "hybrid"):
        oa = _attn_out(p, ck(_attn_core, p, h, cfg, window, positions), cfg)
        if kind == "attn":
            return h + oa
    os_ = ck(_ssm_branch, p, h, cfg, valid)
    return h + os_ if kind == "ssm" else _fuse(p, h, oa, os_, cfg)


def _layer_full(p, h, cfg: ModelConfig, i: int, window: int, positions,
                valid, ck=_call):
    """One layer over the whole sequence: (h out, MoE aux or None)."""
    h = _mix(p, h, cfg, window, positions, valid, ck)
    o, aux = _ffn_branch(p, h, cfg, i, ck=ck)
    return (h if o is None else h + o), aux


def _checkpoint(fn, *args):
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _layer_remat(p, h, cfg: ModelConfig, i: int, window: int, positions,
                 valid):
    """`_layer_full` under the config's remat policy.  "full" keeps the
    layer's input and recomputes the whole layer in the backward; "save_ar"
    recomputes each branch but its row-parallel output projections (`wo`,
    `w_down`), which run outside the recompute, so their results are never
    recomputed (the reference keeps them by name, ``mixer_out`` and
    ``mlp_out``, for the same end); an SSM branch and a MoE block are
    recomputed whole; "none" (or ``remat=False``) keeps every
    activation."""
    policy = cfg.remat_policy if cfg.remat else "none"
    if policy not in ("full", "save_ar", "none"):
        raise ValueError(f"remat_policy must be full, save_ar or none, got "
                         f"{cfg.remat_policy!r}")
    args = (p, h, cfg, i, window, positions, valid)
    if policy == "full":
        return _checkpoint(_layer_full, *args)
    return _layer_full(*args, ck=_checkpoint if policy == "save_ar"
                       else _call)


def forward(cfg: ModelConfig, params, batch):
    """Full-sequence logits (B, S, vocab) float32 and the MoE load-balance
    aux: the mean over blocks of each block's summed layer auxes (0 without
    MoE).  ``batch`` as `prefill` takes it.  Every layer runs under the
    config's remat policy (`_layer_remat`); the plain (bf16) linears take
    the library GEMM."""
    h, positions = _embed(cfg, params, batch)
    valid = positions >= 0 if positions.ndim == 2 else None
    auxes = []
    for b in range(cfg.n_blocks):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(cfg.layers_per_block):
            layer = b * cfg.layers_per_block + i
            h, a = _layer_remat(_layer(params["blocks"][f"sub{i}"], b), h,
                                cfg, i, _window(cfg, layer), positions, valid)
            if a is not None:
                aux = aux + a
        auxes.append(aux)
    return _lm_head(cfg, params, h), torch.stack(auxes).mean()


# ------------------------------------------------------------------ caches --
def _layer_cache(cfg: ModelConfig, layer: int, batch: int, smax: int,
                 device) -> Dict[str, Any]:
    """One layer's zeroed decode cache: K/V of ``smax`` slots, or a ring of
    ``window`` slots with its (w,) positions (−1: unwritten) when the
    layer's window is shorter; the SSM state and conv inputs."""
    kind, dtype = _mixer_kind(cfg), _dtype(cfg)
    out: Dict[str, Any] = {}
    if kind in ("attn", "hybrid"):
        w = cfg.window_for_layer(layer, smax)
        n = w if w < smax else smax
        shape = (batch, n, cfg.num_kv_heads, cfg.head_dim)
        out["k"] = torch.zeros(shape, dtype=dtype, device=device)
        out["v"] = torch.zeros(shape, dtype=dtype, device=device)
        if w < smax:
            out["pos"] = torch.full((w,), -1, dtype=torch.int32,
                                    device=device)
    if kind in ("ssm", "hybrid"):
        out["ssm"] = init_ssm_cache(cfg, batch, device, dtype)
    return out


def _shapes(node):
    return _map(lambda t: tuple(t.shape), node)


def init_cache(cfg: ModelConfig, batch: int, smax: int, device):
    """Zeroed decode caches: ``{"sub{i}": ...}``, each column stacked over
    blocks ((n_blocks, …) leaves) when its blocks' caches have one shape,
    else ``{"per_block": [...]}``."""
    out = {}
    for i in range(cfg.layers_per_block):
        layers = [b * cfg.layers_per_block + i for b in range(cfg.n_blocks)]
        metas = [_layer_cache(cfg, l, batch, smax, "meta") for l in layers]
        if all(_shapes(m) == _shapes(metas[0]) for m in metas):
            # the int32 leaf is a ring's positions, −1 while unwritten
            out[f"sub{i}"] = _map(lambda t: torch.full(
                (cfg.n_blocks, *t.shape), -1 if t.dtype == torch.int32
                else 0, dtype=t.dtype, device=device), metas[0])
        else:
            out[f"sub{i}"] = {"per_block": [
                _layer_cache(cfg, l, batch, smax, device) for l in layers]}
    return out


def _cache_at(col, b: int):
    """Block ``b``'s cache of a column: views into a stacked column."""
    if "per_block" in col:
        return col["per_block"][b]
    return _map(lambda t: t[b], col)


def cache_leaves(node):
    """(name, tensor) of every leaf of a cache, per-block lists included."""
    for k, v in node.items():
        if k == "per_block":
            for c in v:
                yield from cache_leaves(c)
        elif isinstance(v, dict):
            yield from cache_leaves(v)
        else:
            yield k, v


def reset_cache(cache) -> None:
    """Zero a cache in place (ring positions to −1, unwritten)."""
    for name, t in cache_leaves(cache):
        t.fill_(-1 if name == "pos" else 0)


def _check_cache(cfg: ModelConfig, cache, batch: int, smax: int, device):
    want = init_cache(cfg, batch, smax, "meta")

    def shapes(node):
        return [(n, tuple(t.shape), t.dtype) for n, t in cache_leaves(node)]

    got = shapes(cache)
    if got != shapes(want) or any(t.device != device
                                  for _, t in cache_leaves(cache)):
        raise ValueError(f"cache leaves {got} do not match "
                         f"{cfg.name}'s at batch {batch}, smax {smax} on "
                         f"{device}")


# ------------------------------------------------------------------ prefill -
def prefill(cfg: ModelConfig, params, batch, smax: int, cache=None,
            exact: bool = True):
    """Forward over the prompt + cache build.

    ``batch``: {"tokens": (B, S) int} or, for an embeddings frontend,
    {"embeds": (B, S, d)}, with optional "pad": (B,) left-pad counts, which
    make the prefill mask-correct for ragged prompts (pad slots are invalid
    keys, SSM layers zero pad inputs).  Returns (last-token logits
    (B, vocab) float32, cache, S).  Prompts are right-aligned, so the last
    position is always real; only it goes through the LM head.  ``cache``
    (as from `init_cache`) is reset and written in place instead of
    allocating one, so a captured decode step keeps reading the buffers it
    was captured on.  ``exact`` sums the plain (bf16) linears and SSM
    projections in float64 (`layers.matmul_exact`), so a prompt's logits
    do not depend on its batchmates or its bucket; False takes the library
    GEMM, faster and not batch-invariant.
    """
    h, positions = _embed(cfg, params, batch)
    valid = positions >= 0 if positions.ndim == 2 else None
    B, S = h.shape[0], h.shape[1]
    if cache is None:
        cache = init_cache(cfg, B, smax, h.device)
    else:
        _check_cache(cfg, cache, B, smax, h.device)
        reset_cache(cache)
    kind = _mixer_kind(cfg)
    for b in range(cfg.n_blocks):
        for i in range(cfg.layers_per_block):
            layer = b * cfg.layers_per_block + i
            p = _layer(params["blocks"][f"sub{i}"], b)
            c = _cache_at(cache[f"sub{i}"], b)
            if kind in ("attn", "hybrid"):
                oa, (k, v) = _attn_full(p, h, cfg, _window(cfg, layer),
                                        positions, exact)
            if kind in ("ssm", "hybrid"):
                x = rms_norm(h, p["norm_mix"], cfg.norm_eps)
                os_, sc = _ssm_prefill(p["ssm"], x, cfg, valid, exact)
                if cfg.post_norm:
                    os_ = rms_norm(os_, p["norm_mix_post"], cfg.norm_eps)
                c["ssm"]["state"].copy_(sc["state"])
                c["ssm"]["conv"].copy_(sc["conv"])
            if kind == "attn":
                h = h + oa
            elif kind == "ssm":
                h = h + os_
            else:
                h = _fuse(p, h, oa, os_, cfg)
            h = _ffn(p, h, cfg, i, exact)
            if kind == "ssm":
                continue
            if "pos" in c:           # ring: the last min(w, S) positions
                w = c["pos"].shape[0]
                n = min(w, S)
                ts = torch.arange(S - n, S, device=h.device)
                slots = ts % w
                c["k"][:, slots] = k[:, S - n:].to(c["k"].dtype)
                c["v"][:, slots] = v[:, S - n:].to(c["v"].dtype)
                c["pos"][slots] = ts.to(torch.int32)
            else:
                update_cache_full(c["k"], c["v"], k, v, 0)
    return _lm_head(cfg, params, h[:, -1:])[:, 0], cache, S


# -------------------------------------------------------------- decode step -
def _layer_decode(p, h, cfg: ModelConfig, i: int, window: int, pos, cache,
                  positions=None, block_table=None):
    kind = _mixer_kind(cfg)
    if kind == "attn":
        h = h + _attn_decode(p, h, cfg, window, pos, cache, positions,
                             block_table)
    elif kind == "ssm":
        x = rms_norm(h, p["norm_mix"], cfg.norm_eps)
        o, _ = ssm_decode_step(p["ssm"], x, cache["ssm"], cfg)
        if cfg.post_norm:
            o = rms_norm(o, p["norm_mix_post"], cfg.norm_eps)
        h = h + o
    else:
        oa = _attn_decode(p, h, cfg, window, pos, cache, positions,
                          block_table)
        x = rms_norm(h, p["norm_mix"], cfg.norm_eps)
        os_, _ = ssm_decode_step(p["ssm"], x, cache["ssm"], cfg)
        h = _fuse(p, h, oa, os_, cfg)
    return _ffn(p, h, cfg, i)


def decode_step(cfg: ModelConfig, params, cache, batch, pos,
                positions=None, block_tables=None):
    """One decode step: batch {"tokens": (B, 1)} (or {"embeds": (B, 1, d)}),
    ``pos`` the shared cache slot (an int, or a 0-d integer tensor on the
    device that the step never reads on the host, as a captured step
    needs), ``positions`` ((B,), optional) the real per-sequence
    positions.  Returns (logits (B, vocab) float32, cache updated in
    place).

    ``block_tables`` ((B, nlog) int64, optional) selects the paged layout:
    ``cache`` holds the physical pools of `serve/paged_cache.
    init_paged_cache` (SSM state stays one row a slot), ``pos`` becomes
    the per-slot (B,) write position and the real positions default to it
    (scheduler slots carry no pad)."""
    if cfg.frontend == "embeddings":
        h = batch["embeds"].to(_dtype(cfg))
    else:
        h = lookup(params["embed"], batch["tokens"])
    if block_tables is not None:
        pos = torch.as_tensor(pos, device=h.device).expand(h.shape[0])
        positions = pos if positions is None else positions
    elif isinstance(pos, torch.Tensor) and pos.ndim:
        raise ValueError("per-slot (B,) decode positions need block_tables "
                         "paging; the contiguous cache layout shares one "
                         "scalar write position")
    if cfg.pos == "sinusoidal":
        if positions is None:
            p0 = torch.as_tensor(pos, device=h.device).reshape(1)
            pe = sinusoidal(p0, cfg.d_model)[None]
        else:
            pe = sinusoidal(positions[:, None], cfg.d_model)
        h = h + pe.to(h.dtype)
    for b in range(cfg.n_blocks):
        for i in range(cfg.layers_per_block):
            layer = b * cfg.layers_per_block + i
            h = _layer_decode(_layer(params["blocks"][f"sub{i}"], b), h, cfg,
                              i, _window(cfg, layer), pos,
                              _cache_at(cache[f"sub{i}"], b), positions,
                              block_tables)
    return _lm_head(cfg, params, h)[:, 0], cache
