"""Analytic per-device cost model: flops, HBM bytes and interconnect
bytes of one step, port of `repro/launch/costs.py`.

The dry run (`launch/dryrun.py`) records both what the step's trace counts
(the float flops of its aten ops and its kernels' operations) and this
model, whose flop formulas are exact for the matmul terms and whose byte
terms are the reference's engineering estimates, formulas spelled out
below, computed in the reference's order of operations so the two
packages agree to the last bit.

Conventions: 2 flops per MAC; everything is *per device*; bf16
activations and params; fp32 logits and optimizer.  The mesh arguments
(``n_pods``, ``data``, ``model``, ``mode``) are the reference's: batch over
the data axes when divisible, features, heads, experts and sequence over
the ``model`` axis; one card is ``n_pods=1, data=1, model=1``.

``comms_bytes_decode`` / ``comms_bytes_prefill`` are the wire bytes of a
sharded step's fused launches (`repro_torch.dist`): `dist.comms`'s
per-launch ring costs over every launch shape of the step
(`kernels.tune.decode_shapes_for`) times its count a step, each resolved
as `dist.rns_shard.resolve_layout` resolves a launch.  As in the
reference, only configs that name the fused backend (``pallas_fused``)
are billed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["analytic_cost", "CostReport", "decode_cache_bytes",
           "paged_cache_bytes", "comms_bytes_decode", "comms_bytes_prefill"]

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CostReport:
    flops: float                 # per-device, bf16-equivalent matmul flops
    flops_int8: float            # per-device int8 ops (rns_int8 backend)
    hbm_bytes: float             # per-device HBM traffic
    ici_bytes: float             # per-device interconnect wire bytes
    breakdown: Dict[str, float]

    def as_dict(self):
        return {"flops": self.flops, "flops_int8": self.flops_int8,
                "hbm_bytes": self.hbm_bytes, "ici_bytes": self.ici_bytes,
                "breakdown": self.breakdown}


def _causal_context_sum(S: int, W: int) -> float:
    """Σ_t min(t+1, W) — total key positions attended over a causal
    (optionally windowed) sequence of length S."""
    W = min(W, S)
    return W * (W + 1) / 2.0 + (S - W) * W


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, *,
                  n_pods: int = 1, data: int = 16, model: int = 16,
                  mode: str = "tp") -> CostReport:
    S = shape.seq_len
    B = shape.global_batch
    mp = model
    dp = n_pods * data
    chips = dp * mp
    if mode == "dp":
        # pure data parallelism: the model axis joins the batch axes; no TP
        dp, mp = dp * mp, 1
    # long_500k's B=1 cannot data-parallelize: dp idles (roofline shows it)
    dp_eff = dp if B % dp == 0 else 1
    eff = dp_eff * mp

    decode = shape.kind == "decode"
    T = B * (1 if decode else S)              # tokens processed this step
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    glu_m = 3 if cfg.glu else 2
    bk: Dict[str, float] = {}

    # ---------------- flops (global, matmul terms; /eff at the end) --------
    fl = 0.0
    # embedding lookup ~0; LM head:
    head = 2.0 * T * d * V
    fl += head
    bk["flops_head"] = head

    attn_ctx = 0.0
    for layer in range(cfg.num_layers):
        is_moe = cfg.mlp_kind(layer) == "moe"
        kind = ("hybrid" if cfg.hybrid
                else "ssm" if (cfg.ssm and cfg.attention == "none") else "attn")
        if kind in ("attn", "hybrid"):
            W = cfg.window_for_layer(layer, S if not decode else S)
            fl += 2.0 * T * d * (H + 2 * Hk) * dh          # qkv
            fl += 2.0 * T * (H * dh) * d                   # o proj
            if decode:
                ctx = B * min(W, S) * 1.0                  # keys visited
            else:
                ctx = B * _causal_context_sum(S, W)
            attn_ctx += 4.0 * ctx * H * dh                 # scores + p·v
        if kind in ("ssm", "hybrid"):
            di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
                cfg.ssm_head_dim
            fl += 2.0 * T * d * (2 * di + 2 * N + Hs)      # in_proj
            fl += 2.0 * T * di * d                         # out_proj
            fl += 2.0 * T * cfg.ssm_conv * (di + 2 * N)    # depthwise conv
            Q = 1 if decode else min(cfg.ssm_chunk, S)
            # SSD dual form: cb (Q·N) + weighted x (Q·H·P) per token intra,
            # plus ~3 state-sized ops per token inter/update
            fl += 2.0 * T * Q * N + 2.0 * T * Q * Hs * P
            fl += 6.0 * T * Hs * N * P
        if is_moe:
            fe = cfg.moe_d_ff or f
            fl += 2.0 * T * d * cfg.num_experts            # router
            fl += 2.0 * (T * cfg.top_k) * glu_m * d * fe   # routed experts
            # routing bookkeeping: cumsum/one-hot over (T·K, E) + the
            # scatter/gather dispatch moves (the reference's compiler counts
            # these as flops)
            fl += 6.0 * T * cfg.top_k * cfg.num_experts \
                + 4.0 * T * cfg.top_k * d
            if cfg.shared_expert:
                fl += 2.0 * T * glu_m * d * fe
        elif f > 0:
            fl += 2.0 * T * glu_m * d * f
    fl += attn_ctx
    bk["flops_attn_ctx"] = attn_ctx

    # training multiplier: blocks fwd + remat-fwd + bwd(2×) = 4× with full
    # remat, 3× without (remat_policy "none"); head (outside the layers) 3×
    if shape.kind == "train":
        remat_on = cfg.remat and cfg.remat_policy != "none"
        blk_mult = 4.0 if remat_on else 3.0
        fl = blk_mult * (fl - head) + 3.0 * head
    flops_dev = fl / eff
    bk["flops_global"] = fl

    # int8 path: the rns_int8 backend runs every dense matmul (not attention
    # scores / SSD) C× over residue channels as int8 ops.  For training,
    # only the forward (+ remat recompute) is RNS — the straight-through
    # backward is dense (an autograd Function), i.e. 2 of the 4
    # fwd-equivalents with full remat, 1 of 3 without.
    flops_int8 = 0.0
    spec = cfg.linear_spec
    if spec.is_rns:
        from repro_torch.core.rns import basis_for_int8_matmul
        C = basis_for_int8_matmul(d).k     # channel count (K≈d dominates)
        dense = flops_dev - (attn_ctx / eff)
        if shape.kind == "train":
            remat_on = cfg.remat and cfg.remat_policy != "none"
            fwd_frac = (2.0 / 4.0) if remat_on else (1.0 / 3.0)
        else:
            fwd_frac = 1.0
        flops_int8 = dense * fwd_frac * C
        flops_dev = attn_ctx / eff + dense * (1.0 - fwd_frac)
        bk["rns_channels"] = C
        # Stage-② for weights: each forward call quantizes (~1 op/elem) and
        # forward-converts (C mods/elem) the static weight matrices the
        # `linear` datapath actually serves — the LM head is a plain bf16
        # einsum outside it, so its d·V elements are excluded (MoE routed
        # experts / SSM projections are einsum-served too; on rns configs —
        # dense smollm — the head is the only material phantom term).
        # Per-device linear-weight elements = lin/(2T).  Encoded specs
        # (LinearSpec.encode_weights: RNSTensor weights built once at load)
        # pay ZERO of this per call — the dominant rns decode-overhead term,
        # since at T = B tokens the weights outweigh the activations.
        head_mult = 3.0 if shape.kind == "train" else 1.0
        lin = max(0.0, dense - head_mult * head / eff)
        w_elems = lin * fwd_frac / (2.0 * (T / dp_eff))
        wconv = 0.0 if spec.encode_weights else (C + 1.0) * w_elems
        flops_int8 += wconv
        bk["flops_weight_conv"] = wconv
        # Activation conversion work: every `linear`-served matmul quantizes
        # + forward-converts its input (~(C+1) int ops/elem: one round/clip
        # plus C mods) and MRC-reverses its int32 accumulator output
        # (C·(C+1)/2 fold subtract/mod steps + ~3·C scale/round ops per
        # output element).  Residue-domain residency (spec.domain ==
        # "residue") chains back-to-back launches: stacked
        # QKV encodes x once (3→1 input encodes) and the GLU MLP runs
        # gate/up/down off a single encode (2→1).  Reverse-side elements are
        # UNCHANGED by residency: the up-projection's chain exit becomes an
        # equal-cost in-domain requantize (same per-output fold ladder, the
        # dequant muls traded for the requant round) — the eliminated work
        # is exactly the duplicate forward conversions.  SSM projections and
        # MoE routed experts are einsum-served (no rns datapath), as above.
        resident = getattr(spec, "domain", "float") == "residue"
        fwd_el = rev_el = 0.0
        for layer in range(cfg.num_layers):
            kind = ("hybrid" if cfg.hybrid
                    else "ssm" if (cfg.ssm and cfg.attention == "none")
                    else "attn")
            if kind in ("attn", "hybrid"):
                fwd_el += T * d * (1.0 if resident else 3.0)  # q,k,v inputs
                fwd_el += T * H * dh                          # o-proj input
                rev_el += T * (H + 2 * Hk) * dh + T * d
            if cfg.mlp_kind(layer) == "mlp" and f > 0:
                if cfg.glu:
                    fwd_el += T * d * (1.0 if resident else 2.0) + T * f
                    rev_el += 2.0 * T * f + T * d
                else:
                    fwd_el += T * d + T * f
                    rev_el += T * f + T * d
        n_fwd = 1.0
        if shape.kind == "train":
            n_fwd = 2.0 if remat_on else 1.0
        act_fwd = (C + 1.0) * fwd_el * n_fwd / eff
        act_rev = (C * (C + 1.0) / 2.0 + 3.0 * C) * rev_el * n_fwd / eff
        flops_int8 += act_fwd + act_rev
        bk["flops_act_fwd_conv"] = act_fwd
        bk["flops_act_rev_conv"] = act_rev

    # ---------------- HBM bytes (per device) -------------------------------
    from repro_torch.models.transformer import count_params
    Pcnt = count_params(cfg)
    p_shard = chips if mode == "fsdp_tp" else mp
    P_dev = Pcnt / p_shard
    B_dev = B / dp_eff
    T_dev = T / dp_eff

    if shape.kind == "train":
        # params: read fwd + remat + bwd (3×bf16) ; grads write+read (fp32);
        # AdamW m,v read+write + param read/write (fp32 master semantics)
        remat_on = cfg.remat and cfg.remat_policy != "none"
        opt_mult = 24 if cfg.optimizer == "adamw" else 6
        w_bytes = P_dev * ((3 if remat_on else 2) * BF16 + 8 + opt_mult)
        act_per_layer = T_dev * (4 * d + (glu_m * f + 3 * H * dh) / mp) * BF16
        act_bytes = cfg.num_layers * act_per_layer * (4 if remat_on else 3)
        # attention blocked in plain ops (the reference's default
        # attn_impl, which no config changes): its scores stream through
        # device memory
        score_bytes = 0.0
        for layer in range(cfg.num_layers):
            if cfg.attention != "none":
                W = cfg.window_for_layer(layer, S)
                score_bytes += (B_dev * _causal_context_sum(S, W)
                                * (H / mp) * F32 * 3)
        logits_bytes = 3 * T_dev * (V / mp) * F32
        hbm = w_bytes + act_bytes + score_bytes + logits_bytes
        bk.update(hbm_weights=w_bytes, hbm_acts=act_bytes,
                  hbm_scores=score_bytes, hbm_logits=logits_bytes)
    elif shape.kind == "prefill":
        w_bytes = P_dev * BF16
        act_per_layer = T_dev * (4 * d + (glu_m * f + 3 * H * dh) / mp) * BF16
        act_bytes = cfg.num_layers * act_per_layer * 2
        score_bytes = 0.0
        for layer in range(cfg.num_layers):
            if cfg.attention != "none":
                W = cfg.window_for_layer(layer, S)
                score_bytes += (B_dev * _causal_context_sum(S, W)
                                * (H / mp) * F32 * 2)
        logits_bytes = T_dev * (V / mp) * F32
        hbm = w_bytes + act_bytes + score_bytes + logits_bytes
        bk.update(hbm_weights=w_bytes, hbm_acts=act_bytes,
                  hbm_scores=score_bytes)
    else:  # decode: weights once + cache traffic — the classic bound
        if cfg.moe:
            # only active experts' weights stream per token (per device)
            from repro_torch.models.transformer import active_params
            w_bytes = active_params(cfg) / p_shard * BF16 * max(1.0, B_dev)
        else:
            w_bytes = P_dev * BF16
        cache_bytes = 0.0
        for layer in range(cfg.num_layers):
            kind = ("hybrid" if cfg.hybrid
                    else "ssm" if (cfg.ssm and cfg.attention == "none")
                    else "attn")
            if kind in ("attn", "hybrid"):
                W = min(cfg.window_for_layer(layer, S), S)
                cache_bytes += B_dev * W / mp * Hk * dh * 2 * BF16
            if kind in ("ssm", "hybrid"):
                cache_bytes += (B_dev * cfg.ssm_heads * cfg.ssm_state
                                * cfg.ssm_head_dim / mp * F32 * 2)
        logits_bytes = B_dev * (V / mp) * F32
        hbm = w_bytes + cache_bytes + logits_bytes
        bk.update(hbm_weights=w_bytes, hbm_cache=cache_bytes)

    # ---------------- interconnect wire bytes (per device) ------------------
    ar = lambda b, n: 2.0 * (n - 1) / n * b if n > 1 else 0.0
    ag = lambda b, n: (n - 1) / n * b if n > 1 else 0.0
    act_b = T_dev * d * BF16
    ici = 0.0
    # TP activation all-reduces: 2 per layer fwd (attn-out, mlp-out; hybrid 3)
    n_ar_layer = 3 if cfg.hybrid else (1 if (cfg.ssm and cfg.attention ==
                                             "none") else 2)
    if shape.kind == "train":
        # fwd + bwd, + remat recompute unless the AR outputs are saved
        # (remat_policy="save_ar" keeps them ⇒ recompute repeats no ARs)
        full_remat = cfg.remat and cfg.remat_policy == "full"
        fwd_mult = 3.0 if full_remat else 2.0
    else:
        fwd_mult = 1.0
    ici += cfg.num_layers * n_ar_layer * fwd_mult * ar(act_b, mp)
    bk["ici_tp_ar"] = ici
    if cfg.moe:
        # expert dispatch/return over the EP axis (a2a-equivalent volume)
        n_moe = sum(1 for l in range(cfg.num_layers)
                    if cfg.mlp_kind(l) == "moe")
        moe_b = 2.0 * n_moe * fwd_mult * (T_dev * cfg.top_k * d * BF16) \
            * (mp - 1) / mp
        ici += moe_b
        bk["ici_moe_a2a"] = moe_b
    if shape.kind == "train":
        # the reference's bill under grad_compression: 1 byte a parameter,
        # the int8 values' width (train/compression.py sums them as
        # int32, 4 bytes an element, as the reference's psum does)
        grad_bytes_per_param = 1.0 if cfg.grad_compression else F32
        grad_shard_bytes = Pcnt / mp * grad_bytes_per_param
        if mode == "fsdp_tp":
            # ZeRO-3: all-gather params (fwd+bwd) + reduce-scatter grads
            sync = 2 * ag(Pcnt / mp * BF16, dp) + ag(grad_shard_bytes, dp)
        else:
            sync = ar(grad_shard_bytes, dp)
        ici += sync
        bk["ici_grad_sync"] = sync
    if decode:
        # sequence-sharded KV softmax stats + output partial-sum all-reduces
        n_attn = sum(1 for l in range(cfg.num_layers)
                     if (not cfg.ssm or cfg.hybrid))
        dec_b = n_attn * ar(B_dev * H * (dh + 2) * F32, mp)
        ici += dec_b
        bk["ici_decode_softmax"] = dec_b
    # loss/logits stats (train): lse all-reduce, tiny
    ici += ar(T_dev * F32, mp) if shape.kind == "train" else 0.0

    return CostReport(flops=flops_dev, flops_int8=flops_int8,
                      hbm_bytes=hbm, ici_bytes=ici, breakdown=bk)


# --------------------------------------------------- serving cache sizing --
def _ssm_state_bytes(cfg: ModelConfig, batch: int, itemsize: int) -> int:
    """Per-layer SSM decode-state bytes, mirroring `ssm.init_ssm_cache`:
    f32 (B, H, N, P) state + param-dtype (B, conv−1, d_inner + 2N) conv."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N
    return (batch * H * N * P * F32
            + batch * (cfg.ssm_conv - 1) * conv_dim * itemsize)


def _param_itemsize(cfg: ModelConfig) -> int:
    return getattr(torch, cfg.param_dtype).itemsize


def decode_cache_bytes(cfg: ModelConfig, batch: int, smax: int) -> int:
    """STATIC decode-cache reservation in bytes — what `transformer.
    init_cache(cfg, batch, smax)` actually allocates (per-layer K/V
    ``batch × min(window, smax)`` rows + SSM state), the ``B·smax`` bound
    the paged pool is measured against."""
    item = _param_itemsize(cfg)
    kind = ("hybrid" if cfg.hybrid
            else "ssm" if (cfg.ssm and cfg.attention == "none") else "attn")
    total = 0
    for layer in range(cfg.num_layers):
        if kind in ("attn", "hybrid"):
            w = min(cfg.window_for_layer(layer, smax), smax)
            total += 2 * batch * w * cfg.num_kv_heads * cfg.head_dim * item
            if w < smax:
                total += w * F32            # ring write-cursor (w,) int32
        if kind in ("ssm", "hybrid"):
            total += _ssm_state_bytes(cfg, batch, item)
    return total


def paged_cache_bytes(cfg: ModelConfig, n_blocks: int, block_size: int,
                      slots: int) -> int:
    """Paged-pool bytes — what `serve.paged_cache.init_paged_cache`
    allocates: per-layer K/V pools of ``n_blocks × block_size`` rows
    (including the reserved trash block) plus slot-resident SSM state.
    Peak KV HBM scales with the POOL, not ``slots × slot_tokens``."""
    item = _param_itemsize(cfg)
    kind = ("hybrid" if cfg.hybrid
            else "ssm" if (cfg.ssm and cfg.attention == "none") else "attn")
    total = 0
    for _layer in range(cfg.num_layers):
        if kind in ("attn", "hybrid"):
            total += (2 * n_blocks * block_size * cfg.num_kv_heads
                      * cfg.head_dim * item)
        if kind in ("ssm", "hybrid"):
            total += _ssm_state_bytes(cfg, slots, item)
    return total


# ------------------------------------------- sharded-launch wire bytes ----
def _fused_launch_mult(cfg: ModelConfig, s: dict) -> int:
    """How many times ONE decode step runs a deduped launch shape of
    `kernels.tune.decode_shapes_for` (matched by (K, N) against the
    dispatch of `models/{transformer,layers}.py`): every attention layer
    runs the QKV (+ wo) launches, every GLU MLP layer gate / up / down."""
    d, F = cfg.d_model, cfg.d_ff
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    has_attn = cfg.attention != "none" or cfg.hybrid
    n_attn = cfg.num_layers if has_attn else 0
    n_mlp = sum(1 for l in range(cfg.num_layers)
                if cfg.mlp_kind(l) == "mlp" and F > 0)
    K, N = s["K"], s["N"]
    if cfg.linear_spec.domain == "residue":
        if (K, N) == (d, (H + 2 * Hk) * dh):
            return n_attn                         # stacked QKV chain
        if (K, N) == (H * dh, d):
            return n_attn                         # wo exit launch
        if (K, N) == (d, F):
            return n_mlp                          # gate OR up (emit splits)
        if (K, N) == (F, d):
            return n_mlp                          # gated down
        return 0
    mult = 0
    if (K, N) == (d, H * dh):
        mult += n_attn                            # q
    if (K, N) == (d, Hk * dh):
        mult += 2 * n_attn                        # k, v
    if (K, N) == (H * dh, d):
        mult += n_attn                            # wo
    if (K, N) == (d, F):
        mult += 2 * n_mlp if cfg.glu else n_mlp   # gate (+up)
    if (K, N) == (F, d):
        mult += n_mlp                             # down
    return mult


def _fused_wire_bytes(cfg: ModelConfig, M: int, *, ndev: int,
                      layout: str) -> float:
    from repro_torch.core.channel_plan import residue_dtype_for
    from repro_torch.dist import comms
    from repro_torch.dist.engine import launch_bases
    from repro_torch.dist.rns_shard import crt_tables, resolve_layout
    from repro_torch.kernels.tune import decode_shapes_for

    spec = cfg.linear_spec
    if ndev <= 1 or not (spec.is_rns and spec.backend == "pallas_fused"):
        return 0.0
    bases = {len(b.moduli): b for b in launch_bases(cfg)}
    total = 0.0
    for s in decode_shapes_for(cfg, batch_sizes=(M,)):
        basis = bases.get(s["C"])
        mult = _fused_launch_mult(cfg, s)
        if basis is None or mult == 0:
            continue
        emit = "residues" if s["emit"] else "float"
        nlimbs = crt_tables(basis)[2]
        item = residue_dtype_for(basis.moduli).itemsize
        lay = resolve_layout(layout, C=s["C"], M=s["M"], N=s["N"],
                             nlimbs=nlimbs, ndev=ndev, emit=emit,
                             itemsize=item)
        if lay == "channel":
            b = comms.channel_bytes(s["M"], s["N"], nlimbs, ndev, emit=emit)
        elif lay == "column":
            b = comms.column_bytes(s["C"], s["M"], s["N"], ndev, emit=emit,
                                   itemsize=item)
        else:
            b = 0.0
        total += mult * b
    return total


def comms_bytes_decode(cfg: ModelConfig, batch: int, *, ndev: int,
                       layout: str = "auto") -> float:
    """Per-device wire bytes of ONE sharded decode step over ``ndev``
    ranks in ``layout`` ("channel" / "column" / "auto"); zero for configs
    off the fused backend and for one rank."""
    return _fused_wire_bytes(cfg, batch, ndev=ndev, layout=layout)


def comms_bytes_prefill(cfg: ModelConfig, batch: int, seq: int, *,
                        ndev: int, layout: str = "auto") -> float:
    """Per-device wire bytes of a sharded prefill of ``batch×seq`` tokens:
    the decode step's launches at M = batch·seq rows."""
    return _fused_wire_bytes(cfg, batch * seq, ndev=ndev, layout=layout)
