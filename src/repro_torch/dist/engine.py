"""Engine-side integration, port of `repro/dist/engine.py`: the mesh check
and the one-time sharded weight encode.

`serve.Engine` hands its mesh here at construction.  `make_context`
checks the mesh against the config's launch bases and returns the
`DistContext` the engine activates around prefill and decode.
`place_params` encodes each process's part of every linear weight once,
by `launch.sharding`'s rules: under the channel layout a rank
forward-converts only its channel slice, under the column layout only its
columns, so the full residue stack never exists on a rank.  The reference
encodes under ``jit(out_shardings=…)`` and lets each launch re-shard its
operands; here a placed weight cannot be re-sharded without moving
residues, so the rules place each weight in the layout its launch
resolves to (`rns_shard.resolve_layout` on the launch's shape and exit,
`linear_launches`), and a weight whose launch replicates stays whole.
Non-RNS leaves (embedding, head, norms) are the whole tree's, as given.
`decode_launches` reads a decode step's kernel launches off the placed
weights.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .context import DistContext

__all__ = ["make_context", "place_params", "launch_bases", "linear_launches",
           "decode_launches"]


def launch_bases(cfg):
    """The distinct RNS bases of the config's fused decode launches."""
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul

    spec = cfg.linear_spec
    if not spec.is_rns:
        return []
    d, F = cfg.d_model, cfg.d_ff
    H, dh = cfg.num_heads, cfg.head_dim
    has_attn = cfg.attention != "none" or cfg.hybrid
    bases = {}
    if spec.domain == "residue":
        if has_attn:
            for b in (basis_for_int8_matmul(d), basis_for_int8_matmul(H * dh)):
                bases[b.moduli] = b
        if cfg.glu and F > 0:
            cb = basis_for_chain(F)
            bases[cb.moduli] = cb
    else:
        pairs = set()
        if has_attn:
            pairs |= {d, H * dh}
        if F > 0:
            pairs |= {d, F}
        for K in sorted(pairs):
            b = basis_for_int8_matmul(K)
            bases[b.moduli] = b
    return list(bases.values())


def make_context(cfg, mesh, layout: str | None = None) -> DistContext:
    """The engine's DistContext, refusing a hopeless mesh.

    ``layout=None`` takes the config's ``dist_layout`` ("auto" when it is
    "none").  The layout is a per-launch preference, so the only error is a
    forced "channel" layout on a model axis that divides no launch basis'
    channel count: every launch would replicate."""
    spec = cfg.linear_spec
    lay = layout if layout is not None else (
        spec.dist if spec.dist != "none" else "auto")
    ctx = DistContext(mesh=mesh, layout=lay)
    if ctx.nshards > 1 and lay == "channel":
        bases = launch_bases(cfg)
        if bases and all(len(b.moduli) % ctx.nshards for b in bases):
            counts = sorted({len(b.moduli) for b in bases})
            raise ValueError(
                f"dist_layout='channel' on a model axis of size "
                f"{ctx.nshards}, but NO launch basis is divisible (channel "
                f"counts {counts}) — every launch would replicate.  Pick a "
                "model axis dividing one of the counts, or layout="
                "'column'/'auto'")
    return ctx


_QKV = ("wq", "wk", "wv")


def linear_launches(cfg, group, names):
    """The fused launches of one layer's encoded linear weights ``names``
    of ``group`` ("attn", "mlp", "shared"), as `models/layers.py` makes
    them: (the weights launched together, the launch's exit).  A
    residue-resident attention launches wq, wk and wv side by side
    (`rns_tensor.cat_columns`), a residue-resident GLU MLP's up projection
    exits in the residue domain (``emit="residues"``), and every other
    weight is a launch of its own with a float exit."""
    spec = cfg.linear_spec
    resident = spec.is_rns and spec.domain == "residue"
    names = list(names)
    out = []
    if resident and group == "attn" and all(q in names for q in _QKV):
        out.append((_QKV, "float"))
        names = [k for k in names if k not in _QKV]
    chain = resident and cfg.glu and cfg.d_ff > 0 and group == "mlp"
    out += [((k,), "residues" if chain and k == "w_up" else "float")
            for k in names]
    return out


def _bases(cfg):
    """(basis of a K-deep linear, the chain basis of the MLP group or
    None)."""
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul

    spec = cfg.linear_spec
    chain = (basis_for_chain(cfg.d_ff) if spec.domain == "residue"
             and cfg.glu and cfg.d_ff > 0 else None)
    return basis_for_int8_matmul, chain


def _map_linears(fn, cfg, params, *rest):
    """``params`` with ``fn(weight, basis, *rest_leaves)`` in place of
    every encoded linear weight (a float tensor at an
    `ENCODED_LINEAR_LEAVES` key), ``rest`` being trees of the same dict
    structure walked alongside."""
    from repro_torch.core.rns_tensor import ENCODED_LINEAR_LEAVES

    per_k, chain = _bases(cfg)

    def walk(node, group, *others):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            sub = [o[k] for o in others]
            if (isinstance(v, torch.Tensor)
                    and k in ENCODED_LINEAR_LEAVES.get(group, ())):
                basis = chain if (chain is not None and group == "mlp") \
                    else per_k(v.shape[-2])
                out[k] = fn(v, basis, *sub)
            else:
                out[k] = walk(v, k, *sub)
        return out

    return walk(params, None, *rest)


def _encoded_shapes(w: torch.Tensor, basis):
    """The encoded form of weight ``w`` in ``basis``, as empty meta
    tensors: what the placement rules read."""
    from repro_torch.core.channel_plan import residue_dtype_for
    from repro_torch.core.rns_tensor import RNSTensor

    lead, (K, N) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    return RNSTensor(
        residues=torch.empty(lead + (len(basis.moduli), K, N),
                             dtype=residue_dtype_for(basis.moduli),
                             device="meta"),
        scale=torch.empty(lead + (1, N), device="meta"), basis=basis)


def _encode_part(w: torch.Tensor, basis, place):
    """This process's part of one weight, encoded from the whole float
    weight as its placement ``place`` (the residues' `Placement`) cuts
    it: the whole `RNSTensor`, or an `RNSShard` of its channels or of its
    columns."""
    from repro_torch.core.channel_plan import residue_dtype_for
    from repro_torch.core.conversion_plan import forward
    from repro_torch.core.quant import quant_scale, quantize_int8
    from repro_torch.core.rns_tensor import RNSShard, encode

    chan, col = place.part(-3), place.part(-1)
    if chan is None and col is None:
        return encode(w, basis)
    N = w.shape[-1]
    moduli = tuple(int(m) for m in basis.moduli)
    if chan is not None:
        (i, n), layout = chan, "channel"
        wq, sw = quantize_int8(w, dim=-2)
        Cl = len(moduli) // n
        res = forward(wq, moduli[i * Cl:(i + 1) * Cl],
                      residue_dtype_for(moduli))
        cols = ((0, 0, N),)
    else:
        # quantization is per column: the rank's columns quantize alone
        (i, n), layout = col, "column"
        Nl = N // n
        wq, _ = quantize_int8(w[..., i * Nl:(i + 1) * Nl], dim=-2)
        sw = quant_scale(w, dim=-2)
        res = forward(wq, moduli)
        cols = ((i * Nl, 0, Nl),)
    return RNSShard(residues=res.movedim(0, -3).contiguous(), scale=sw,
                    basis=basis, layout=layout, index=i, nshards=n,
                    n_global=N, cols=cols)


def place_params(ctx: DistContext, cfg, params: Dict[str, Any]):
    """One-time encode and placement of an encoded-weights config's linear
    weights on this process: `launch.sharding.param_specs` (mode
    ``rns_tp_auto`` with the context's layout) over the encoded tree's
    shapes gives each weight's layout, `launch.sharding.shardings` this
    process's part, and each weight is encoded in that part alone.  A
    config without ``encode_weights`` keeps its float weights whole (each
    launch then slices its operands itself)."""
    from repro_torch.core.rns_tensor import encode
    from repro_torch.launch.sharding import param_specs, shardings

    spec = cfg.linear_spec
    if not (spec.is_rns and spec.encode_weights):
        return params
    if ctx.nshards <= 1:
        # one shard: every weight whole, as the unsharded engine encodes it
        return _map_linears(encode, cfg, params)
    shapes = _map_linears(_encoded_shapes, cfg, params)
    places = shardings(ctx.mesh, param_specs(ctx.mesh, cfg, shapes,
                                             "rns_tp_auto",
                                             layout=ctx.layout))

    def part(w, basis, place):
        # stacked experts (L, E, K, N) stay whole: their launches slice
        # their operands themselves
        return encode(w, basis) if w.ndim > 3 else \
            _encode_part(w, basis, place.residues)

    return _map_linears(part, cfg, params, places)


def decode_launches(cfg, params) -> Dict[str, int]:
    """The fused kernel launches of one decode step on this process, by
    kernel, read from its placed weights (`place_params`): a launch
    (`linear_launches`) of channel shards is one `rns_fused_crt_partial`,
    any other one `rns_fused_matmul`, once for each stacked layer."""
    import math

    from repro_torch.core.rns_tensor import ENCODED_LINEAR_LEAVES, RNSShard

    out = {"rns_fused_crt_partial": 0, "rns_fused_matmul": 0}

    def walk(node, group):
        if not isinstance(node, dict):
            return
        mats = {k: v for k, v in node.items()
                if k in ENCODED_LINEAR_LEAVES.get(group, ())
                and hasattr(v, "residues")}
        for names, _ in linear_launches(cfg, group, mats):
            w = mats[names[0]]
            chan = isinstance(w, RNSShard) and w.layout == "channel"
            out["rns_fused_crt_partial" if chan else "rns_fused_matmul"] += \
                math.prod(w.residues.shape[:-3])
        for k, v in node.items():
            if k not in mats:
                walk(v, k)

    walk(params, None)
    return out
