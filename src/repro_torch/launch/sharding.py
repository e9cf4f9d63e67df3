"""Sharding policy, port of `repro/launch/sharding.py`: name- and
shape-driven partition specs for parameters, optimizer state, batches and
decode caches, and the placements that cut one process's slice.

A spec (:class:`P`, the reference's ``PartitionSpec``) says, per tensor
dim, which mesh axes shard it: None (whole), an axis name, or a tuple of
names.  The rules read only ``mesh.shape`` (by axis name) and
``mesh.axis_names``, so a shape-only `launch.mesh.Mesh` serves them.

Modes, the reference's:
  tp       — 1-D tensor parallel over "model", data parallel over the dp
             axes (models of at most 4e9 parameters);
  fsdp_tp  — tp, and each weight's largest non-TP dim also over the dp
             axes (ZeRO-3); optimizer state inherits the parameter specs;
  dp       — parameters whole;
  rns_tp / rns_tp_col / rns_tp_auto — encoded serving trees
             (`repro_torch.dist`): each `RNSTensor` leaf shards its residue
             channel axis (−3) or its output columns (−1, the column scale
             along), or stays whole, as its launch runs (strict channels,
             or `rns_shard.resolve_layout` preferring columns or the
             context's layout); every other leaf stays whole.  The engine
             places its weights by these rules (`dist.engine.place_params`).

Every rule assigns an axis to a dim only when the axis size divides it
(`_maybe`), so odd head counts and vocabularies fall back to whole dims.
KV caches shard the sequence over "model" (paged pools their physical
block axis), SSM states their state dim; the batch goes over the dp axes
when it divides.

`shardings` turns a spec tree into :class:`Placement`s: for each leaf, the
function that cuts this process's slice of a whole tensor.
`to_placements` turns one spec into DTensor placements on the mesh's
`DeviceMesh`, and `distribute` a tree into DTensors (the mesh dry run and
the sharded train step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rns_tensor import RNSTensor

from .mesh import MODEL_AXIS, dp_axes

__all__ = ["P", "Placement", "param_specs", "batch_specs", "cache_specs",
           "logits_spec", "shardings", "mode_for", "to_placements",
           "distribute"]


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name or a
    tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mode_for(cfg: ModelConfig) -> str:
    """Default distribution mode by model size."""
    from repro_torch.models.transformer import count_params
    return "fsdp_tp" if count_params(cfg) > 4e9 else "tp"


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _maybe(mesh, axes, dim: int):
    """``axes`` if their size product divides ``dim``, else None."""
    if axes is None or dim <= 0:
        return None
    if dim % _axis_size(mesh, axes) == 0:
        return axes
    return None


def _map(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over dicts, lists and tuples (not specs);
    `RNSTensor`s are leaves."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _param_rule(mesh, mode: str, path: str, shape: Tuple[int, ...]):
    if mode == "dp":
        return P(*([None] * len(shape)))
    dp = dp_axes(mesh)
    fsdp = dp if mode == "fsdp_tp" else None
    mdl = MODEL_AXIS
    nd = len(shape)
    name = path.rsplit("/", 1)[-1]

    def spec(*ax):
        return P(*[_maybe(mesh, a, d) for a, d in zip(ax, shape)])

    if name == "embed":                              # (V, d)
        s = spec(mdl, fsdp)
        if s[0] is None:                             # odd vocab: shard d
            return spec(fsdp, mdl)
        return s
    if name == "lm_head":                            # (d, V)
        s = spec(fsdp, mdl)
        if s[-1] is None:
            return spec(mdl, fsdp)
        return s
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        if nd == 3:                                  # (L, d_in, d_out)
            return spec(None, fsdp, mdl)
        if nd == 4:                                  # (L, E, d, f) experts
            return spec(None, mdl, fsdp, None)
        return spec(fsdp, mdl)
    if name in ("wo", "w_down", "out_proj"):
        if nd == 3:                                  # (L, d_in, d_out)
            return spec(None, mdl, fsdp)
        if nd == 4:                                  # (L, E, f, d)
            return spec(None, mdl, fsdp, None)
        return spec(mdl, fsdp)
    if name == "conv_w":                             # (L, k, conv_dim)
        return spec(None, None, mdl)
    if name == "router":                             # (L, d, E): whole
        return P(*([None] * nd))
    # norm scales, biases, A_log, optimizer vr/vc, ...
    if nd <= 1 or mode != "fsdp_tp":
        return P(*([None] * nd))
    # FSDP fallback: the largest dim of >= 1024 that the dp axes divide
    sizes = list(shape)
    out = [None] * nd
    for i in sorted(range(nd), key=lambda i: -sizes[i]):
        if sizes[i] % _axis_size(mesh, dp) == 0 and sizes[i] >= 1024:
            out[i] = dp
            break
    return P(*out)


def _launch_layout(mode: str, layout: str, basis, N: int, n: int,
                   emit: str, parts) -> str:
    """The layout of one fused launch's weights under an ``rns_tp*``
    mode: strict channels for ``rns_tp``, else `rns_shard.resolve_layout`
    with the preference "column" (``rns_tp_col``) or ``layout``."""
    from repro_torch.core.channel_plan import residue_dtype_for
    from repro_torch.dist.rns_shard import crt_tables, resolve_layout

    C = len(basis.moduli)
    if mode == "rns_tp":
        if emit == "residues":          # re-encoding needs every modulus
            return "replicate"
        if C % n:
            raise ValueError(
                f"mesh '{MODEL_AXIS}' size {n} does not divide the residue "
                f"channel count C={C}; channel sharding (rns_tp) needs "
                "C % model == 0")
        return "channel"
    return resolve_layout("column" if mode == "rns_tp_col" else layout, C=C,
                          N=N, nlimbs=crt_tables(basis)[2], ndev=n,
                          emit=emit, parts=parts,
                          itemsize=residue_dtype_for(basis.moduli).itemsize)


def _rns_param_specs(mesh, cfg: ModelConfig, tree, mode: str, layout: str):
    """Encoded serving trees: each `RNSTensor` leaf in the layout its
    launch runs in, its residue channel axis (−3) or its output columns
    (−1, the column scale along) over "model", or whole; every other leaf
    whole.  An `RNSTensor` leaf's spec is an `RNSTensor` of specs.

    The weights of one launch (`dist.engine.linear_launches`: the stacked
    QKV of a residue-resident attention, the MLP's up projection exiting
    in the residue domain) share one layout, resolved on the launch's N,
    parts and exit.  A placed weight is the launch's operand as it stands
    (`dist.engine.place_params`), so the placement and the launch are one
    rule.  The reference places for locality alone (its launches re-shard
    their operands): its ``rns_tp_col`` leaves a leaf whole where N does
    not divide, its ``rns_tp_auto`` takes channels wherever C divides.
    Here ``rns_tp`` is the reference's strict channel sharding (raises
    when the axis size does not divide C), and ``rns_tp_col`` /
    ``rns_tp_auto`` resolve each launch with the preference "column" /
    ``layout``."""
    from repro_torch.dist.engine import linear_launches

    n = _axis_size(mesh, MODEL_AXIS)

    def rep(x):
        return P(*([None] * len(x.shape)))

    def at(pos, ndim):
        out = [None] * ndim
        out[ndim + pos] = MODEL_AXIS
        return P(*out)

    def spec(leaf, lay):
        res, scale = leaf.residues, leaf.scale
        r_spec, s_spec = rep(res), rep(scale)
        if lay == "channel":
            r_spec = at(-3, len(res.shape))
        elif lay == "column":
            r_spec, s_spec = at(-1, len(res.shape)), at(-1, len(scale.shape))
        return RNSTensor(residues=r_spec, scale=s_spec, basis=leaf.basis)

    def walk(node, group):
        if isinstance(node, dict):
            mats = {k: v for k, v in node.items() if isinstance(v, RNSTensor)}
            out = {}
            for names, emit in linear_launches(cfg, group, mats):
                ns = [mats[k].shape[-1] for k in names]
                lay = _launch_layout(mode, layout, mats[names[0]].basis,
                                     sum(ns), n, emit, ns)
                out.update({k: spec(mats[k], lay) for k in names})
            return {k: out[k] if k in out else walk(v, k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, group) for v in node)
        if isinstance(node, RNSTensor):               # a launch of its own
            return spec(node, _launch_layout(mode, layout, node.basis,
                                             node.shape[-1], n, "float",
                                             None))
        return rep(node)

    return walk(tree, None)


def param_specs(mesh, cfg: ModelConfig, tree, mode: str | None = None, *,
                layout: str = "auto"):
    """Spec tree of parameters OR optimizer state (optimizer leaves carry
    the parameter's name last, so moments inherit its layout).  The
    ``rns_tp*`` modes place encoded serving trees (`_rns_param_specs`;
    ``layout`` is ``rns_tp_auto``'s per-launch preference, as
    `dist.context.DistContext.layout`)."""
    mode = mode or mode_for(cfg)
    if mode in ("rns_tp", "rns_tp_col", "rns_tp_auto"):
        return _rns_param_specs(mesh, cfg, tree, mode, layout)
    return _map(lambda path, leaf: _param_rule(mesh, mode, path,
                                               tuple(leaf.shape)), tree)


def batch_specs(mesh, cfg: ModelConfig, batch_tree, mode: str | None = None):
    """tokens / labels (B, S) and embeds (B, S, d): the batch over the dp
    axes (over every axis in pure dp mode)."""
    dp = dp_axes(mesh)
    if mode == "dp":
        dp = dp + (MODEL_AXIS,)

    def rule(path, leaf):
        first = _maybe(mesh, dp, leaf.shape[0])
        return P(*([first] + [None] * (len(leaf.shape) - 1)))

    return _map(rule, batch_tree)


def cache_specs(mesh, cfg: ModelConfig, cache_tree, *, paged: bool = False):
    """Decode caches: KV sequence-sharded over "model", SSM states
    state-sharded; ``paged`` reads k/v as `serve.paged_cache`'s pool
    (L, n_phys, block_size, Hk, dh) and shards its physical blocks,
    never a block's contents."""
    dp = dp_axes(mesh)
    mdl = MODEL_AXIS

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        if paged and name in ("k", "v") and len(shape) == 5:
            return P(None, _maybe(mesh, dp, shape[1]), None, None, None)
        if name in ("k", "v"):
            if len(shape) == 5:                      # (L, B, S, Hk, dh)
                return P(None, _maybe(mesh, dp, shape[1]),
                         _maybe(mesh, mdl, shape[2]), None, None)
            return P(_maybe(mesh, dp, shape[0]), _maybe(mesh, mdl, shape[1]),
                     None, None)
        if name == "state":                          # (L?, B, H, N, P)
            if len(shape) == 5:
                return P(None, _maybe(mesh, dp, shape[1]), None,
                         _maybe(mesh, mdl, shape[3]), None)
            return P(_maybe(mesh, dp, shape[0]), None,
                     _maybe(mesh, mdl, shape[2]), None)
        if name == "conv":                           # (L?, B, k-1, conv_dim)
            if len(shape) == 4:
                return P(None, _maybe(mesh, dp, shape[1]), None,
                         _maybe(mesh, mdl, shape[3]))
            return P(_maybe(mesh, dp, shape[0]), None,
                     _maybe(mesh, mdl, shape[2]))
        return P(*([None] * len(shape)))             # positions etc.

    return _map(rule, cache_tree)


def logits_spec(mesh, cfg: ModelConfig, batch: int) -> P:
    dp = dp_axes(mesh)
    return P(_maybe(mesh, dp, batch), _maybe(mesh, MODEL_AXIS,
                                             cfg.vocab_size))


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf's spec on a mesh, at this process's coordinates: calling it
    on the whole tensor returns this process's slice (a view)."""

    spec: P
    sizes: Dict[str, int]
    coords: Dict[str, int]

    def part(self, dim: int):
        """(this process's index, the part count) along ``dim``, or None
        when the spec keeps that dim whole."""
        axes = self.spec[dim]
        if axes is None:
            return None
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, idx = 1, 0
        for a in axes:
            n *= self.sizes[a]
            idx = idx * self.sizes[a] + self.coords[a]
        return idx, n

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        for dim in range(len(self.spec)):
            cut = self.part(dim)
            if cut is not None:
                step = t.shape[dim] // cut[1]
                t = t.narrow(dim, cut[0] * step, step)
        return t


def shardings(mesh, spec_tree) -> Any:
    """The spec tree as :class:`Placement`s at this process's coordinates
    on ``mesh`` (an `RNSTensor` of specs maps to one of placements)."""
    sizes = dict(mesh.shape)
    coords = {a: mesh.index(a) for a in mesh.axis_names}

    def place(path, s):
        if isinstance(s, RNSTensor):
            return RNSTensor(residues=place(path, s.residues),
                             scale=None if s.scale is None
                             else place(path, s.scale), basis=s.basis)
        return Placement(s, sizes, coords)

    return _map(place, spec_tree)


def to_placements(mesh, spec) -> list:
    """DTensor placements of a spec, one a mesh dim: ``Shard(d)`` on every
    mesh axis that ``spec[d]`` names (each axis of a tuple such as
    ("pod", "data"), major first), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[names.index(a)] = Shard(d)
    return out


def distribute(mesh, tree, spec_tree):
    """``tree`` (params, optimizer state, a batch or a cache) as DTensors
    on ``mesh`` by ``spec_tree`` (as `param_specs` and the others return
    it; an `RNSTensor` leaf takes an `RNSTensor` of specs).  Each leaf is
    the whole tensor, the same on every rank (`torch.distributed.tensor.
    distribute_tensor` keeps rank 0's); meta tensors give meta shards."""
    from torch.distributed.tensor import distribute_tensor

    dm = mesh.device_mesh
    if dm is None:
        raise ValueError("a shape-only mesh has no DeviceMesh to place on")

    def place(t, spec):
        if isinstance(t, RNSTensor):
            return dataclasses.replace(
                t, residues=place(t.residues, spec.residues),
                scale=None if t.scale is None else place(t.scale,
                                                         spec.scale))
        return distribute_tensor(t, dm, to_placements(mesh, spec))

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(v, spec[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not isinstance(t, P):
            return type(t)(walk(v, sp) for v, sp in zip(t, spec))
        return place(t, spec)

    return walk(tree, spec_tree)
