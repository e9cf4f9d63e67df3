"""The port's sharding rules and wire-bytes model (`repro_torch.launch.
sharding`, `dist.comms`, `dist.rns_shard.resolve_layout`, `launch.costs.
comms_bytes_*`) against the reference's, with no processes: the rules read
only a mesh's shape, so the reference's shape-only `FakeMesh` shapes serve
both packages.  Specs are compared entry by entry (`P` and
`PartitionSpec` are both tuples) over the same abstract trees."""
import functools
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.transformer as RT
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.configs.base import list_archs as ref_archs
from repro.dist import comms as RCOMMS
from repro.launch import costs as RC
from repro.launch import inputs as RI
from repro.launch import sharding as RS
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.core.rns_tensor import RNSTensor
from repro_torch.dist import comms
from repro_torch.dist.rns_shard import crt_tables, resolve_layout
from repro_torch.launch import costs as TC
from repro_torch.launch import inputs as TI
from repro_torch.launch import sharding as TS
from repro_torch.launch.mesh import Mesh, dp_axes

SHARED = sorted(set(list_archs()) & set(ref_archs()))


class FakeMesh:
    """The reference test's shape-only mesh."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 4, "model": 2}, {"data": 4, "model": 3}]


@pytest.fixture(autouse=True)
def _memo_ref_counts(monkeypatch):
    """The reference counts parameters by tracing `make_params`; memoize
    per config."""
    for name in ("count_params", "active_params"):
        monkeypatch.setattr(RT, name, _memo(getattr(RT, name)))


@functools.lru_cache(maxsize=None)
def _memo(fn):
    return functools.lru_cache(maxsize=None)(fn)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return RI.abstract_params(ref_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TI.abstract_params(get_config(arch), encoded=False)


def _norm(spec):
    """A spec's entries with one-axis tuples as the axis name, as
    `PartitionSpec` stores them."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat(tree, path=()):
    """{path: spec} of a nested dict/list spec tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    if isinstance(tree, RNSTensor) or hasattr(tree, "residues"):
        return {path + ("residues",): _norm(tree.residues),
                path + ("scale",): None if tree.scale is None
                else _norm(tree.scale)}
    return {path: _norm(tree)}


def _same(port, ref):
    p, r = _flat(port), _flat(ref)
    assert p.keys() == r.keys()
    bad = {k: (p[k], r[k]) for k in p if p[k] != r[k]}
    assert not bad, bad


def test_mesh_axes_and_shape_only_mesh():
    m = Mesh({"pod": 2, "data": 16, "model": 16})
    assert m.axis_names == ("pod", "data", "model")
    assert dp_axes(m) == ("pod", "data") and m.index("model") == 0
    with pytest.raises(ValueError, match="no process groups"):
        m.group("model")
    with pytest.raises(RuntimeError, match="process group"):
        from repro_torch.launch.mesh import make_host_mesh
        make_host_mesh(2)


@pytest.mark.parametrize("arch", SHARED)
def test_param_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert TS.mode_for(cfg) == RS.mode_for(rcfg)
    for shape, mode in itertools.product(MESH_SHAPES[:2],
                                         ("tp", "fsdp_tp", "dp")):
        _same(TS.param_specs(Mesh(shape), cfg, _port_params(arch), mode),
              RS.param_specs(FakeMesh(shape), rcfg, _ref_params(arch), mode))


@pytest.mark.parametrize("arch", SHARED)
def test_batch_cache_logits_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in MESH_SHAPES[:3]:
        pm, rm = Mesh(shape), FakeMesh(shape)
        for sname, s in SHAPES.items():
            for mode in (None, "dp"):
                _same(TS.batch_specs(pm, cfg, TI.input_specs(cfg, s), mode),
                      RS.batch_specs(rm, rcfg,
                                     RI.input_specs(rcfg, REF_SHAPES[sname]),
                                     mode))
        for B in (1, 8, 128):
            assert _norm(TS.logits_spec(pm, cfg, B)) == \
                _norm(RS.logits_spec(rm, rcfg, B))
        _same(TS.cache_specs(pm, cfg, TI.abstract_cache(cfg, 32, 1024)),
              RS.cache_specs(rm, rcfg, RI.abstract_cache(rcfg, 32, 1024)))


@pytest.mark.parametrize("arch", ["smollm-135m", "rns-smollm-135m-fused",
                                  "mamba2-1.3b"])
def test_paged_cache_specs_equal_reference(arch):
    from repro.serve.paged_cache import init_paged_cache as ref_paged
    from repro_torch.serve.paged_cache import init_paged_cache

    cfg, rcfg = get_config(arch), ref_config(arch)
    port = init_paged_cache(cfg, 64, 16, 8, device="meta")
    ref = jax.eval_shape(lambda: ref_paged(rcfg, 64, 16, 8))
    for shape in MESH_SHAPES[:3]:
        _same(TS.cache_specs(Mesh(shape), cfg, port, paged=True),
              RS.cache_specs(FakeMesh(shape), rcfg, ref, paged=True))


def _rns_trees(N=12, stacked=True):
    """The reference test's tree: a (L, C, K, N) encoded weight (C = 4)
    and a float leaf, in both packages."""
    from repro.core.rns import basis_for_int8_matmul as ref_basis
    from repro.core.rns_tensor import RNSTensor as RefRNSTensor

    b, rb = basis_for_int8_matmul(8), ref_basis(8)
    C = len(b.moduli)
    shape = (3, C, 8, N) if stacked else (C, 8, N)
    sshape = shape[:-3] + (1, N)
    port = {"w": RNSTensor(residues=torch.zeros(shape, dtype=torch.int8),
                           scale=torch.zeros(sshape), basis=b),
            "norm": torch.zeros(8)}
    ref = {"w": RefRNSTensor(residues=jnp.zeros(shape, jnp.int16),
                             scale=jnp.zeros(sshape, jnp.float32), basis=rb,
                             bound=127, signed=True),
           "norm": jnp.zeros((8,), jnp.float32)}
    return port, ref


def _launch_spec(leaf, lay):
    """{residues, scale} specs of an encoded leaf placed in ``lay``."""
    nd, sd = leaf.residues.ndim, leaf.scale.ndim
    res, sc = [None] * nd, [None] * sd
    if lay == "channel":
        res[nd - 3] = "model"
    elif lay == "column":
        res[nd - 1], sc[sd - 1] = "model", "model"
    return tuple(res), tuple(sc)


@pytest.mark.parametrize("mode", ["rns_tp", "rns_tp_col", "rns_tp_auto"])
@pytest.mark.parametrize("N", [12, 10])
@pytest.mark.parametrize("stacked", [True, False])
def test_rns_modes_equal_reference(mode, N, stacked):
    """``rns_tp`` is the reference's strict channel rule.  ``rns_tp_col``
    and ``rns_tp_auto`` place a weight where the reference's launch runs
    it (its `sharded_fused_matmul` resolution, preferring columns or the
    layout); ``rns_tp_auto`` with the "channel" preference is the
    reference's own ``rns_tp_auto`` placement, and on these trees
    ``rns_tp_col`` is the reference's too."""
    cfg, rcfg = get_config("smollm-135m"), ref_config("smollm-135m")
    port, ref = _rns_trees(N, stacked)
    w = port["w"]
    C, L1 = len(w.moduli), crt_tables(w.basis)[2]
    for shape in MESH_SHAPES[2:]:
        pm, rm = Mesh(shape), FakeMesh(shape)
        if mode == "rns_tp" and shape["model"] == 3:
            for mesh, c, tree, specs in ((pm, cfg, port, TS.param_specs),
                                         (rm, rcfg, ref, RS.param_specs)):
                with pytest.raises(ValueError, match="channel count"):
                    specs(mesh, c, tree, mode)
            continue
        if mode != "rns_tp_auto":
            _same(TS.param_specs(pm, cfg, port, mode),
                  RS.param_specs(rm, rcfg, ref, mode))
        else:
            _same(TS.param_specs(pm, cfg, port, mode, layout="channel"),
                  RS.param_specs(rm, rcfg, ref, mode))
        if mode == "rns_tp":
            continue
        lay = _ref_resolve("column" if mode == "rns_tp_col" else "auto", C,
                           1, N, L1, shape["model"], "float", 1)
        got = _flat(TS.param_specs(pm, cfg, port, mode))
        assert (got[("w", "residues")], got[("w", "scale")]) == \
            _launch_spec(w, lay), (shape, lay)
        assert got[("norm",)] == (None,)


@pytest.mark.parametrize("arch", ["rns-smollm-135m-fused",
                                  "rns-smollm-135m-resident"])
def test_rns_modes_on_served_trees(arch):
    """The served encoded tree: every RNSTensor leaf where the reference's
    launch of it runs (the stacked QKV of the resident attention on its
    summed N, the resident MLP's up projection with a residue exit), float
    leaves whole."""
    from repro_torch.core.channel_plan import residue_dtype_for

    cfg = get_config(arch)
    resident = cfg.linear_spec.domain == "residue"
    tree = TI.abstract_params(cfg, encoded=True)
    leaves = _flat_leaves(tree)
    for shape, mode, pref in itertools.product(
            MESH_SHAPES[2:], ("rns_tp_col", "rns_tp_auto"),
            ("auto", "channel", "column")):
        if mode == "rns_tp_col" and pref != "auto":
            continue
        specs = _flat(TS.param_specs(Mesh(shape), cfg, tree, mode,
                                     layout=pref))
        n = shape["model"]
        for path, leaf in leaves.items():
            if not isinstance(leaf, RNSTensor):
                assert specs[path] == (None,) * leaf.ndim, path
                continue
            group, name = path[-2:]
            C, N = leaf.residues.shape[-3], leaf.residues.shape[-1]
            if resident and group == "attn" and name in ("wq", "wk", "wv"):
                ns = [leaves[path[:-1] + (q,)].residues.shape[-1]
                      for q in ("wq", "wk", "wv")]
                assert all(x % n == 0 for x in ns)    # parts never decide
                N = sum(ns)
            emit = ("residues" if resident and group == "mlp"
                    and name == "w_up" else "float")
            lay = _ref_resolve("column" if mode == "rns_tp_col" else pref,
                               C, 1, N, crt_tables(leaf.basis)[2], n, emit,
                               residue_dtype_for(leaf.moduli).itemsize)
            assert (specs[path + ("residues",)], specs[path + ("scale",)]) \
                == _launch_spec(leaf, lay), (path, shape, mode, pref)


def _flat_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, path + (str(k),)))
        return out
    return {path: tree}


def test_placements_cut_this_rank():
    """`shardings`: a (4, 6) leaf split (data, model) on a 2×3 mesh cuts
    rank (1, 2)'s block; an RNSTensor spec cuts its residues and scale."""
    class At(Mesh):
        def index(self, axis):
            return {"data": 1, "model": 2}[axis]

    m = At({"data": 2, "model": 3})
    t = torch.arange(24).reshape(4, 6)
    cut = TS.shardings(m, {"a": TS.P("data", "model"), "b": TS.P(None, None)})
    assert torch.equal(cut["a"](t), t[2:4, 4:6])
    assert torch.equal(cut["b"](t), t)
    port, _ = _rns_trees(N=12)
    specs = TS.param_specs(m, get_config("smollm-135m"), port, "rns_tp_col")
    placed = TS.shardings(m, specs)["w"]
    assert placed.residues(port["w"].residues).shape == (3, 4, 8, 4)
    assert placed.scale(port["w"].scale).shape == (3, 1, 4)


def _ref_resolve(layout, C, M, N, nlimbs, n, emit, item):
    """`repro.dist.rns_shard.sharded_fused_matmul`'s per-launch resolution,
    its own lines over the reference's `comms.choose_layout`."""
    lay = layout
    if lay == "auto":
        lay = RCOMMS.choose_layout(C=C, M=M, N=N, nlimbs=nlimbs, ndev=n,
                                   emit=emit, itemsize=item)
    if lay == "channel" and C % n:
        lay = "column" if N % n == 0 else "replicate"
    elif lay == "column" and N % n:
        lay = "channel" if C % n == 0 else "replicate"
    if lay == "channel" and emit == "residues":
        lay = "replicate"
    return lay


def test_choose_layout_and_fallback_equal_reference():
    grid = itertools.product((1, 2, 4, 5, 6, 7), (1, 8, 512), (192, 576, 1536,
                                                               10),
                             (2, 3, 4), (1, 2, 4, 5, 7), ("float",
                                                          "residues"))
    n_cases = 0
    for C, M, N, L1, n, emit in grid:
        kw = dict(C=C, M=M, N=N, nlimbs=L1, ndev=n, emit=emit, itemsize=1)
        assert comms.choose_layout(**kw) == RCOMMS.choose_layout(**kw)
        assert comms.channel_bytes(M, N, L1, n, emit=emit) == \
            RCOMMS.channel_bytes(M, N, L1, n, emit=emit)
        assert comms.column_bytes(C, M, N, n, emit=emit) == \
            RCOMMS.column_bytes(C, M, N, n, emit=emit)
        for layout in ("auto", "channel", "column"):
            assert resolve_layout(layout, M=M, **{
                k: v for k, v in kw.items() if k != "M"}) == \
                _ref_resolve(layout, C, M, N, L1, n, emit, 1)
            n_cases += 1
    assert n_cases > 3000


def test_collective_wire_bytes_prices_a_summary():
    class Summary:
        collectives = [("all_reduce", (((3, 8, 576), "int32"),)),
                       ("all_gather", (((8, 288), "float32"),))]

    want = 2 * 4 / 5 * 3 * 8 * 576 * 4 + 4 / 5 * 5 * 8 * 288 * 4
    assert comms.collective_wire_bytes(Summary, 5) == pytest.approx(want,
                                                                     rel=1e-15)
    assert comms.collective_wire_bytes(Summary, 1) == 0.0


@pytest.mark.parametrize("arch", SHARED)
def test_comms_bytes_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for n, layout in itertools.product((1, 2, 4, 5, 7),
                                       ("auto", "channel", "column")):
        for B in (1, 8):
            got = TC.comms_bytes_decode(cfg, B, ndev=n, layout=layout)
            want = RC.comms_bytes_decode(rcfg, B, ndev=n, layout=layout)
            assert got == pytest.approx(want, rel=1e-12, abs=0.0)
        got = TC.comms_bytes_prefill(cfg, 2, 256, ndev=n, layout=layout)
        want = RC.comms_bytes_prefill(rcfg, 2, 256, ndev=n, layout=layout)
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def test_sharded_configs_bill_the_wire():
    """The fused sharded cell bills one limb all-reduce a launch under the
    channel layout: 7 launches a layer at C = 5 on 5 ranks."""
    cfg = get_config("rns-smollm-135m-sharded")
    assert cfg.linear_spec.dist == "channel"
    d, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    L1 = crt_tables(basis_for_int8_matmul(d))[2]
    assert crt_tables(basis_for_int8_matmul(F))[2] == L1
    per_mn = 2 * 4 / 5 * L1 * 4
    want = L * 8 * per_mn * (d + 2 * 192 + d + 2 * F + d)
    assert TC.comms_bytes_decode(cfg, 8, ndev=5, layout="channel") == \
        pytest.approx(want, rel=1e-12)
    res = get_config("rns-smollm-135m-resident-sharded")
    assert len(basis_for_chain(res.d_ff).moduli) == 7


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp"])
def test_grad_compression_bills_the_int8_sync(mode):
    """`grad_compression` bills the gradient sync at one byte a parameter
    in the cost model, as the reference's does (`costs.py:295`)."""
    import dataclasses

    cfg, rcfg = get_config("smollm-135m"), ref_config("smollm-135m")
    on, ron = (dataclasses.replace(c, grad_compression=True)
               for c in (cfg, rcfg))
    kw = dict(n_pods=1, data=16, model=16, mode=mode)
    got = TC.analytic_cost(on, SHAPES["train_4k"], **kw)
    want = RC.analytic_cost(ron, REF_SHAPES["train_4k"], **kw)
    assert got.breakdown == pytest.approx(want.breakdown, rel=1e-12)
    assert got.ici_bytes == pytest.approx(want.ici_bytes, rel=1e-12)
    off = TC.analytic_cost(cfg, SHAPES["train_4k"], **kw).breakdown
    assert got.breakdown["ici_grad_sync"] < off["ici_grad_sync"]
