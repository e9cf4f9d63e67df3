"""Sharded serving on `torch.distributed` (`repro_torch.dist`), on the CPU:
the reference's contract, sharded == unsharded bit for bit
(`tests/test_dist.py`), on ``gloo`` groups of 2 and 4 spawned ranks
(`_dist_workers.spawn_group`: a `FileStore` under the test's directory,
every rank joined with a deadline, so a hung collective fails the test).
Each group is spawned once per module for all its cases:

  * launch — `sharded_fused_matmul` in both layouts, residue-in (float and
    residue exits), quantize, gated and live-weight forms, every rank
    bit-equal to the port's `rns_fused_matmul` and to the reference's
    (Pallas in interpret mode, run here in the parent);
  * engine — the smoke `-sharded` and `-resident-sharded` configs, both
    layouts, ``engine="host"`` and the uncaptured ``"scan"``: tokens and
    prefill logits bit-equal to the unsharded port Engine on every rank,
    tokens equal to the reference's unsharded Engine wherever its top-2
    logit gap exceeds 0.06 (ROADMAP §3's near-tie rule);
  * scheduler — `SlotScheduler(mesh=…)` over both smoke configs (their
    default layouts): staggered requests admitted into a running paged
    decode, every rank's tokens and stats equal to the unsharded
    scheduler's, its chunk uncaptured;
  * wire — a channel-sharded decode step passes `check_reduced_wire`, a
    planted all-reduce of a (C, M, N) int8 stack is flagged.
"""
import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
import _torch_compare as cmp
from repro.configs.base import get_smoke_config as ref_smoke
from repro.core import quant as jquant
from repro.core import rns_tensor as jrt
from repro.core.rns import basis_for_int8_matmul as ref_basis
from repro.kernels.rns_fused import rns_fused_matmul as j_fused
from repro.models import transformer as JT
from repro.serve.engine import Engine as JaxEngine
from repro_torch.analysis import check_reduced_wire
from repro_torch.analysis.residency import TraceSummary
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.rns import basis_for_int8_matmul
from repro_torch.dist.engine import launch_bases, make_context
from repro_torch.dist.rns_shard import crt_tables
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import SlotScheduler
from repro_torch.serve.engine import Engine
from repro_torch.weights import from_jax_params

GROUPS = (2, 4)
ARCHS = ("rns-smollm-135m-sharded", "rns-smollm-135m-resident-sharded")
ENGINE_CASES = [(a, lay) for a in ARCHS for lay in W.LAYOUTS]
SCHED_CASES = [(a, None) for a in ARCHS]
NEAR_TIE = 0.06


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Every group's results: {n: {"launch": [...], "engine": [...],
    "wire": [...]}} (one entry a rank), with the unsharded engines and
    the reference's tokens they are held to."""
    tmp = tmp_path_factory.mktemp("dist")
    x, w, gate = W.launch_operands()
    refs, params = {}, {}
    for arch in ARCHS:
        jp, params[arch] = _weights(arch)
        jeng = JaxEngine(ref_smoke(arch), jp, smax=32)
        teng = Engine(get_smoke_config(arch), params[arch], smax=64, lanes=4,
                      device="cpu")
        want = jeng.generate(W.PROMPTS, max_new_tokens=W.NEW_TOKENS)
        refs[arch] = {
            "host": teng.generate(W.PROMPTS, W.NEW_TOKENS, engine="host"),
            "logits": teng.prefill_logits(W.PROMPTS),
            "jax": want,
            "gaps": cmp._reference_gaps(jeng, W.PROMPTS, want, W.NEW_TOKENS)}
        sched = SlotScheduler(get_smoke_config(arch), params[arch],
                              device="cpu", **W.SCHED)
        refs[arch]["sched"] = sched.serve(W.sched_requests())
        refs[arch]["sched_stats"] = dict(sched.stats)
        refs[arch]["admissions"] = sched.admissions
    ppath = tmp / "params.pt"
    torch.save(params, ppath)
    out = {}
    for n in GROUPS:
        ranks = W.spawn_group(W.dist_task, n, tmp / f"group{n}",
                              (x, w, gate), ENGINE_CASES, str(ppath),
                              "rns-smollm-135m-resident-sharded",
                              SCHED_CASES)
        out[n] = {part: [r[part] for r in ranks]
                  for part in ("launch", "engine", "sched", "wire")}
    return out, refs, (x, w, gate)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's PRNGKey(0) weights of ``arch``'s smoke twin and the
    port's copy of them (the weights `_torch_compare.engines` serves)."""
    jp = JT.make_params(ref_smoke(arch), jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp),
                               get_smoke_config(arch), device="cpu")


def _reference_launch(x, w, gate, form):
    """The reference's `rns_fused_matmul` (interpret mode) of one case, its
    quantizers jitted as its models run them (XLA turns the scale's
    division by 127 into the product the port computes)."""
    jb = ref_basis(x.shape[1])
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    xa, wt = jrt.encode_activation(xj, jb), jrt.encode(wj, jb)
    if form.startswith("residues:"):
        emit = form.split(":")[1]
        out = j_fused(xa, wt, emit=emit,
                      scale_row=xa.scale.reshape(-1, 1), scale_col=wt.scale)
        return ((np.asarray(out.residues), np.asarray(out.scale))
                if emit == "residues" else np.asarray(out))
    if form == "gated":
        return np.asarray(j_fused(xa, wt, scale_row=(xa.scale * 0.5)
                                  .reshape(-1, 1), scale_col=wt.scale,
                                  gate=jnp.asarray(gate)))
    sx = jax.jit(jquant.quant_scale)(xj)
    if form == "quantize":
        return np.asarray(j_fused(xj, wt, quantize=True, scale_row=sx,
                                  scale_col=wt.scale))
    wq, sw = jax.jit(jquant.quantize_int8, static_argnames="axis")(wj,
                                                                   axis=0)
    return np.asarray(j_fused(xj, wq, jb, quantize=True, scale_row=sx,
                              scale_col=sw))


def _bytes(out):
    if isinstance(out, tuple):
        return tuple(_bytes(o) for o in out)
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor)
                      else out).tobytes()


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("layout,form", W.LAUNCH_CASES)
def test_sharded_launch_bit_equal(work, n, layout, form):
    results, _, (x, w, gate) = work
    port = _bytes(W.launch_outputs(x, w, gate, layout, form))
    ref = _bytes(_reference_launch(x, w, gate, form))
    assert port == ref
    for rank, got in enumerate(results[n]["launch"]):
        assert _bytes(got[(layout, form)]) == port, rank


@pytest.fixture(scope="module")
def int8_work(tmp_path_factory):
    """`rns_int_matmul`'s fused route (raw int8 x) on a 2-rank and a
    5-rank group: {n: (operands, [each rank's outputs])}."""
    tmp = tmp_path_factory.mktemp("dist_int8")
    out = {}
    for n in (2, 5):
        ops = W.int8_operands(n)
        out[n] = (ops, W.spawn_group(W.int8_task, n, tmp / f"group{n}",
                                     *ops))
    return out


@pytest.mark.parametrize("n", (2, 5))
def test_sharded_int_matmul_bit_equal(int8_work, n):
    """Raw int8 with each scale form (none, (N,), (M, 1), (M, N)), live and
    encoded weights, in both layouts (each launch resolved to the layout
    asked for): every rank bit-equal to the unsharded launch, which is the
    int64 product times the scale."""
    (x, w, scales), ranks = int8_work[n]
    want = W.int8_outputs(x, w, scales)
    exact = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
    for (lay, wname, sname), got in want.items():
        s = scales[sname]
        assert _bytes(got) == (exact if s is None else exact * s).tobytes()
    for rank, outs in enumerate(ranks):
        for lay in W.LAYOUTS:
            assert outs[(lay, "resolved")] == lay, (rank, lay)
        for key, got in want.items():
            assert _bytes(outs[key]) == _bytes(got), (rank, key)


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("arch,layout", ENGINE_CASES)
def test_sharded_engine_bit_equal(work, n, arch, layout):
    results, refs, _ = work
    ref = refs[arch]
    for rank, res in enumerate(results[n]["engine"]):
        got = res[(arch, layout)]
        assert got["host"] == ref["host"], rank
        assert got["scan"] == ref["host"], rank
        assert got["logits"].numpy().tobytes() == \
            ref["logits"].numpy().tobytes(), rank
        assert got["captured"] is False and got["replays"] == 0
    # the unsharded port against the reference's unsharded engine, at
    # every step whose top-2 gap is decisive
    for i, p in enumerate(W.PROMPTS):
        for step in range(W.NEW_TOKENS):
            a = ref["jax"][i][len(p) + step]
            b = ref["host"][i][len(p) + step]
            if ref["gaps"][i, step] <= NEAR_TIE:
                break
            assert a == b, (i, step)


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_scheduler_tokens_equal_unsharded(work, n, arch):
    results, refs, _ = work
    for rank, res in enumerate(results[n]["sched"]):
        got = res[(arch, None)]
        assert got["tokens"] == refs[arch]["sched"], rank
        assert got["stats"] == refs[arch]["sched_stats"], rank
        assert got["admissions"] == len(W.SCHED_REQUESTS), rank
        assert got["captured"] is False
        # sharded: its launches ran as channel slices
        assert got["calls"].get("rns_fused_crt_partial", 0) > 0, rank
    assert refs[arch]["sched_stats"]["prefix_hits"] > 0


@pytest.mark.parametrize("n", GROUPS)
def test_sharded_engine_launches(work, n):
    """The fused smoke model's generate of 2 tokens: on 2 ranks the C = 4
    launches run as channel slices and the C = 5 down projection falls
    back to columns; on 4 ranks likewise (C = 4 splits one channel a
    rank)."""
    results, _, _ = work
    cfg = get_smoke_config(ARCHS[0])
    L = cfg.num_layers
    for res in results[n]["engine"]:
        calls = res[(ARCHS[0], "channel")]["generate_calls"]
        # two steps (prefill, one decode), 6 channel + 1 column launch a
        # layer, and the 7 weight encodes do not run here
        assert calls.get("rns_fused_crt_partial") == 2 * 6 * L
        assert calls.get("rns_fused_matmul") == 2 * L
        col = res[(ARCHS[0], "column")]["generate_calls"]
        assert col.get("rns_fused_matmul") == 2 * 7 * L
        assert "rns_fused_crt_partial" not in col
        # every engine: a step's launches as read off the placed weights
        for case in ENGINE_CASES:
            got, want = res[case]["generate_calls"], \
                res[case]["decode_launches"]
            assert {k: got.get(k, 0) for k in want} == \
                {k: 2 * v for k, v in want.items()}, case


def _summary(collectives):
    s = TraceSummary(*[Counter() for _ in range(6)])
    s.collectives = list(collectives)
    return s


@pytest.mark.parametrize("n", GROUPS)
def test_channel_decode_wire_is_reduced(work, n):
    """The resident smoke model's decode step under the channel layout.
    On 2 ranks every basis (C = 4 and the chain's 6) splits: only int32
    limb planes and float outputs cross, and `check_reduced_wire` is
    clean.  On 4 ranks the chain basis does not split, so the up
    projection (an ``emit="residues"`` launch, N = 128) falls back to
    columns and gathers its (6, M, N) int8 slab: the check flags exactly
    that.  A planted all-reduce of a (4, 2, 16) int8 stack is flagged."""
    results, _, _ = work
    cfg = get_smoke_config("rns-smollm-135m-resident-sharded")
    bases = launch_bases(cfg)
    channels = {len(b.moduli) for b in bases}
    limbs = {crt_tables(b)[2] for b in bases}
    chain = max(channels)
    for rank, res in enumerate(results[n]["wire"]):
        assert any(name == "all_reduce" for name, _ in res["step"]), rank
        assert res["calls"].get("rns_fused_crt_partial", 0) > 0
        slabs = [(name, shape) for name, ops in res["step"]
                 for shape, dtype in ops if dtype not in ("int32", "float32")]
        rep = check_reduced_wire(_summary(res["step"]), channels,
                                 nlimbs=limbs, subject="decode/channel")
        if chain % n == 0:
            assert not slabs and rep.ok, (slabs, rep.findings)
        else:
            assert slabs and all(shape[0] == chain for _, shape in slabs)
            assert len(rep.findings) == len(slabs)
        planted = check_reduced_wire(_summary(res["planted"]), {4},
                                     subject="planted")
        assert not planted.ok and "residues crossed" in str(planted.findings)


def test_engine_refuses_layout_without_mesh_and_hopeless_mesh():
    cfg = get_smoke_config("rns-smollm-135m-fused")
    with pytest.raises(ValueError, match="without mesh"):
        Engine(cfg, _weights(ARCHS[0])[1], smax=64, device="cpu",
               dist_layout="channel")
    sharded = get_smoke_config(ARCHS[0])          # bases C = 4 and 5
    with pytest.raises(ValueError, match="NO launch basis is divisible"):
        make_context(sharded, Mesh({"data": 1, "model": 3}))
    with pytest.raises(ValueError, match="NO launch basis"):
        Engine(sharded, _weights(ARCHS[0])[1], smax=64, device="cpu",
               mesh=Mesh({"data": 1, "model": 3}))
    # a preference, not a demand: "auto" and "column" accept that mesh
    for lay in ("auto", "column"):
        assert make_context(sharded, Mesh({"data": 1, "model": 3}),
                            layout=lay).nshards == 3
    assert make_context(sharded, Mesh({"model": 2})).layout == "channel"
    with pytest.raises(ValueError, match="no 'model'"):
        make_context(sharded, Mesh({"data": 2}))


def test_one_shard_and_no_context_are_the_plain_launch():
    """Without a context, or on a one-rank axis, `sharded_fused_matmul` IS
    `rns_fused_matmul`; a placed shard refuses to run without its
    context."""
    from repro_torch.core.rns_tensor import RNSShard
    from repro_torch.dist.context import DistContext
    from repro_torch.dist.rns_shard import sharded_fused_matmul

    x, w, gate = W.launch_operands(seed=1)
    want = _bytes(W.launch_outputs(x, w, gate, "channel", "quantize"))
    one = DistContext(mesh=Mesh({"data": 4, "model": 1}), layout="channel")
    for ctx in (None, one):
        assert _bytes(W.launch_outputs(x, w, gate, "channel", "quantize",
                                       ctx)) == want
    basis = basis_for_int8_matmul(64)
    shard = RNSShard(residues=torch.zeros((2, 64, 32), dtype=torch.int8),
                     scale=torch.ones((1, 32)), basis=basis, nshards=2,
                     n_global=32, cols=((0, 0, 32),))
    with pytest.raises(ValueError, match="DistContext"):
        sharded_fused_matmul(torch.zeros((8, 64)), shard,
                             scale_row=torch.ones((8, 1)),
                             scale_col=shard.scale)
    assert dataclasses.replace(shard, index=1).shape == (64, 32)


def test_ops_entry_names_coerce_moduli():
    """`kernels.ops`, the reference's entry names: moduli of any integer
    sequence reach the wrappers as Python ints, and `rns_reverse` takes
    moduli (its plan built from them)."""
    from repro_torch.kernels import fold, ops, rns_forward, rns_modmul

    moduli = basis_for_int8_matmul(64).moduli
    mods = np.asarray(moduli, dtype=np.int64)
    x = torch.arange(-300, 300, dtype=torch.int32)
    res = ops.rns_forward(x, mods)
    assert torch.equal(res, rns_forward(x, tuple(moduli)))
    assert torch.equal(ops.rns_reverse(res, mods), x.to(torch.float32))
    assert torch.equal(ops.rns_modmul(res, res, mods),
                       rns_modmul(res, res, tuple(moduli)))
    vals = torch.arange(0, 4000, dtype=torch.int32).repeat(len(moduli), 1)
    assert torch.equal(ops.fold(vals, mods, np.int64(4000)),
                       fold(vals, tuple(moduli), 4000))
    a = ops.rns_forward(torch.randint(-127, 128, (1, 4, 8),
                                      dtype=torch.int32), mods,
                        dtype=torch.int8)[:, 0]
    b = ops.rns_forward(torch.randint(-127, 128, (8, 5), dtype=torch.int32),
                        mods, dtype=torch.int8)
    assert ops.rns_matmul(a, b, mods).shape == (len(moduli), 4, 5)
