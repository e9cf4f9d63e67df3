"""The port's tile-kernel autotuner (`repro_torch.kernels.tune`): the
reference's `tests/test_tune.py` cases for ``[tm, splits]`` rows, the
admissibility filter, the fallbacks (CPU, a miss during graph capture, a
stored row the call cannot take), the launcher's use of the choice, and the
committed H100 table against every ported config's warmed decode shapes.
The sweep is injected, so everything here runs on the CPU."""
import ctypes
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import check_tune_table, validate_tune_table
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.rns_tensor import RNSTensor
from repro_torch.kernels import _build, tune
from repro_torch.kernels import rns_fused as rf

SMS = 132
H100 = "NVIDIA-H100-80GB-HBM3"
PORTED = ["rns-smollm-135m", "rns-smollm-135m-encoded",
          "rns-smollm-135m-fused", "rns-smollm-135m-resident",
          "rns-smollm-135m-pallas"]


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("RNS_TORCH_TUNE_CACHE", str(path))
    tune.clear_memory_cache()
    yield path
    tune.clear_memory_cache()


@pytest.fixture()
def fake_cuda(monkeypatch):
    """A CUDA device as far as the tuner can tell: its name, SM count and
    the capture predicate; the default sweep refuses to run."""
    monkeypatch.setattr(tune, "_kind", lambda index: H100)
    monkeypatch.setattr(_build, "num_sms", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])

    def explode(*args, **kwargs):
        raise AssertionError("the default sweep ran")

    monkeypatch.setattr(tune, "_default_sweep", explode)
    return capturing


def _static(M, K, N, C, vec=True, wg=False):
    return rf.static_choice(M, K, N, C, SMS, vec, wg)


def test_cpu_fallback_is_static_and_unpersisted(tune_cache):
    b = tune.blocks_for(64, 512, 64, 5, device="cpu")
    assert b == _static(64, 512, 64, 5)
    # the raw int8 operand (the default dtype) takes the 64-row tile, a
    # float one the 32-row tile
    assert tune.blocks_for(512, 576, 576, 5, device="cpu") == \
        _static(512, 576, 576, 5, wg=True) == (rf.TM_WG, 1)
    assert tune.blocks_for(512, 576, 576, 5, dtype="bfloat16",
                           device="cpu") == \
        _static(512, 576, 576, 5) == (rf.TM_MMA, 1)
    assert not tune_cache.exists()            # no table poisoning


def test_sweep_picks_best_and_persists(tune_cache):
    calls = []

    def sweep(blocks):
        calls.append(blocks)
        return 10.0 - blocks[1] + (5 if blocks[0] == rf.TM_MMA else 0)

    best = tune.blocks_for(256, 1024, 256, 5, sweep=sweep, device="cpu")
    assert best == min(calls, key=lambda b: 10.0 - b[1]
                       + (5 if b[0] == rf.TM_MMA else 0))
    assert best == (rf.TM, 8) and (rf.TM_MMA, 1) in calls
    assert len(calls) == len(set(calls)) >= 2        # swept, distinct
    table = json.loads(tune_cache.read_text())
    assert list(best) in table.values()
    assert tune.stats["sweeps"] >= 1


def test_table_hit_skips_sweep(tune_cache):
    first = tune.blocks_for(128, 512, 128, 5, sweep=lambda b: b[1],
                            device="cpu")

    def explode(blocks):
        raise AssertionError("swept despite a table hit")

    assert tune.blocks_for(128, 512, 128, 5, sweep=explode,
                           device="cpu") == first
    # the persisted table survives a new process (the memory cache dropped)
    tune.clear_memory_cache()
    assert tune.blocks_for(128, 512, 128, 5, sweep=explode,
                           device="cpu") == first


def test_candidates_are_normalized_and_admissible(tune_cache):
    """Splits collapse to the count a launch really makes (K = 96 is three
    K steps: 3..8 splits all make 3 blocks), the 32-row tile is never
    offered for 8 channels or at decode, and injected candidates that the
    kernel cannot take are dropped."""
    seen = []

    def sweep(blocks):
        seen.append(blocks)
        return 1.0

    tune.blocks_for(64, 96, 256, 5, sweep=sweep, device="cpu")
    assert sorted(seen) == [(rf.TM, 1), (rf.TM, 2), (rf.TM, 3),
                            (rf.TM_MMA, 1), (rf.TM_WG, 1)]
    seen.clear()
    # the 64-row tile takes only the raw int8 operand with K % 16 == 0
    tune.blocks_for(64, 96, 256, 5, backend="matmul_res", sweep=sweep,
                    device="cpu")
    assert rf.TM_WG not in {b[0] for b in seen}
    seen.clear()
    tune.blocks_for(64, 100, 256, 5, sweep=sweep, device="cpu")
    assert rf.TM_WG not in {b[0] for b in seen}
    seen.clear()
    tune.blocks_for(512, 1536, 576, 8, sweep=sweep, device="cpu")
    assert rf.TM_MMA not in {b[0] for b in seen}
    seen.clear()
    tune.blocks_for(8, 576, 576, 5, sweep=sweep, device="cpu")
    assert {b[0] for b in seen} == {rf.TM}
    seen.clear()
    tune.blocks_for(64, 1536, 576, 5, sweep=sweep, device="cpu",
                    candidates=[(48, 1), (rf.TM, 9), (rf.TM_MMA, 2),
                                (rf.TM, 4)])
    assert seen == [(rf.TM, 4)]


def test_persist_false_leaks_nothing(tune_cache):
    """An experimental (persist=False) sweep must not reach the shared
    table, in memory or on disk, through a later persisting call."""
    tune.blocks_for(128, 512, 128, 5, sweep=lambda b: b[1], persist=False,
                    device="cpu")
    assert not tune_cache.exists()
    swept = []
    tune.blocks_for(64, 256, 64, 5, sweep=lambda b: swept.append(b) or 1.0,
                    device="cpu")
    table = json.loads(tune_cache.read_text())
    assert len(table) == 1 and swept


def test_corrupt_table_recovers(tune_cache):
    tune_cache.write_text("{not json")
    tune.clear_memory_cache()
    assert tune.blocks_for(64, 512, 64, 5, device="cpu") == \
        _static(64, 512, 64, 5)
    tune_cache.write_text("[1, 2]")
    tune.clear_memory_cache()
    assert tune.blocks_for(64, 512, 64, 5, device="cpu") == \
        _static(64, 512, 64, 5)


def test_capture_miss_falls_back_and_never_sweeps(tune_cache, fake_cuda):
    """A miss while a graph is being captured takes the static rule,
    counts itself, writes nothing and is not memoized: the next eager call
    resolves the shape afresh."""
    fake_cuda["on"] = True
    before = tune.stats["capture_misses"]
    dev = torch.device("cuda", 0)
    kw = dict(device=dev, sms=SMS, vec=True, avec=True, launch=None)
    got = tune.choose("fused", "bfloat16", 8, 576, 1536, 5, **kw)
    assert got == _static(8, 576, 1536, 5)
    assert tune.stats["capture_misses"] == before + 1
    assert not tune_cache.exists()
    tune.choose("fused", "bfloat16", 8, 576, 1536, 5, **kw)
    assert tune.stats["capture_misses"] == before + 2
    # a hit during capture is no miss
    key = tune.shape_key(8, 576, 1536, 5, "bfloat16", "fused", kind=H100)
    tune_cache.write_text(json.dumps({key: [rf.TM, 2]}))
    tune.clear_memory_cache()
    assert tune.choose("fused", "bfloat16", 8, 576, 1536, 5, **kw) == \
        (rf.TM, 2)
    assert tune.stats["capture_misses"] == before + 2


def test_choose_hit_and_inadmissible_row(tune_cache, fake_cuda):
    """The launcher's resolution: a stored row it can take, the static
    rule for one it cannot (the 32-row tile needs aligned rows, which the
    key does not hold), and the static rule under `static_rule()`."""
    key = tune.shape_key(512, 576, 576, 5, "bfloat16", "fused", kind=H100)
    tune_cache.write_text(json.dumps({key: [rf.TM_MMA, 1]}))
    tune.clear_memory_cache()
    dev = torch.device("cuda", 0)
    kw = dict(device=dev, sms=SMS, launch=None)
    assert tune.choose("fused", "bfloat16", 512, 576, 576, 5, vec=True,
                       avec=True, **kw) == (rf.TM_MMA, 1)
    assert tune.choose("fused", "bfloat16", 512, 576, 576, 5, vec=True,
                       avec=False, **kw) == _static(512, 576, 576, 5, False)
    with tune.static_rule():
        tune_cache.write_text(json.dumps({key: [rf.TM, 3]}))
        tune.clear_memory_cache()
        assert tune.choose("fused", "bfloat16", 512, 576, 576, 5, vec=True,
                           avec=True, **kw) == _static(512, 576, 576, 5)
    assert tune.choose("fused", "bfloat16", 512, 576, 576, 5, vec=True,
                       avec=True, **kw) == (rf.TM, 3)


class _FakeLibrary:
    def __init__(self):
        self.args = []

    def rns_tile_launch(self, amode, args, plan, stream):
        a = ctypes.cast(args, ctypes.POINTER(_build.TileArgs)).contents
        self.args.append({f: getattr(a, f) for f, _ in a._fields_})
        return 0


@pytest.mark.parametrize("choice", [(16, 1), (16, 5), (32, 1)])
def test_launch_tile_launches_the_tuned_choice(monkeypatch, choice):
    """`launch_tile` hands the library the tuner's (tm, splits), with the
    K depth of each split block, counts the launch under that height, and
    names the variant in the key it asks for."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "num_sms", lambda index: SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    asked = []

    def choose(backend, dtype, M, K, N, C, **kw):
        asked.append((backend, dtype, M, K, N, C))
        return choice

    monkeypatch.setattr(tune, "choose", choose)
    M, K, N, C = 64, 1536, 576, 7
    x = torch.zeros(C, M, K, dtype=torch.int8)
    w = torch.zeros(C, K, N, dtype=torch.int8)
    out = torch.zeros(C, M, N, dtype=torch.int8)
    gate = torch.zeros(M, K, dtype=torch.int8)
    before = dict(rf.tile_launches)
    rf.launch_tile(rf.A_PLANES, rf.EMIT_RESIDUES, _build.Plan(), x=x, w=w,
                   out=out, M=M, K=K, N=N, C=C, gate=gate,
                   name="rns_fused_matmul")
    (args,) = lib.args
    assert (args["tm"], args["splits"]) == choice
    assert args["k_per_split"] == rf.k_per_split(K, choice[1])
    assert (choice[1] - 1) * args["k_per_split"] < K
    assert rf.tile_launches[choice[0]] == before[choice[0]] + 1
    assert asked == [("fused_res_emit_gate", "int8", M, K, N, C)]
    # a pinned height overrides the tuner
    with rf._pin_tile_rows(rf.TM):
        rf.launch_tile(rf.A_PLANES, rf.EMIT_RESIDUES, _build.Plan(), x=x,
                       w=w, out=out, M=M, K=K, N=N, C=C, gate=gate,
                       name="rns_fused_matmul")
    assert (lib.args[1]["tm"], lib.args[1]["splits"]) == \
        rf.static_choice(M, K, N, C, SMS)[:1] + (
            rf._split_k(M, K, N, SMS, rf.TM)[0],)
    assert len(asked) == 1


@pytest.mark.parametrize("name,amode,emit,gated,encoded,want", [
    ("rns_fused_matmul", rf.A_BF16, rf.EMIT_FLOAT, False, True,
     ("fused", "bfloat16")),
    ("rns_fused_matmul", rf.A_F32, rf.EMIT_FLOAT, False, False,
     ("fused_live", "float32")),
    ("rns_fused_matmul", rf.A_PLANES, rf.EMIT_RESIDUES, False, True,
     ("fused_res_emit", "int8")),
    ("rns_matmul", rf.A_SHARED, rf.EMIT_CANONICAL, False, True,
     ("matmul", "int8")),
    ("rns_fused_crt_partial", rf.A_PLANES, rf.EMIT_CRT_LIMBS, True, True,
     ("crt_res_gate", "int8"))])
def test_launch_variant_round_trips(name, amode, emit, gated, encoded,
                                    want):
    backend, dtype = rf.launch_variant(name, amode, emit, gated, encoded)
    assert (backend, dtype) == want
    p = tune.parse_shape_key(tune.shape_key(8, 576, 576, 5, dtype, backend,
                                            kind=H100))
    assert (p["amode"], p["emit"], p["gate"], p["encoded"]) == \
        (amode, emit == rf.EMIT_RESIDUES, gated, encoded)
    assert (p["M"], p["K"], p["N"], p["C"], p["device"]) == \
        (8, 576, 576, 5, H100)


def test_parse_shape_key_names_the_bad_segment():
    for bad, what in [("a/b/c", "5 segments"),
                      ("fused/x/int8/5/M1xK2xN3", "channel segment"),
                      ("fused/x/int8/C5/M1xK2", "shape segment"),
                      ("fused/x/int4/C5/M1xK2xN3", "dtype segment")]:
        with pytest.raises(ValueError, match=what):
            tune.parse_shape_key(bad)


def test_prepopulate_on_cpu_is_static_and_idempotent(tune_cache):
    n = tune.prepopulate(archs=["rns-smollm-135m-resident"], device="cpu")
    table = json.loads(tune_cache.read_text())
    assert n == len(table) > 0
    assert all(k.split("/")[1] == "cpu" for k in table)
    assert tune.prepopulate(archs=["rns-smollm-135m-resident"],
                            device="cpu") == 0
    assert check_tune_table(table).ok and validate_tune_table(table).ok
    for key, row in table.items():
        p = tune.parse_shape_key(key)
        assert tuple(row) == _static(p["M"], p["K"], p["N"], p["C"])


def test_cli_prepopulate_writes_out(tmp_path, monkeypatch):
    out = tmp_path / "t.json"
    monkeypatch.delenv("RNS_TORCH_TUNE_CACHE", raising=False)
    try:
        assert tune._main(["--prepopulate", "--out", str(out), "--archs",
                           "rns-smollm-135m-fused"]) == 0
    finally:
        tune.clear_memory_cache()
    assert len(json.loads(out.read_text())) == 2 * 4 * 4   # full + smoke


def _committed():
    return json.loads(tune.COMMITTED_TABLE.read_text())


def test_committed_table_is_admissible():
    table = _committed()
    assert table and validate_tune_table(table).ok
    rep = check_tune_table(table)
    assert rep.ok, [str(f) for f in rep.findings]
    assert {k.split("/")[1] for k in table} == {H100}


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_committed_table_covers_warmed_shapes(arch, smoke, monkeypatch):
    """Cold start on an H100: every shape `Engine.__init__` warms (the
    reference's batch sizes, and the scheduler's 8 slots among them) is a
    row of the committed table, so serving sweeps nothing."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    monkeypatch.setenv("RNS_TORCH_TUNE_CACHE", str(tune.COMMITTED_TABLE))
    monkeypatch.setattr(tune, "device_kind", lambda device=None: H100)
    tune.clear_memory_cache()
    try:
        report = tune.warm_for_config(cfg, device="cpu")
    finally:
        tune.clear_memory_cache()
    assert report and 8 in tune.ZOO_BATCH_SIZES
    misses = [r["key"] for r in report if not r["hit"]]
    assert not misses, (
        f"decode shapes missing from the committed table: {misses}; "
        "regenerate it on the card with `python -m repro_torch.kernels.tune "
        "--prepopulate --out src/repro_torch/kernels/tune_table_h100.json`")
    table = _committed()
    for r in report:
        assert list(r["blocks"]) == table[r["key"]]


def _spy_launches(monkeypatch):
    """Record the tuner key of every tile-kernel launch the wrappers would
    make, from their CPU calls."""
    rmm = importlib.import_module("repro_torch.kernels.rns_matmul")
    seen = []
    real_fused, real_mm = rf.rns_fused_matmul, rmm.rns_matmul

    def fused(x, w, basis=None, *, scale_row, scale_col, gate=None,
              emit="float"):
        res_in = isinstance(x, RNSTensor)
        wr = w.residues if isinstance(w, RNSTensor) else w
        C = len((w.basis if isinstance(w, RNSTensor) else
                 x.basis if res_in else basis).moduli)
        amode = rf.A_PLANES if res_in else (
            rf.A_BF16 if x.dtype == torch.bfloat16 else rf.A_F32)
        xr = x.residues if res_in else x
        seen.append(rf.launch_variant(
            "rns_fused_matmul", amode,
            rf.EMIT_RESIDUES if emit == "residues" else rf.EMIT_FLOAT,
            gate is not None, wr.ndim == 3)
            + (C, xr.shape[-2], xr.shape[-1], wr.shape[-1]))
        return real_fused(x, w, basis, scale_row=scale_row,
                          scale_col=scale_col, gate=gate, emit=emit)

    def matmul(a_res, b_res, moduli, *, signed_a=False, plan=None):
        C = len(moduli)
        amode = rf.A_SHARED if a_res.shape[0] < C else rf.A_PLANES
        seen.append(rf.launch_variant("rns_matmul", amode,
                                      rf.EMIT_CANONICAL, False, True)
                    + (C, a_res.shape[1], a_res.shape[2], b_res.shape[2]))
        return real_mm(a_res, b_res, moduli, signed_a=signed_a, plan=plan)

    monkeypatch.setattr(rf, "rns_fused_matmul", fused)
    monkeypatch.setattr(rmm, "rns_matmul", matmul)
    return seen


@pytest.mark.parametrize("arch", PORTED)
def test_decode_shapes_cover_real_decode_launches(arch, monkeypatch):
    """`decode_shapes_for` is not a guess: the tile launches of a real
    decode step (two lanes) of each ported smoke config are exactly the
    enumerated shapes at M = 2."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    cfg = get_smoke_config(arch)
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = Engine(cfg, params, smax=32, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 9)]
    seen = _spy_launches(monkeypatch)
    eng.generate(prompts, max_new_tokens=2, engine="host")
    decode = {s for s in seen if s[3] == 2}
    assert decode and all(s[3] in (2, 2 * 16) for s in seen)
    warm = {(s["backend"], s["dtype"], s["C"], s["M"], s["K"], s["N"])
            for s in tune.decode_shapes_for(cfg, (2,))}
    assert decode == warm


def test_engine_tune_report_on_cpu(tune_cache):
    """`Engine.tune_report` lists every warmed shape (with the engine's
    lanes): on the CPU each resolves by the static rule, unpersisted."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    cfg = get_smoke_config("rns-smollm-135m-resident")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = Engine(cfg, params, smax=32, lanes=3, device="cpu")
    want = tune.decode_shapes_for(cfg, (1, 2, 3, 4, 8))
    assert [r["key"] for r in eng.tune_report] == [
        tune.shape_key(s["M"], s["K"], s["N"], s["C"], s["dtype"],
                       s["backend"], kind="cpu") for s in want]
    assert not any(r["hit"] for r in eng.tune_report)
    assert not tune_cache.exists()
    bf16 = get_smoke_config("smollm-135m")
    assert Engine(bf16, T.make_params(bf16, torch.Generator().manual_seed(0),
                                      device="cpu"),
                  smax=32, device="cpu").tune_report == []


@pytest.mark.parametrize("C", range(1, 12))
def test_smem_footprint_mirror(C):
    """The Python mirror of the 16-row tile's shared memory: what the
    launcher would refuse is what `rns_tile16_smem` reports as 0 (held
    equal to the library on the card, `tests/test_torch_cuda.py`), every
    instance inside the 227 KB budget, the widest at C = 11."""
    for amode in (rf.A_F32, rf.A_BF16, rf.A_SHARED, rf.A_PLANES):
        for enc in (True, False):
            b = tune.smem_footprint(rf.TM, C, amode=amode, encoded=enc)
            compiled = enc or amode != rf.A_PLANES
            assert (b > 0) == compiled
            assert b <= tune.SMEM_BUDGET_BYTES
            m = tune.smem_footprint(rf.TM_MMA, C, amode=amode, encoded=enc)
            assert (m > 0) == (compiled and C <= rf._MMA_MAXC)
    assert tune.smem_footprint(rf.TM, 11, amode=rf.A_PLANES) == max(
        tune.smem_footprint(rf.TM, c, amode=a, encoded=e)
        for c in range(1, 12) for a in range(4) for e in (True, False))


def test_tuner_height_choice_for_raw_int8(tune_cache):
    """The tuner sweeps the 64-row tile for the raw int8 operand (and only
    there), persists it when it wins, and a stored 64-row row that the
    call's operands rule out resolves to the static rule."""
    seen = []

    def sweep(blocks):
        seen.append(blocks)
        return 1.0 if blocks[0] == rf.TM_WG else 2.0

    assert tune.blocks_for(512, 576, 1536, 5, sweep=sweep,
                           device="cpu") == (rf.TM_WG, 1)
    assert (rf.TM_MMA, 1) in seen
    assert [64, 1] in json.loads(tune_cache.read_text()).values()
    assert tune.blocks_for(512, 576, 1536, 5, device="cpu",
                           tma=False) == _static(512, 576, 1536, 5)
    why = tune.inadmissible((rf.TM_WG, 1), 512, 576, 1536, 5,
                            amode=rf.A_PLANES)
    assert why and "raw int8" in why[0]
    assert tune.inadmissible((rf.TM_WG, 1), 512, 576, 1536, 8,
                             amode=rf.A_SHARED)
    assert tune.inadmissible((rf.TM_WG, 1), 512, 584, 1536, 5,
                             amode=rf.A_SHARED)
    assert not tune.inadmissible((rf.TM_WG, 1), 512, 576, 1536, 5,
                                 amode=rf.A_SHARED)
    assert tune.smem_footprint(rf.TM_WG, 5, amode=rf.A_SHARED) == \
        1024 + 3 * (64 + 5 * 32) * 128 + 3 * 16
    assert tune.smem_footprint(rf.TM_WG, 5, amode=rf.A_PLANES) == 0
