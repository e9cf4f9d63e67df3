"""The port's static gate (`repro_torch.analysis`) against the reference's
(`repro.analysis`): the bound pass's known-bad corpus and tightness pins,
the admissibility pass on (tm, splits) launches and tune-table rows, the
schema validators, the lint over the port's registry, the interval
domain, ``Engine(verify="static")``, and `check_config` reporting the same
findings as the reference's for every ported config, full and smoke.  The
trace passes (``absint``, ``residency``) have files of their own,
`tests/test_torch_absint.py` and `tests/test_torch_residency.py`."""
import json

import pytest
import torch

import repro.analysis as ran
import repro_torch.analysis as tan
from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as ref_smoke
from repro.core.channel_plan import ChannelPlan as RefPlan
from repro.core.rns import basis_for_chain as ref_chain
from repro.core.rns import basis_for_int8_matmul as ref_int8
from repro_torch.analysis import (AnalysisError, Interval, PipelineSpec,
                                  check_channel_plan, check_pipeline)
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.folding import INT32_SAFE
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.kernels import rns_fused as rf
from repro_torch.kernels import tune

PORTED = ["smollm-135m", "rns-smollm-135m", "rns-smollm-135m-encoded",
          "rns-smollm-135m-fused", "rns-smollm-135m-resident",
          "rns-smollm-135m-pallas"]


def _messages(report):
    return " | ".join(str(f) for f in report.findings)


def _strs(report):
    return [str(f) for f in report.findings]


# ===================================================== bounds: known-bad ====
def test_bounds_flags_pre_pr3_signed_128_regime():
    """A fold plan sized for self-quantized ±127 operands is undersized
    when external int8 reaches −128; the runtime's plan is clean."""
    mods = basis_for_int8_matmul(64).moduli
    k = 64
    pre = ChannelPlan.build(mods, bound=k * 127 * max(m - 1 for m in mods),
                            signed=True)
    derived = k * 128 * max(m - 1 for m in mods)
    rep, _ = check_channel_plan(pre, operand_bound=derived)
    assert not rep.ok and "undersized" in _messages(rep)
    ref_pre = RefPlan.build(mods, bound=k * 127 * max(m - 1 for m in mods),
                            signed=True)
    assert _strs(rep) == _strs(ran.check_channel_plan(
        ref_pre, operand_bound=derived)[0])
    fixed = ChannelPlan.for_matmul(mods, k, signed=True)
    rep_ok, _ = check_channel_plan(fixed, operand_bound=derived)
    assert rep_ok.ok, _messages(rep_ok)


def test_bounds_flags_undersized_chain_basis_at_large_dff():
    """The chain basis of reference `tests/test_analysis.py:47`: d_ff 1536
    on `basis_for_int8_matmul` cannot hold the gated three-factor product;
    `check_pipeline` names the deficit and raises through
    `raise_if_failed`, with the reference's findings."""
    F = 1536
    spec = PipelineSpec.for_basis(basis_for_int8_matmul(F), F, x_bound=127,
                                  w_bound=127, residue_in=True, gate=True,
                                  label="undersized-chain")
    rep, _ = check_pipeline(spec)
    assert not rep.ok
    msg = _messages(rep)
    assert "dynamic range deficit" in msg and "basis_for_chain" in msg
    ref_spec = ran.PipelineSpec.for_basis(ref_int8(F), F, x_bound=127,
                                          w_bound=127, residue_in=True,
                                          gate=True,
                                          label="undersized-chain")
    assert _strs(rep) == _strs(ran.check_pipeline(ref_spec)[0])
    with pytest.raises(AnalysisError, match="dynamic range deficit"):
        rep.raise_if_failed()
    with pytest.raises(AnalysisError, match="dynamic range deficit"):
        tan.assert_clean(None, spec)
    ok = PipelineSpec.for_basis(basis_for_chain(F), F, x_bound=127,
                                w_bound=127, residue_in=True, gate=True)
    assert check_pipeline(ok)[0].ok


def test_bounds_flags_gate_plus_emit():
    spec = PipelineSpec.for_basis(basis_for_chain(192), 192, x_bound=127,
                                  w_bound=127, residue_in=True, gate=True,
                                  emit="residues")
    rep, _ = check_pipeline(spec)
    assert not rep.ok and "K·127³" in _messages(rep)


def test_bounds_flags_int32_accumulator_overflow_naming_channel_and_k():
    k = 200_000
    rep, _ = check_pipeline(PipelineSpec(moduli=(127, 1021), k=k,
                                         x_bound=128))
    msg = _messages(rep)
    assert not rep.ok and "channel m=1021" in msg and f"K={k}" in msg
    assert "overflow" in msg
    assert _strs(rep) == _strs(ran.check_pipeline(ran.PipelineSpec(
        moduli=(127, 1021), k=k, x_bound=128))[0])


# ==================================================== bounds: tightness ====
def test_bounds_value_interval_matches_kernel_saturated_corner():
    k = 64
    rep, stages = check_pipeline(PipelineSpec.for_basis(
        basis_for_int8_matmul(k), k))
    assert rep.ok, _messages(rep)
    assert stages["value"] == Interval.symmetric(k * 128 * 128)


def test_bounds_accumulator_interval_matches_plan_bound():
    mods = basis_for_int8_matmul(96).moduli
    k = 96
    _, st = check_pipeline(PipelineSpec(moduli=mods, k=k, x_bound=128))
    assert st["accumulator"].max_abs == ChannelPlan.for_matmul(
        mods, k, signed=True).bound
    _, st2 = check_pipeline(PipelineSpec(moduli=mods, k=k, x_bound=127,
                                         w_bound=127, residue_in=True))
    assert st2["accumulator"].hi == ChannelPlan.for_matmul(
        mods, k, signed=False).bound


def test_bounds_requant_interval_is_exact_at_corner():
    rep, stages = check_pipeline(PipelineSpec.for_basis(
        basis_for_chain(192), 192, x_bound=127, w_bound=127,
        residue_in=True, emit="residues"))
    assert rep.ok, _messages(rep)
    assert stages["requant"] == Interval.symmetric(127)


@pytest.mark.parametrize("k", [64, 576, 1536])
@pytest.mark.parametrize("signed", [True, False])
def test_fold_ladder_replay_equals_reference(k, signed):
    """Every rung of the runtime's fold schedules replays inside int32 and
    canonicalizes within n_sub subtracts, interval for interval with the
    reference's replay."""
    mods = basis_for_int8_matmul(k).moduli
    plan = ChannelPlan.for_matmul(mods, k, signed=signed)
    rep, finals = check_channel_plan(plan)
    assert rep.ok, _messages(rep)
    for m, iv in finals.items():
        assert iv.hi < (plan.n_sub + 1) * m
    _, ref_finals = ran.check_channel_plan(RefPlan.for_matmul(mods, k,
                                                              signed=signed))
    assert {m: (iv.lo, iv.hi) for m, iv in finals.items()} == \
        {m: (iv.lo, iv.hi) for m, iv in ref_finals.items()}


@pytest.mark.parametrize("case", [
    dict(k=64), dict(k=1536), dict(k=576, x_bound=127, w_bound=127,
                                   residue_in=True),
    dict(k=192, x_bound=127, w_bound=127, residue_in=True,
         emit="residues", chain=True),
    dict(k=1536, x_bound=127, w_bound=127, residue_in=True, gate=True,
         chain=True),
    dict(k=192, x_bound=200, w_bound=127, residue_in=True, emit="residues",
         chain=True),
    dict(k=64, gate=True)], ids=lambda c: "-".join(f"{k}{v}" for k, v
                                                    in c.items()))
def test_check_pipeline_equals_reference(case):
    """Findings and every stage interval equal the reference's."""
    case = dict(case)
    chain = case.pop("chain", False)
    k = case["k"]
    basis = basis_for_chain(k) if chain else basis_for_int8_matmul(k)
    rbasis = ref_chain(k) if chain else ref_int8(k)
    rep, st = check_pipeline(PipelineSpec.for_basis(basis, **case))
    rrep, rst = ran.check_pipeline(ran.PipelineSpec.for_basis(rbasis,
                                                              **case))
    assert _strs(rep) == _strs(rrep)
    assert {k: (v.lo, v.hi) for k, v in st.items()} == \
        {k: (v.lo, v.hi) for k, v in rst.items()}


# ======================================================= admissibility =====
def test_admissibility_flags_bad_launches_and_wide_modulus():
    """A height that is not compiled, splits past the cluster, a split
    block without a K step, the 32-row tile on 8 channels or odd shapes or
    split, the 64-row tile on an operand other than raw int8, and an
    instance that is not compiled — each named."""
    cases = [((48, 1), "not compiled"), ((rf.TM, 9), "K splits"),
             ((rf.TM_MMA, 2), "never splits")]
    for blocks, what in cases:
        rep = tan.check_launch(64, 576, 576, 5, blocks)
        assert not rep.ok and what in _messages(rep), blocks
    assert tan.check_launch(64, 576, 576, 5, (rf.TM_WG, 1)).ok
    rep = tan.check_launch(64, 576, 576, 5, (rf.TM_WG, 1), x_channels=True)
    assert "raw int8" in _messages(rep)
    rep = tan.check_launch(8, 64, 64, 5, (rf.TM, 8))
    assert "without a K step" in _messages(rep)
    rep = tan.check_launch(512, 1536, 576, 8, (rf.TM_MMA, 1),
                           x_channels=True)
    assert "compiled for C <= 7" in _messages(rep)
    rep = tan.check_launch(512, 200, 70, 5, (rf.TM_MMA, 1))
    assert "multiples of 4" in _messages(rep)
    # the one form compiled without a live-weight instance: residue planes
    rep = tan.check_launch(8, 576, 576, 1, (rf.TM, 1), x_channels=True,
                           encoded=False)
    assert "no 16-row instance" in _messages(rep)
    assert tan.check_launch(8, 576, 576, 1, (rf.TM, 1), dtype="int8").ok
    assert tan.check_launch(8, 576, 1536, 5, (rf.TM, 6),
                            dtype="bfloat16").ok
    assert tan.check_launch(512, 1536, 576, 7, (rf.TM_MMA, 1),
                            x_channels=True).ok
    rep2 = tan.check_basis_tables([(1 << 16) + 1], subject="wide")
    assert not rep2.ok and "15-bit Horner" in _messages(rep2)


def test_admissibility_budget_uses_the_footprint(monkeypatch):
    """The shared-memory budget is checked against `tune.smem_footprint`,
    the launch's own mirror."""
    monkeypatch.setattr(tune, "SMEM_BUDGET_BYTES", 64 * 1024)
    rep = tan.check_launch(8, 1536, 576, 11, (rf.TM, 4), x_channels=True)
    assert "shared memory footprint" in _messages(rep)
    assert tan.check_launch(8, 1536, 576, 1, (rf.TM, 4),
                            x_channels=True).ok


def test_admissibility_flags_bad_tune_table_rows():
    kind = "NVIDIA-H100-80GB-HBM3"
    table = {
        f"fused/{kind}/bfloat16/C5/M8xK576xN576": [16, 6],           # fine
        "not-a-key": [16, 1],                                     # bad key
        f"fused/{kind}/bfloat16/C5/M8xK576xN192": [16, 1, 512],   # bad row
        f"fused_res/{kind}/int8/C8/M512xK1536xN576": [32, 1],     # C = 8
        f"fused/{kind}/bfloat16/C5/M8xK64xN64": [16, 8],          # no K step
    }
    rep = tan.check_tune_table(table)
    msg = _messages(rep)
    assert "not-a-key" in msg and "[tm, splits]" in msg
    assert "compiled for C <= 7" in msg and "without a K step" in msg
    assert len(rep.errors) == 4


def test_admissibility_committed_tune_table_is_clean():
    rep = tan.check_tune_table(json.loads(tune.COMMITTED_TABLE.read_text()))
    assert rep.ok, _messages(rep)


# ============================================================== schema ======
def test_schema_names_the_malformed_field():
    payload = {"bench": 9, "commit": "c", "device": "cpu", "failures": [],
               "smoke": False, "timestamp": "t",
               "rows": [{"name": "decode_x", "value": "fast"},
                        {"name": "decode_x", "value": 1.0}]}
    rep = tan.validate_bench(payload)
    msg = _messages(rep)
    assert "rows[0].value" in msg and "duplicate row name" in msg
    assert _strs(rep) == _strs(ran.validate_bench(payload))
    missing = dict(payload, rows=[])
    del missing["device"]
    assert any(f.where == "device" for f in tan.validate_bench(missing).errors)
    rep3 = tan.validate_tune_table({"a/b": [1, 2],
                                    "x/y/z/C4/M1xK2xN3": [16, 0],
                                    "x/y/z/C4/M1xK2xN4": [16, 1, 2],
                                    "x/y/z/C4/M1xK2xN5": [16, 1]})
    assert len(rep3.errors) == 3


def test_schema_files(tmp_path):
    good = tmp_path / "t.json"
    good.write_text(json.dumps({"a/b/c/C1/M1xK1xN1": [16, 1]}))
    assert tan.validate_tune_table_file(good).ok
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    assert "invalid JSON" in _messages(tan.validate_tune_table_file(bad))
    assert "cannot read" in _messages(
        tan.validate_bench_file(tmp_path / "missing.json"))


# ===================================================== zoo + engine gate ====
@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_check_config_equals_reference(arch, smoke):
    """`check_config` on each ported config reports the reference's
    findings (the float32 dequant warnings of the 1536-deep launches): the
    launch passes admit every (tm, splits) the port would run, as the
    reference's admit its tilings."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    rcfg = (ref_smoke if smoke else ref_config)(arch)
    rep = tan.check_config(cfg)
    assert rep.subject == f"config:{cfg.name}"
    assert _strs(rep) == _strs(ran.check_config(rcfg))
    assert rep.ok
    assert [s.label for s in tan.pipeline_specs_for(cfg)] == \
        [s.label for s in ran.pipeline_specs_for(rcfg)]


def test_lint_passes_on_registry(capsys):
    from repro_torch.analysis.lint import lint_arch, main

    for name in PORTED:
        for rep in lint_arch(name):
            assert rep.ok, _messages(rep)
    assert main(["--all-configs"]) == 0
    out = capsys.readouterr().out
    from repro_torch.configs.base import list_archs

    # every registered config, full and smoke, and the tune table
    assert f"# lint: {2 * len(list_archs()) + 1} subjects, 0 errors" in out
    assert main([]) == 2


def test_lint_fails_on_a_bad_table(tmp_path, capsys):
    from repro_torch.analysis.lint import main

    bad = tmp_path / "t.json"
    bad.write_text(json.dumps({"fused/x/int8/C9/M512xK64xN64": [32, 1]}))
    assert main(["--configs", "rns-smollm-135m-fused", "--tune-table",
                 str(bad)]) == 1
    assert "compiled for C <= 7" in capsys.readouterr().out


def test_engine_verify_static_accepts_and_rejects_as_reference():
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    cfg = get_smoke_config("rns-smollm-135m-resident")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = Engine(cfg, params, smax=32, verify="static", device="cpu")
    assert eng.cfg is cfg
    with pytest.raises(ValueError, match="verify"):
        Engine(cfg, params, smax=32, verify="dynamic", device="cpu")


def test_engine_verify_static_runs_before_any_encode(monkeypatch):
    """The gate runs first: a config it rejects raises AnalysisError and
    no weight is encoded."""
    import repro_torch.serve.engine as eng_mod
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("rns-smollm-135m-fused")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    encoded = []
    monkeypatch.setattr(eng_mod, "encode_params",
                        lambda *a, **k: encoded.append(1))

    def reject(c):
        rep = tan.Report(subject=f"config:{c.name}")
        rep.add("bounds", "test", "rejected")
        return rep

    monkeypatch.setattr("repro_torch.analysis.check_config", reject)
    with pytest.raises(AnalysisError, match="rejected"):
        eng_mod.Engine(cfg, params, smax=32, verify="static", device="cpu")
    assert not encoded


def test_interval_arithmetic_is_exact():
    a = Interval.symmetric(3)
    b = Interval(2, 5)
    assert a * b == Interval(-15, 15)
    assert a.dot(b, 10) == Interval(-150, 150)
    assert Interval(-7, 12).abs() == Interval(0, 12)
    assert Interval(0, 100).rung(4, 3) == Interval(0, 15 + 6 * 3)
    assert Interval.canonical(37).mod(37) == Interval(0, 36)
    assert tan.TOP + a == tan.TOP
    with pytest.raises(ValueError):
        Interval(5, 2)


def test_dtype_range_takes_torch_dtypes():
    assert tan.dtype_range(torch.int8) == Interval(-128, 127)
    assert tan.dtype_range(torch.int32).hi == INT32_SAFE
    assert tan.dtype_range("uint8") == Interval(0, 255)
    assert tan.dtype_range(torch.float32) is None
    for name in ("int8", "int16", "int32", "int64", "uint8"):
        got, want = tan.dtype_range(getattr(torch, name)), \
            ran.dtype_range(name)
        assert (got.lo, got.hi) == (want.lo, want.hi)
