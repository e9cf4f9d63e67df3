"""The port's cost layer (`repro_torch.launch.costs`, `roofline`) against
the reference's (`repro.launch`): `analytic_cost` equal to a relative 1e-12
on every config both packages register × `SHAPES` × the reference's meshes
(1×1, 16×16, 2×16×16) × modes, breakdown included; `model_flops_for`
equal; the analytic flops within the reference's own tolerances
(`tests/test_costs.py`) of the flops the residency pass counts over the
port's `forward` on meta at the reference's ``WIDE`` widths; the cache
byte formulas equal to the port's allocated caches; the reference's
accounting tests on the port."""
import dataclasses
import functools
import math

import pytest
import torch

import repro.models.transformer as RT
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.configs.base import list_archs as ref_archs
from repro.launch import costs as RC
from repro.launch import roofline as RR
from repro_torch.analysis.residency import TraceMode
from repro_torch.configs.base import (SHAPES, ShapeConfig, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.launch import costs as TC
from repro_torch.launch import roofline as TRL
from repro_torch.launch.inputs import abstract_params, input_specs
from repro_torch.models import transformer as T

SHARED = sorted(set(list_archs()) & set(ref_archs()))
MESHES = [(1, 1, 1), (1, 16, 16), (2, 16, 16)]     # (n_pods, data, model)
MODES = ["tp", "dp", "fsdp_tp"]


@pytest.fixture(autouse=True)
def _memo_ref_counts(monkeypatch):
    """The reference counts parameters by tracing `make_params` each call;
    memoize per config (the count depends on the config alone)."""
    for name in ("count_params", "active_params"):
        monkeypatch.setattr(RT, name, _memo(getattr(RT, name)))


@functools.lru_cache(maxsize=None)
def _memo(fn):
    return functools.lru_cache(maxsize=None)(fn)


def _close(a, b, rel=1e-12):
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def test_shapes_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    assert len(SHARED) >= 15


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", SHARED)
def test_analytic_cost_equals_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for n_pods, data, model in MESHES:
        for mode in MODES:
            kw = dict(n_pods=n_pods, data=data, model=model, mode=mode)
            got = TC.analytic_cost(cfg, SHAPES[shape], **kw).as_dict()
            want = RC.analytic_cost(rcfg, REF_SHAPES[shape], **kw).as_dict()
            assert got["breakdown"].keys() == want["breakdown"].keys()
            for k in ("flops", "flops_int8", "hbm_bytes", "ici_bytes"):
                assert _close(got[k], want[k]), (kw, k, got[k], want[k])
            for k, v in want["breakdown"].items():
                assert _close(got["breakdown"][k], v), (kw, k)


@pytest.mark.parametrize("arch", SHARED)
def test_model_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    n, na = T.count_params(cfg), T.active_params(cfg)
    assert (n, na) == (RT.count_params(rcfg), RT.active_params(rcfg))
    for name, shape in SHAPES.items():
        assert TRL.model_flops_for(cfg, shape, n, na) == \
            RR.model_flops_for(rcfg, REF_SHAPES[name], n, na)


# the reference's validation widths (tests/test_costs.py), without its
# scan_layers=False: the port runs its layers in a Python loop
WIDE = dict(num_layers=2, d_model=1024, num_heads=8, num_kv_heads=4,
            head_dim=128, d_ff=4096, vocab_size=8192, remat=False,
            attn_block_kv=4096, ssm_chunk=256)


def _counted_flops(cfg, B, S):
    """Float flops the residency pass counts over `forward` on meta."""
    params = abstract_params(cfg)
    batch = input_specs(cfg, ShapeConfig("v", S, B, "prefill"))
    with torch.no_grad(), TraceMode(flops=True) as mode:
        T.forward(cfg, params, batch)
    return sum(mode.summary.flops.values())


@pytest.mark.parametrize("arch,extra,tol", [
    ("smollm-135m", {}, 0.10),
    ("mamba2-1.3b", dict(num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
                         ssm_state=64, ssm_head_dim=64), 0.10),
    ("moonshot-v1-16b-a3b", dict(num_experts=8, top_k=2, moe_d_ff=1408,
                                 capacity_factor=1.25), 0.20),
    ("hymba-1.5b", dict(ssm_state=16, ssm_head_dim=64, global_layers=(0,)),
     0.35),
])
def test_analytic_matches_counted_at_width(arch, extra, tol):
    cfg = dataclasses.replace(get_smoke_config(arch), **{**WIDE, **extra})
    B, S = 2, 256
    counted = _counted_flops(cfg, B, S)
    an = TC.analytic_cost(cfg, ShapeConfig("v", S, B, "prefill"),
                          n_pods=1, data=1, model=1).flops
    assert abs(an - counted) / counted < tol, \
        f"{arch}: analytic {an:.3e} counted {counted:.3e}"


def test_train_multiplier():
    """Train = 3×fwd without remat, up to 4×(blocks) + 3×(head) with."""
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), **WIDE)
    fw = TC.analytic_cost(cfg, ShapeConfig("p", 128, 2, "prefill"),
                          n_pods=1, data=1, model=1)
    tr = TC.analytic_cost(cfg, ShapeConfig("t", 128, 2, "train"),
                          n_pods=1, data=1, model=1)
    assert abs(tr.flops / fw.flops - 3.0) < 1e-6
    tr_r = TC.analytic_cost(dataclasses.replace(cfg, remat=True),
                            ShapeConfig("t", 128, 2, "train"),
                            n_pods=1, data=1, model=1)
    assert 3.0 < tr_r.flops / fw.flops <= 4.0


def test_decode_memory_bound_on_h100():
    """A one-token decode step streams its weights: on H100 constants the
    memory term exceeds the compute term."""
    cfg = get_config("yi-34b")
    c = TC.analytic_cost(cfg, SHAPES["decode_32k"], n_pods=1, data=1,
                         model=1)
    assert c.hbm_bytes / TRL.HBM_BW > c.flops / TRL.PEAK_FLOPS
    rec = {"n_devices": 1, "analytic": c.as_dict(), "model_flops": 1.0}
    assert TRL.analyze(rec).dominant == "memory"


def test_rns_weight_conversion_dropped_when_encoded():
    live = dataclasses.replace(get_smoke_config("rns-smollm-135m"), **WIDE)
    enc = dataclasses.replace(live, encode_weights=True)
    shp = ShapeConfig("d", 128, 2, "decode")
    c_live = TC.analytic_cost(live, shp, n_pods=1, data=1, model=1)
    c_enc = TC.analytic_cost(enc, shp, n_pods=1, data=1, model=1)
    assert c_live.breakdown["flops_weight_conv"] > 0
    assert c_enc.breakdown["flops_weight_conv"] == 0.0
    assert c_enc.flops_int8 < c_live.flops_int8
    assert "rns_channels" in c_live.breakdown
    bf = dataclasses.replace(live, linear_backend="bf16")
    assert "flops_weight_conv" not in TC.analytic_cost(
        bf, shp, n_pods=1, data=1, model=1).breakdown


def test_h100_constants_are_the_data_sheet():
    assert (TRL.PEAK_FLOPS, TRL.PEAK_INT8_OPS, TRL.F32_FLOPS, TRL.HBM_BW,
            TRL.NVLINK_BW, TRL.HBM_BYTES) == (989e12, 1979e12, 67e12,
                                              3.35e12, 450e9, 80e9)


def _nbytes(tree):
    from repro_torch.analysis.residency import tensors
    return sum(t.numel() * t.element_size() for t in tensors(tree))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b", "hymba-1.5b",
                                  "h2o-danube-1.8b", "gemma2-2b"])
def test_decode_cache_bytes_exact(arch):
    """The static reservation is the allocation, byte for byte, across
    attention kinds (full, SSM, hybrid, sliding-window ring, local/global
    mix), and equals the reference's formula."""
    cfg = get_smoke_config(arch)
    cache = T.init_cache(cfg, 3, 32, "cpu")
    assert TC.decode_cache_bytes(cfg, 3, 32) == _nbytes(cache)
    from repro.configs.base import get_smoke_config as ref_smoke
    assert TC.decode_cache_bytes(cfg, 3, 32) == \
        RC.decode_cache_bytes(ref_smoke(arch), 3, 32)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b"])
def test_paged_cache_bytes_exact(arch):
    from repro_torch.serve.paged_cache import (init_paged_cache,
                                               paged_cache_nbytes)
    cfg = get_smoke_config(arch)
    cache = init_paged_cache(cfg, 7, 4, 2, device="cpu")
    assert TC.paged_cache_bytes(cfg, 7, 4, 2) == paged_cache_nbytes(cache)
    assert TC.paged_cache_bytes(cfg, 7, 4, 2) == _nbytes(cache)


def test_roofline_table_and_records(tmp_path):
    rec = {"arch": "a", "shape": "s", "mesh": "1x1", "status": "ok",
           "n_devices": 1, "model_flops": 2.0e12,
           "analytic": {"flops": 4.0e12, "flops_int8": 0.0,
                        "hbm_bytes": 1.0e9, "ici_bytes": 0.0}}
    a = TRL.analyze(rec)
    assert a.dominant == "compute" and math.isclose(a.bound_s, 4e12 / 989e12)
    assert math.isclose(a.roofline_fraction, 0.5)
    skip = {"arch": "b", "shape": "s", "mesh": "1x1", "status": "skip",
            "reason": "why"}
    table = TRL.format_table([rec, skip])
    assert "**compute**" in table and "SKIP (why)" in table
    path = tmp_path / "r.jsonl"
    import json
    path.write_text(json.dumps(rec) + "\n\n" + json.dumps(skip) + "\n")
    assert TRL.load_records(str(path)) == [rec, skip]
