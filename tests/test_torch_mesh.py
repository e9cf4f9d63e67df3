"""The mesh dry run (`launch.dryrun.run_cell(mesh=)`) and what it stands on,
on the CPU: the fake-group production mesh (`launch.mesh.
fake_production_mesh`), placements from specs (`launch.sharding.
to_placements` / `distribute`), the kernel entries on DTensors
(`kernels/dtensor_rules.py`), the dispatch trace's collectives and their
ring pricing (`launch.roofline.collective_bytes`).

Against the reference: `collective_bytes` equals `repro.launch.roofline.
collective_bytes` on synthetic HLO lines (its roofline module only;
`repro.launch.dryrun` sets ``XLA_FLAGS`` on import), the cells' parameter
counts and MODEL_FLOPS equal the reference's committed cells
(`experiments/dryrun.jsonl`), and ``analytic`` equals the reference's
`analytic_cost` to 1e-12 relative on both meshes.
"""
import json
import math
import pathlib

import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.launch import costs as jcosts
from repro.launch import roofline as jroof
from repro_torch.analysis.residency import TraceMode
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.costs import analytic_cost
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.launch.sharding import P, distribute, to_placements

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "rns-smollm-135m-fused"
META = torch.device("meta")

# (op, HLO result type, operand type): one collective of each kind
HLO_OPS = {
    "all-reduce": ("f32[1024,512]", "f32[1024,512]"),
    "all-gather": ("bf16[256,128]", "bf16[16,128]"),
    "reduce-scatter": ("f32[64,128]", "f32[1024,128]"),
    "all-to-all": ("s32[16,64]", "s32[16,64]"),
    "collective-permute": ("bf16[128,8]", "bf16[128,8]"),
}


def _hlo_line(op, n):
    out, arg = HLO_OPS[op]
    groups = (f"source_target_pairs={{{{0,1}},{{1,0}}}}"
              if op == "collective-permute"
              else f"replica_groups=[{16 // n},{n}]<=[16]")
    return (f"  %{op}.1 = {out}{{1,0}} {op}({arg}{{1,0}} %p.0), {groups}, "
            "dimensions={0}\n")


def _out_bytes(op):
    dt, dims = HLO_OPS[op][0].rstrip("]").split("[")
    return math.prod(int(d) for d in dims.split(",")) * {
        "f32": 4, "bf16": 2, "s32": 4}[dt]


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("op", sorted(HLO_OPS))
def test_collective_bytes_equal_reference(op, n):
    want = jroof.collective_bytes(_hlo_line(op, n), default_group=n)
    got = RL.collective_bytes([(op, _out_bytes(op), n)])
    assert got == want
    # several at once sum by op, as the reference's text does
    text = _hlo_line(op, n) + _hlo_line("all-reduce", n)
    assert RL.collective_bytes([(op, _out_bytes(op), n),
                                ("all-reduce", _out_bytes("all-reduce"),
                                 n)]) == jroof.collective_bytes(
        text, default_group=n)


def test_fake_mesh_is_torn_down():
    assert not dist.is_initialized()
    with fake_production_mesh() as mesh:
        assert mesh.shape == {"data": 16, "model": 16}
        assert dist.get_world_size() == 256
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="inside"):
        with fake_production_mesh(multi_pod=True) as mesh:
            assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
            raise RuntimeError("inside")
    assert not dist.is_initialized()
    with fake_production_mesh(split=(64, 4)) as mesh:
        assert mesh.shape == {"data": 64, "model": 4}
    assert not dist.is_initialized()


def test_placements_from_specs():
    from torch.distributed.tensor import Replicate, Shard

    with fake_production_mesh(multi_pod=True) as mesh:
        assert to_placements(mesh, P(("pod", "data"), "model")) == [
            Shard(0), Shard(0), Shard(1)]
        assert to_placements(mesh, P(None, None)) == [Replicate()] * 3
        tree = {"w": torch.empty(64, 32, device=META),
                "b": [torch.empty(8, device=META)]}
        out = distribute(mesh, tree, {"w": P("data", "model"),
                                      "b": [P(None)]})
        assert out["w"].to_local().shape == (4, 2)
        assert out["b"][0].placements == (Replicate(),) * 3


def _toy(fn, *placed):
    """Run ``fn`` on DTensors over a (2, 4) fake mesh under the mesh
    trace; returns the trace summary."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    with fake_production_mesh(split=(2, 4)) as mesh:
        args = [distribute_tensor(
            torch.empty(shape, dtype=dt[0] if dt else torch.float32,
                        device=META),
            mesh.device_mesh, to_placements(mesh, spec))
            for shape, spec, *dt in placed]
        trace = TraceMode(flops=True, dtensor=True)
        with trace, implicit_replication():
            fn(*args)
    return trace.summary


def test_toy_step_counts_per_device_and_prices_redistribution():
    M, K, N = 64, 128, 256
    # column parallel: each device multiplies its quarter of the columns
    s = _toy(torch.matmul, ((M, K), P(None, None)), ((K, N), P(None,
                                                              "model")))
    assert s.flops["aten.mm"] == 2 * M * K * N / 4
    assert s.wire == []
    # replicated: every device does all of it
    s = _toy(torch.matmul, ((M, K), P(None, None)), ((K, N), P(None, None)))
    assert s.flops["aten.mm"] == 2 * M * K * N
    # row parallel then an elementwise op: the partial sums are reduced
    # inside the op, which the trace sees and prices
    s = _toy(lambda x, w: torch.nn.functional.gelu(x @ w),
             ((M, K), P(None, "model")), ((K, N), P("model", None)))
    assert s.flops["aten.mm"] == 2 * M * K * N / 4
    ops = {op for op, _, n in s.wire}
    assert ops & {"all-reduce", "reduce-scatter"} and all(
        n == 4 for _, _, n in s.wire)
    priced = RL.collective_bytes(s.wire)
    assert sum(v for k, v in priced.items()
               if not k.endswith("_output_bytes")) > 0


def test_fused_kernel_rule_keeps_rows_and_columns():
    """rns_fused_matmul on DTensors: x's rows and the weight's columns stay
    sharded; a K-sharded weight is gathered first (one collective), and
    the call counts its local shapes."""
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.kernels import rns_fused_matmul
    from torch.distributed.tensor import Shard

    M, K, N = 32, 64, 128
    seen = {}

    def fused(x, w, srow, scol):
        out = rns_fused_matmul(x, w, basis_for_int8_matmul(K),
                               scale_row=srow, scale_col=scol)
        seen["placements"] = out.placements
        seen["local"] = tuple(out.to_local().shape)

    s = _toy(fused, ((M, K), P("data", None)),
             ((K, N), P(None, "model"), torch.int8),
             ((M, 1), P("data", None)), ((1, N), P(None, "model")))
    assert seen == {"placements": (Shard(0), Shard(1)),
                    "local": (M // 2, N // 4)}
    assert s.kernel_calls["rns_fused_matmul"] == 1 and s.wire == []
    s = _toy(fused, ((M, K), P("data", None)),
             ((K, N), P("model", None), torch.int8),
             ((M, 1), P("data", None)), ((1, N), P(None, None)))
    assert seen["placements"][1].is_replicate()
    assert [op for op, _, _ in s.wire] == ["all-gather"]


@pytest.fixture(scope="module")
def cells():
    cfg = get_config(ARCH)
    out = {name: D.run_cell(cfg, SHAPES[name], arch=ARCH, mesh="16x16")
           for name in ("decode_32k", "train_4k", "long_500k")}
    assert not dist.is_initialized()       # no group left behind
    return out


def _committed():
    with open(ROOT / "experiments" / "dryrun.jsonl") as f:
        return {(r["arch"], r["shape"], r["mesh"]): r
                for r in map(json.loads, f)}


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_mesh_cells_match_committed_reference(cells, shape):
    rec = cells[shape]
    assert rec["status"] == "ok", rec.get("error")
    want = _committed()[(ARCH, shape, "16x16")]
    for k in ("n_params", "n_active", "model_flops", "mode", "n_devices"):
        assert rec[k] == want[k], k
    assert set(rec) >= {"mesh", "mode", "n_devices", "n_params", "n_active",
                        "model_flops", "cost", "memory", "collectives",
                        "analytic", "roofline", "kernel_calls", "fits",
                        "seconds"}
    assert set(rec["collectives"]) <= set(want["collectives"]) | {
        "reduce-scatter", "reduce-scatter_output_bytes", "all-to-all",
        "all-to-all_output_bytes"}
    # per device: 30 layers × 7 fused launches a forward (14 with the
    # train step's recompute), local shards on every device
    calls = 210 if shape == "decode_32k" else 420
    assert rec["kernel_calls"] == {"rns_fused_matmul": calls}
    assert 0 < rec["memory"]["argument_bytes"] < want["memory"][
        "argument_bytes"] * 4
    an = rec["analytic"]
    assert rec["roofline"]["collective_s"] == an["ici_bytes"] / RL.IB_BW
    assert rec["roofline"]["link_bw"] == RL.IB_BW == 50e9


def test_long_context_cell_skips(cells):
    assert cells["long_500k"]["status"] == "skip"


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_analytic_equals_reference(multi_pod, shape):
    cfg, jcfg = get_config(ARCH), jbase.get_config(ARCH)
    got = analytic_cost(cfg, SHAPES[shape], n_pods=2 if multi_pod else 1,
                        data=16, model=16, mode="tp").as_dict()
    want = jcosts.analytic_cost(jcfg, jbase.SHAPES[shape],
                                n_pods=2 if multi_pod else 1, data=16,
                                model=16, mode="tp").as_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k


def test_cli_records_and_skips_done_cells(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    argv = ["--arch", ARCH, "--shape", "decode_32k", "--mesh", "16x16",
            "--tag", "t", "--out", str(out)]
    assert D.main(argv) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["status"], r["tag"]) for r in recs] == [
        ("16x16", "ok", "t")]
    assert D.main(argv) == 0                       # recorded: skipped
    assert len(out.read_text().splitlines()) == 1
    assert "SKIP (done)" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_error_cell_is_recorded_with_its_op(monkeypatch):
    def broken(*a, **k):
        def thunk():
            x = torch.empty(4, device=META)
            return x.nonzero()                 # data-dependent on meta
        return thunk, ()

    monkeypatch.setattr(D, "_step", broken)
    rec = D.run_cell(get_config(ARCH), SHAPES["decode_32k"], mesh="16x16")
    assert rec["status"] == "error" and rec["op"] == "aten.nonzero"
    assert not dist.is_initialized()
