"""Layout rules of the port: `src/repro_torch`, `chip_smoke.py`,
`tile_phases.py`, `wg_phases.py`, `convert_bench.py`, `tile_bench.py` and
the edge cases `chip_smoke.py` shares with the card tests
(`tests/_convert_cases.py`) import neither JAX nor the reference
package; every module of the port imports first, in a fresh set of
modules (no import cycle); and entry points use the CPU only when
asked."""
import ast
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import SlotScheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tile_phases.py", ROOT / "wg_phases.py",
    ROOT / "convert_bench.py", ROOT / "tile_bench.py",
    ROOT / "tests" / "_convert_cases.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py"))

# one interpreter imports torch once, then each module of the port with
# every `repro_torch` module dropped from sys.modules before it, as a
# program that imports that module first would
_FIRST_IMPORTS = """
import importlib, json, sys, traceback
import torch
errors = {}
for name in sys.argv[1:]:
    for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[m]
    try:
        importlib.import_module(name)
    except Exception:
        errors[name] = traceback.format_exc(limit=-2)
print(json.dumps(errors))
"""


@functools.lru_cache(maxsize=None)
def _first_import_errors():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _FIRST_IMPORTS,
                          *PORT_MODULES], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", PORT_MODULES)
def test_module_imports_first(name):
    err = _first_import_errors().get(name)
    assert err is None, f"importing {name} first fails:\n{err}"


def test_scan_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "tile_phases.py", "wg_phases.py",
            "convert_bench.py", "tile_bench.py", "src/repro_torch/kernels/rns_fused.py",
            "src/repro_torch/kernels/rns_matmul.py",
            "src/repro_torch/kernels/rns_modmul.py",
            "src/repro_torch/kernels/rns_convert.py",
            "src/repro_torch/kernels/fold.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/dist/rns_shard.py",
            "src/repro_torch/dist/context.py",
            "src/repro_torch/dist/comms.py",
            "src/repro_torch/dist/engine.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/sharding.py",
            "src/repro_torch/train/compression.py",
            "src/repro_torch/kernels/ops.py",
            "src/repro_torch/core/linear_spec.py",
            "src/repro_torch/core/rns_linear.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/serve/paged_cache.py",
            "src/repro_torch/serve/scheduler.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/configs/hymba_1_5b.py",
            "src/repro_torch/configs/mamba2_1_3b.py",
            "src/repro_torch/configs/gemma2_2b.py",
            "src/repro_torch/configs/moonshot_v1_16b_a3b.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/trainstep.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/train/runtime.py",
            "src/repro_torch/launch/train.py"} <= names
    assert {"repro_torch.models.ssm", "repro_torch.models.moe",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.configs.phi_3_vision_4_2b",
            "repro_torch.train", "repro_torch.train.tree",
            "repro_torch.launch.train", "repro_torch.dist.context",
            "repro_torch.dist.comms", "repro_torch.dist.engine",
            "repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.train.compression",
            "repro_torch.kernels.ops"} <= set(PORT_MODULES)


def test_dist_package_imports_light():
    """`core.rns_linear` imports `repro_torch.dist.context` on every fused
    launch: the package loads the standard library only (no torch, no
    `torch.distributed`, no sharded launch)."""
    code = ("import sys, repro_torch.dist; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'repro_torch', 'numpy')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["['repro_torch',", "'repro_torch.dist',",
                                  "'repro_torch.dist.context']"]


def test_engine_mesh_scan_is_uncaptured():
    """An Engine built with a mesh never captures its scan step (a CUDA
    graph cannot hold a gloo collective); one without a mesh captures on
    CUDA only."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_smoke_config("rns-smollm-135m-sharded")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert Engine(cfg, params, smax=32, device="cpu").captured is False
    with pytest.raises(ValueError, match="without mesh"):
        Engine(cfg, params, smax=32, device="cpu", dist_layout="column")
    eng = Engine(cfg, params, smax=32, device="cpu",
                 mesh=Mesh({"data": 1, "model": 1}))
    assert eng.captured is False and eng._dist_ctx.nshards == 1
    # a one-rank model axis serves as the unsharded engine does
    want = Engine(cfg, params, smax=32, device="cpu").generate([[3, 4, 5]],
                                                               4)
    assert eng.generate([[3, 4, 5]], 4) == want


def test_engine_without_device_needs_cuda(monkeypatch):
    cfg = get_smoke_config("rns-smollm-135m-fused")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, smax=32)
    assert Engine(cfg, params, smax=32, device="cpu").device.type == "cpu"


def test_scheduler_without_device_needs_cuda(monkeypatch):
    cfg = get_smoke_config("rns-smollm-135m-fused")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotScheduler(cfg, params, slots=2, block_size=4, slot_tokens=16)
    sched = SlotScheduler(cfg, params, slots=2, block_size=4, slot_tokens=16,
                          device="cpu")
    assert sched.device.type == "cpu"
    assert sched._cache["sub0"]["k"].device.type == "cpu"


def test_trainer_without_device_needs_cuda(monkeypatch, tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", "rns-smollm-135m-fused", "--smoke", "--steps", "1",
            "--batch", "2", "--seq", "8", "--workdir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv)
    assert not (tmp_path / "ckpt").exists()
    res = train.main(argv + ["--device", "cpu"])
    assert len(res["losses"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "rns-smollm-smoke-fused" and out["steps_run"] == 1
    assert out["tokens_per_step"] == 16


def test_trainer_default_workdir_is_fresh_each_run(monkeypatch, tmp_path,
                                                   capsys):
    """Without --workdir each run trains in a new directory under TMPDIR,
    so a second run of the same command resumes nothing and trains its
    steps again."""
    import tempfile
    from repro_torch.launch import train
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "rns-smollm-135m-fused", "--smoke", "--steps", "1",
            "--batch", "2", "--seq", "8", "--device", "cpu"]
    dirs = []
    for _ in range(2):
        assert len(train.main(argv)["losses"]) == 1
        captured = capsys.readouterr()
        assert json.loads(captured.out)["steps_run"] == 1
        dirs.append(captured.err.split("workdir: ")[1].split()[0])
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert os.path.dirname(d) == str(tmp_path)
        assert os.path.isfile(os.path.join(d, "metrics.jsonl"))
