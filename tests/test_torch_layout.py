"""Layout rules of the port: `src/repro_torch`, `chip_smoke.py`,
`tile_phases.py`, `convert_bench.py` and the edge cases `chip_smoke.py`
shares with the card tests (`tests/_convert_cases.py`) import neither JAX
nor the reference package, and entry points use the CPU only when
asked."""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tile_phases.py",
    ROOT / "convert_bench.py", ROOT / "tests" / "_convert_cases.py"]
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


def test_scan_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "tile_phases.py", "convert_bench.py",
            "src/repro_torch/kernels/rns_fused.py",
            "src/repro_torch/kernels/rns_matmul.py",
            "src/repro_torch/kernels/rns_modmul.py",
            "src/repro_torch/kernels/rns_convert.py",
            "src/repro_torch/kernels/fold.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/dist/rns_shard.py",
            "src/repro_torch/core/linear_spec.py",
            "src/repro_torch/core/rns_linear.py",
            "src/repro_torch/serve/engine.py"} <= names


def test_engine_without_device_needs_cuda(monkeypatch):
    cfg = get_smoke_config("rns-smollm-135m-fused")
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, smax=32)
    assert Engine(cfg, params, smax=32, device="cpu").device.type == "cpu"
