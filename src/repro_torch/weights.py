"""Carry the reference's parameters into the port.

`from_jax_params` takes the pytree of `repro.models.transformer.make_params`
(every family's tree: attention, SSM, MoE and hybrid layers, one or two
layers a block) handed over as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's parameters:
the same key names and the same stacked ``(n_blocks, …)`` leaves, as torch
tensors on ``device``.  bfloat16 arrives as an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` rejects; it goes through float32, which
is lossless.  The port encodes the weights itself
(`core/rns_tensor.encode_params`): no residues are taken from JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

__all__ = ["from_jax_params"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Every leaf's path and shape, from `models.transformer.param_spec`
    (the block leaves with their leading ``n_blocks`` axis)."""
    out: Dict[str, tuple] = {}

    def walk(node, prefix, lead):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/", lead)
            else:
                out[f"{prefix}{k}"] = lead + tuple(v.shape)

    spec = T.param_spec(cfg)
    walk(spec.pop("blocks"), "blocks/", (cfg.n_blocks,))
    walk(spec, "", ())
    return out


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """Numpy pytree of the reference's parameters (any family) → torch
    dict.
    Raises if a leaf the port uses is missing or has another shape, or if
    the tree holds a leaf the port would ignore."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, path + "/")
            else:
                flat[path] = v

    walk(tree, "")
    want = _expected_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"parameter keys differ from {cfg.name}: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(want))}")
    out: Dict[str, Any] = {}
    for path, a in flat.items():
        if tuple(np.shape(a)) != want[path]:
            raise ValueError(f"{path}: shape {np.shape(a)}, {cfg.name} "
                             f"needs {want[path]}")
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(a, device)
    return out
