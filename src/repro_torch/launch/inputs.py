"""Abstract inputs of every (arch × shape) dry-run cell, port of
`repro/launch/inputs.py`: tensors on ``torch.device("meta")``, shapes and
dtypes with no data and no allocation.  Embedding-frontend archs get
frame or patch embeddings (the reference's frontend stub), the others
token ids.  The parameters are built from `transformer.param_spec` (the
generator `make_params` draws from has nothing to serve on meta); a config
that serves encoded weights gets the encoded :class:`RNSTensor`s, as
`serve.engine.encoded_params` makes them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import Leaf
from repro_torch.serve.engine import encoded_params

__all__ = ["input_specs", "abstract_params", "abstract_cache", "META"]

META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs of one cell (tokens or embeds, and labels to train)."""
    B, S = shape.global_batch, shape.seq_len
    s_in = 1 if shape.kind == "decode" else S   # one token against S slots
    out: Dict[str, Any] = {}
    if cfg.frontend == "embeddings":
        out["embeds"] = torch.empty((B, s_in, cfg.d_model),
                                    dtype=torch.bfloat16, device=META)
    else:
        out["tokens"] = torch.empty((B, s_in), dtype=torch.int32,
                                    device=META)
    if shape.kind == "train":
        out["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    return out


def _meta(node, dtype: torch.dtype, lead: tuple):
    if isinstance(node, Leaf):
        return torch.empty(lead + tuple(node.shape),
                           dtype=node.dtype or dtype, device=META)
    return {k: _meta(v, dtype, lead) for k, v in node.items()}


def abstract_params(cfg: ModelConfig, *, encoded: bool = True):
    """The parameters of ``cfg`` on meta, in `make_params`' layout; with
    ``encoded``, as the config serves them (`encoded_params`)."""
    dtype = getattr(torch, cfg.param_dtype)
    params = {k: _meta(v, dtype, (cfg.n_blocks,) if k == "blocks" else ())
              for k, v in T.param_spec(cfg).items()}
    if encoded:
        with torch.inference_mode():
            params = encoded_params(cfg, params)
    return params


def abstract_cache(cfg: ModelConfig, batch: int, smax: int):
    return T.init_cache(cfg, batch, smax, META)
