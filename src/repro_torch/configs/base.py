"""Model configuration and registry, port of the dense fields of
`repro/configs/base.py`."""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict

from repro_torch.core.linear_spec import LinearSpec

__all__ = ["ModelConfig", "register", "get_config", "get_smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # the port serves "dense" only:
    # full causal attention, RoPE, SwiGLU MLP, one layer per block
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # "bf16" or "rns_int8[:auto|pallas|pallas_fused]": every projection
    # through `core/rns_linear` on the fused kernel or the staged kernels.
    linear_backend: str = "bf16"
    # Encode the linear weights to residues once at Engine init.
    encode_weights: bool = False
    # "float" or "residue": stacked QKV and the GLU MLP stay in the residue
    # domain between launches (needs encode_weights).
    linear_domain: str = "float"
    param_dtype: str = "bfloat16"
    attn_block_kv: int = 1024         # key block of the online softmax

    @functools.cached_property
    def linear_spec(self) -> LinearSpec:
        """The structured datapath of every projection (built once)."""
        return dataclasses.replace(LinearSpec.parse(self.linear_backend),
                                   encode_weights=self.encode_weights,
                                   domain=self.linear_domain)

    @property
    def n_blocks(self) -> int:
        return self.num_layers


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}
ARCH_MODULES = ("smollm_135m", "rns_paper")


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def _ensure_loaded() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _SMOKE:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_SMOKE)}")
    return _SMOKE[name]()

