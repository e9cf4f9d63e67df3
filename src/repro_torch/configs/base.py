"""Model and shape configuration and the registry, port of
`repro/configs/base.py`: every architecture registers its published
configuration and a smoke twin of the same family, with the reference's
training fields (remat, its policy and the optimizer) and the shapes its
dry run skips (``skip_shapes``); `SHAPES` are the dry run's global
(seq_len × global_batch) cells.  ``dist_layout`` is the layout preference
an Engine built with a mesh reads (`repro_torch.dist`), and
``grad_compression`` the int8 gradient all-reduce the cost model bills
(`train/compression.py`).  The reference's ``attn_impl`` is fixed at its
default (blocked attention), and ``scan_layers`` has no counterpart (a
Python loop runs the layers)."""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.linear_spec import LinearSpec

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config",
           "get_smoke_config", "list_archs", "ARCH_MODULES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention: "full" (every layer causal), "swa" (every layer but
    # ``global_layers`` a sliding window of ``window``), "local_global"
    # (even layers local, odd global: gemma2) or "none" (pure SSM)
    attention: str = "full"
    window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    pos: str = "rope"                     # rope | sinusoidal
    rope_theta: float = 10000.0
    qk_norm: bool = False
    post_norm: bool = False               # gemma2's post-sublayer norms

    # MoE: top-k routing with capacity dispatch
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                    # 1: every layer; 2: dense/MoE pairs
    shared_expert: bool = False
    moe_d_ff: int = 0                     # expert hidden width (d_ff if 0)
    capacity_factor: float = 1.25

    # SSM (Mamba2 SSD): pure (attention "none") or beside attention
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    hybrid: bool = False                  # parallel attention + SSM heads

    frontend: str = "tokens"              # tokens | embeddings
    norm_eps: float = 1e-6
    act: str = "silu"                     # silu | gelu (tanh form)
    glu: bool = True
    tie_embeddings: bool = False
    # "bf16" or "rns_int8[:auto|pallas|pallas_fused]": every projection
    # through `core/rns_linear` on the fused kernel or the staged kernels.
    linear_backend: str = "bf16"
    # Encode the linear weights to residues once at Engine init.
    encode_weights: bool = False
    # "float" or "residue": stacked QKV and the GLU MLP stay in the residue
    # domain between launches (needs encode_weights).
    linear_domain: str = "float"
    # "none" | "auto" | "channel" | "column": the layout preference of
    # sharded serving (`repro_torch.dist`), read only by an Engine built
    # with a mesh: "channel" splits the residue channels C over "model",
    # "column" the output columns N, "auto" picks per launch by wire bytes
    dist_layout: str = "none"
    param_dtype: str = "bfloat16"
    # training: remat one layer at a time, recomputing the whole layer
    # ("full"), all but the mixer's and the MLP's outputs ("save_ar") or
    # nothing ("none"); the optimizer (`train/optimizer.make_optimizer`)
    remat: bool = True
    remat_policy: str = "full"            # full | save_ar | none
    optimizer: str = "adamw"              # adamw | adafactor
    grad_compression: bool = False        # int8 all-reduce of the gradients
    attn_block_kv: int = 1024         # key block of the online softmax
    # shapes of `SHAPES` the dry run skips (a full-attention stack has no
    # sub-quadratic structure for long_500k)
    skip_shapes: Tuple[str, ...] = ()

    @functools.cached_property
    def linear_spec(self) -> LinearSpec:
        """The structured datapath of every projection (built once)."""
        return dataclasses.replace(LinearSpec.parse(self.linear_backend),
                                   encode_weights=self.encode_weights,
                                   domain=self.linear_domain,
                                   dist=self.dist_layout)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def layers_per_block(self) -> int:
        return max(1, self.moe_every)

    @property
    def n_blocks(self) -> int:
        assert self.num_layers % self.layers_per_block == 0
        return self.num_layers // self.layers_per_block

    def window_for_layer(self, layer: int, seq_len: int) -> int:
        """Attention window of ``layer`` (a full causal layer gets
        max(seq_len, 2^30))."""
        full = max(seq_len, 1 << 30)
        if self.attention == "swa":
            return self.window if layer not in self.global_layers else full
        if self.attention == "local_global":
            return self.window if layer % 2 == 0 else full
        return full

    def mlp_kind(self, layer: int) -> str:
        if not self.moe:
            return "mlp"
        return ("moe" if layer % self.moe_every == self.moe_every - 1
                else "mlp")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                             # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}
ARCH_MODULES = (
    "musicgen_large", "moonshot_v1_16b_a3b", "llama4_maverick_400b_a17b",
    "smollm_135m", "gemma2_2b", "yi_34b", "h2o_danube_1_8b", "hymba_1_5b",
    "mamba2_1_3b", "phi_3_vision_4_2b", "rns_paper",
)


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


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)
