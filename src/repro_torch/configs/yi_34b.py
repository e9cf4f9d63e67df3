"""yi-34b [dense] (arXiv:2403.04652).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — llama-arch GQA,
SwiGLU, RoPE.  Full attention ⇒ long_500k skipped.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20480, vocab_size=64000,
        attention="full", rope_theta=5000000.0,
        skip_shapes=("long_500k",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=192, vocab_size=128,
    )


register("yi-34b", full, smoke)
