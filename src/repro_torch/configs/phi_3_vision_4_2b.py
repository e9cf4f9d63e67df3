"""phi-3-vision-4.2b [vlm] (hf:microsoft/Phi-3-vision-128k-instruct).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064 — phi3-mini backbone;
the CLIP vision frontend is a stub per the assignment: `input_specs()`
provides precomputed patch/frame embeddings of shape (B, S, d_model).
Full attention ⇒ long_500k skipped.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        attention="full", frontend="embeddings",
        skip_shapes=("long_500k",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, frontend="embeddings",
    )


register("phi-3-vision-4.2b", full, smoke)
