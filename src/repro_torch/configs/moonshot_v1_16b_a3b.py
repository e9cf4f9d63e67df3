"""moonshot-v1-16b-a3b [moe] (hf:moonshotai/Moonlight-16B-A3B).

48L d_model=2048 16H (kv=16) vocab=163840, MoE 64 experts top-6 with expert
d_ff=1408 (the assignment's d_ff), every layer MoE.  Full attention ⇒
long_500k skipped.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163840,
        moe=True, num_experts=64, top_k=6, moe_every=1, moe_d_ff=1408,
        attention="full", skip_shapes=("long_500k",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=128,
        moe=True, capacity_factor=8.0, num_experts=4, top_k=2, moe_every=1, moe_d_ff=96,
    )


register("moonshot-v1-16b-a3b", full, smoke)
