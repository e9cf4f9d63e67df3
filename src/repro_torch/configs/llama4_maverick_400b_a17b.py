"""llama4-maverick-400b-a17b [moe] (hf:meta-llama/Llama-4 family; unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 + shared expert, alternating dense/MoE layers (Maverick's interleave).

Parameter accounting (verified by tests against count_params):
  24 MoE layers × 128 experts × 3·5120·8192  ≈ 386.5B   (routed experts)
  + shared experts, dense MLPs, attention, embeddings ≈ 14B
  total ≈ 400B; active/token = backbone + top-1 expert + shared ≈ 17B.
Full attention ⇒ long_500k skipped.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        moe=True, num_experts=128, top_k=1, moe_every=2, shared_expert=True,
        moe_d_ff=8192, attention="full",
        optimizer="adafactor",            # AdamW state for 400B won't fit
        skip_shapes=("long_500k",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        moe=True, capacity_factor=8.0, num_experts=4, top_k=1, moe_every=2, shared_expert=True,
        moe_d_ff=128, optimizer="adafactor",
    )


register("llama4-maverick-400b-a17b", full, smoke)
