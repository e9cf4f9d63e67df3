"""hymba-1.5b [hybrid] (arXiv:2411.13676).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + Mamba2 heads in every block (outputs per-branch normed
and mean-fused), SWA 1024 everywhere except 3 global full-attention layers
(first / middle / last).  Hybrid ⇒ long_500k RUNS (SSM state is O(1), SWA
caches are O(window); only the 3 global layers keep full caches).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001,
        attention="swa", window=1024, global_layers=(0, 16, 31),
        hybrid=True, ssm=True, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        attention="swa", window=8, global_layers=(0, 2),
        hybrid=True, ssm=True, ssm_state=4, ssm_head_dim=16, ssm_expand=2,
        ssm_chunk=8,
    )


register("hymba-1.5b", full, smoke)
