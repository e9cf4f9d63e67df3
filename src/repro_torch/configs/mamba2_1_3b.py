"""mamba2-1.3b [ssm] (arXiv:2405.21060; unverified).

48L d_model=2048, attention-free SSD (state-space duality), ssm_state=128,
headdim 64, expand 2, no MLP sublayer (d_ff=0), vocab 50280.  Pure SSM ⇒
O(1)-state decode ⇒ long_500k RUNS.
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280,
        attention="none", ssm=True, ssm_state=128, ssm_head_dim=64,
        ssm_expand=2, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=128,
        attention="none", ssm=True, ssm_state=8, ssm_head_dim=16,
        ssm_expand=2, ssm_chunk=8, tie_embeddings=True,
    )


register("mamba2-1.3b", full, smoke)
