"""gemma2-2b [dense] (arXiv:2408.00118).

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab=256000;
alternating local(4096-window)/global attention, logit softcaps (attn 50,
final 30), GeGLU, post-sublayer norms.  Half the layers are global full
attention ⇒ long_500k skipped (no sub-quadratic structure on those layers).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
        head_dim=256, d_ff=9216, vocab_size=256000,
        attention="local_global", window=4096,
        softcap_attn=50.0, softcap_final=30.0, post_norm=True,
        act="gelu", tie_embeddings=True, skip_shapes=("long_500k",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        attention="local_global", window=8,
        softcap_attn=50.0, softcap_final=30.0, post_norm=True,
        act="gelu", tie_embeddings=True,
    )


register("gemma2-2b", full, smoke)
