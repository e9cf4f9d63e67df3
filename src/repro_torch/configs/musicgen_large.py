"""musicgen-large [audio]: decoder-only over EnCodec tokens (arXiv:2306.05284).

48L d_model=2048 32H (MHA, kv=32) d_ff=8192 vocab=2048.  The EnCodec frontend
is a stub per the assignment: the backbone consumes the (precomputed) audio
token stream; positions are classic sinusoidal (musicgen uses learned/sine
positional embeddings, sine here).  Full attention ⇒ long_500k skipped
(DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=8192, vocab_size=2048,
        attention="full", pos="sinusoidal", act="gelu", glu=False,
        skip_shapes=("long_500k",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, attention="full", pos="sinusoidal",
        act="gelu", glu=False,
    )


register("musicgen-large", full, smoke)
