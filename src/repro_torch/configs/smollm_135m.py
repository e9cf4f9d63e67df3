"""smollm-135m [dense] (hf:HuggingFaceTB/SmolLM-135M): 30L d_model=576 9H
(GQA kv=3) d_ff=1536 vocab=49152, SwiGLU, RoPE, tied embeddings — the
published widths, as in `repro/configs/smollm_135m.py`: every linear a
plain bf16 matmul."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        num_layers=30, d_model=576, num_heads=9, num_kv_heads=3, head_dim=64,
        d_ff=1536, vocab_size=49152, tie_embeddings=True,
        skip_shapes=("long_500k",))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, tie_embeddings=True)


register("smollm-135m", full, smoke)
