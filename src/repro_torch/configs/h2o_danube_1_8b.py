"""h2o-danube-1.8b [dense] (arXiv:2401.16818).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 — llama+mistral mix
with sliding-window attention (4096) on every layer.  SWA ⇒ O(window) ring
caches ⇒ long_500k RUNS (bounded memory, sub-quadratic decode).
"""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=80, d_ff=6912, vocab_size=32000,
        attention="swa", window=4096,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, attention="swa", window=8,
    )


register("h2o-danube-1.8b", full, smoke)
