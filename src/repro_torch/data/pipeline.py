"""Deterministic, statelessly seekable synthetic LM data, port of
`repro/data/pipeline.py` (numpy only, bit-equal to it, host shards
included).

`batch_for_step(seed, step, ...)` is a pure function of its arguments, so
a restarted job resumes exactly where it stopped with no iterator state to
checkpoint: numpy's Philox counter RNG keyed by (seed, step, global row).

The token stream is learnable, an order-1 noisy affine Markov chain over
an effective alphabet of at most 256 ids of the vocabulary,

    x_{t+1} = (a·x_t + b + ε_t) mod V_eff,   ε_t ∈ {0, +1, −1} w.p. (0.8, 0.1, 0.1)

with (a, b) fixed per seed, so training shows a falling loss.  A host
shard generates only its [start, start + size) rows, keyed by the global
row index.
"""
from __future__ import annotations

import numpy as np

__all__ = ["batch_for_step", "host_shard_batch"]


def _rows(seed: int, step: int, rows: np.ndarray, seq_len: int,
          vocab: int) -> np.ndarray:
    """The given global batch rows of one step: (len(rows), S + 1) int32."""
    out = np.empty((len(rows), seq_len + 1), dtype=np.int32)
    v_eff = min(vocab, 256)
    a = 31 if v_eff > 31 else 3
    b = int(np.random.Generator(np.random.Philox(key=[seed, 0]))
            .integers(0, v_eff))
    for i, r in enumerate(rows):
        rng = np.random.Generator(
            np.random.Philox(key=[seed, (step << 20) + int(r)]))
        x = np.empty(seq_len + 1, dtype=np.int64)
        x[0] = rng.integers(0, v_eff)
        eps = rng.choice([0, 1, -1], size=seq_len, p=[0.8, 0.1, 0.1])
        for t in range(seq_len):
            x[t + 1] = (a * x[t] + b + eps[t]) % v_eff
        out[i] = x
    return out


def batch_for_step(seed: int, step: int, batch: int, seq_len: int,
                   vocab: int, start: int = 0, size: int | None = None):
    """{"tokens": (size, S), "labels": (size, S)} int32 of one step; the
    labels are the tokens shifted by one.  ``start``/``size`` select a host
    shard of the global batch (default: every row)."""
    size = batch if size is None else size
    seqs = _rows(seed, step, np.arange(start, start + size), seq_len, vocab)
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def host_shard_batch(seed: int, step: int, batch: int, seq_len: int,
                     vocab: int, host_index: int, host_count: int):
    """The rows host ``host_index`` of ``host_count`` generates (the global
    batch split evenly)."""
    if batch % host_count:
        raise ValueError(f"batch {batch} does not split over {host_count} "
                         "hosts")
    size = batch // host_count
    return batch_for_step(seed, step, batch, seq_len, vocab,
                          start=host_index * size, size=size)
