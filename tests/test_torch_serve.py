"""The port's serving engine on the smoke `rns-smollm-135m-fused` config, on
the CPU: greedy tokens against the reference `Engine.generate` under both
engines (``scan``, the default, and ``host``), batch invariance with pinned
lanes, the EOS latch, and sampling determinism.

Greedy tokens are held to the reference wherever the reference's top-2
logit gap exceeds 2·LOGIT_ATOL: `tests/test_torch_model.py` bounds each
logit's distance to the reference by LOGIT_ATOL, so only a gap below twice
that can flip the argmax.  At such a step a differing token ends the
comparison for that sequence (the prefixes differ from there on) and is
reported; it is not a failure.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs.base import get_smoke_config
from repro_torch.serve.engine import Engine
from repro_torch.weights import from_jax_params

NAME = "rns-smollm-135m-fused"
LOGIT_ATOL = 0.03          # the model tolerance of tests/test_torch_model.py
NEW = 8


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = jax_smoke_config(NAME), get_smoke_config(NAME)
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (JaxEngine(jcfg, jp, smax=32),
            Engine(tcfg, tp, smax=64, lanes=4, device="cpu"))


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _reference_gaps(eng, prompts, tokens):
    """Top-2 logit gap of the reference at every step of its own greedy
    path (teacher-forced through its prefill/decode executables)."""
    batch, plen = eng._pack(prompts)
    logits, cache, _ = eng._prefill(eng.params, batch, smax=eng.smax)
    gaps = []
    for t in range(NEW):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        if t == NEW - 1:
            break
        cur = jnp.asarray([seq[len(p) + t] for seq, p in zip(tokens, prompts)],
                          jnp.int32)
        pos = jnp.int32(plen + t)
        logits, cache = eng._decode(eng.params, cache, {"tokens": cur[:, None]},
                                    pos, positions=pos - batch["pad"])
    return np.stack(gaps, axis=1)                  # (B, NEW)


def _match_reference_where_decisive(jeng, teng, engine):
    prompts = _prompts(jeng.cfg.vocab_size, [3, 9, 14])
    want = jeng.generate(prompts, max_new_tokens=NEW, engine=engine)
    got = teng.generate(prompts, max_new_tokens=NEW, engine=engine)
    gaps = _reference_gaps(jeng, prompts, want)
    decisive, equal, flips = 0, 0, []
    for i, p in enumerate(prompts):
        for t in range(NEW):
            a, b = want[i][len(p) + t], got[i][len(p) + t]
            if gaps[i, t] > 2 * LOGIT_ATOL:
                assert a == b, (i, t, gaps[i, t])
                decisive += 1
            elif a != b:
                flips.append((i, t, float(gaps[i, t])))
                break
            equal += 1
    print(f"{engine}: {equal} tokens equal ({decisive} decisive); near-tie "
          f"flips {flips}")
    assert decisive > 0


def test_greedy_tokens_match_reference_where_decisive(engines):
    """Both packages' default engine, the on-device scan."""
    _match_reference_where_decisive(*engines, "scan")


def test_host_engine_tokens_match_reference_where_decisive(engines):
    _match_reference_where_decisive(*engines, "host")


def test_batch_invariance_with_lanes(engines):
    _, teng = engines
    prompts = _prompts(teng.cfg.vocab_size, [4, 17, 9])
    batched = teng.generate(prompts, max_new_tokens=NEW)
    for i, p in enumerate(prompts):
        assert teng.generate([p], max_new_tokens=NEW)[0] == batched[i]


def test_eos_latch(engines):
    _, teng = engines
    p = _prompts(teng.cfg.vocab_size, [6], seed=3)[0]
    free = teng.generate([p], max_new_tokens=NEW)[0][len(p):]
    first = teng.generate([p], max_new_tokens=NEW, eos_id=free[0])[0]
    assert first == p + free[:1]                 # EOS as the first token
    k = next((j for j in range(1, NEW) if free[j] not in free[:j]), None)
    if k is not None:                            # EOS mid-stream
        mid = teng.generate([p], max_new_tokens=NEW, eos_id=free[k])[0]
        assert mid == p + free[:k + 1]


def test_temperature_sampling_is_deterministic_per_seed(engines):
    _, teng = engines
    prompts = _prompts(teng.cfg.vocab_size, [5, 11])
    a = teng.generate(prompts, max_new_tokens=NEW, temperature=0.8, seed=7)
    b = teng.generate(prompts, max_new_tokens=NEW, temperature=0.8, seed=7)
    c = teng.generate(prompts, max_new_tokens=NEW, temperature=0.8, seed=8)
    assert a == b
    assert a != c
    assert all(0 <= t < teng.cfg.vocab_size for s in a for t in s)


def test_generate_validates_lengths(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="smax"):
        teng.generate([[1] * 40], max_new_tokens=20)
    with pytest.raises(ValueError, match="non-empty"):
        teng.generate([[]])
    assert torch.device("cpu") == teng.device
