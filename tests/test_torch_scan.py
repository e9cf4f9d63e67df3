"""The port's on-device decode (`Engine.generate(engine="scan")`) on the
CPU, on the smoke twins of the three served configs.

On the CPU the scan path has no CUDA graph: it runs the captured step's
function eagerly over the same persistent buffers, with the cache position
a device tensor, so these tests hold its arithmetic: tokens equal to the
per-token loop (``engine="host"``), greedy and sampled for one seed; the
EOS latch; batch invariance with pinned lanes; length validation and the
engine name under both; and `decode_step` at a tensor position bit-equal
to an int one.  The replayed graph itself is held on the card
(`tests/test_torch_cuda.py::test_engine_scan_replays_captured_step`); the
scan tokens against the reference's are
`tests/test_torch_serve.py::test_greedy_tokens_match_reference_where_decisive`.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine

CONFIGS = ["rns-smollm-135m-fused", "rns-smollm-135m-resident",
           "rns-smollm-135m-pallas"]
NEW = 8


@pytest.fixture(scope="module", params=CONFIGS)
def engine(request):
    cfg = get_smoke_config(request.param)
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return Engine(cfg, params, smax=48, lanes=4, device="cpu")


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 7), (1.3, 8)])
def test_scan_tokens_equal_host(engine, temperature, seed):
    prompts = _prompts(engine.cfg.vocab_size, [3, 9, 14])
    host = engine.generate(prompts, NEW, temperature=temperature, seed=seed,
                           engine="host")
    scan = engine.generate(prompts, NEW, temperature=temperature, seed=seed,
                           engine="scan")
    assert scan == host
    assert scan == engine.generate(prompts, NEW, temperature=temperature,
                                   seed=seed)                # the default
    assert all(len(s) == len(p) + NEW for s, p in zip(scan, prompts))


def test_scan_eos_latch(engine):
    p = _prompts(engine.cfg.vocab_size, [6], seed=3)[0]
    free = engine.generate([p], NEW, engine="scan")[0][len(p):]
    first = engine.generate([p], NEW, eos_id=free[0], engine="scan")[0]
    assert first == p + free[:1]                 # EOS as the first token
    k = next((j for j in range(1, NEW) if free[j] not in free[:j]), None)
    if k is not None:                            # EOS mid-stream
        mid = engine.generate([p], NEW, eos_id=free[k], engine="scan")[0]
        assert mid == p + free[:k + 1]
        assert mid == engine.generate([p], NEW, eos_id=free[k],
                                      engine="host")[0]


def test_scan_batch_invariance_with_lanes(engine):
    prompts = _prompts(engine.cfg.vocab_size, [4, 17, 9])
    batched = engine.generate(prompts, NEW, engine="scan")
    for i, p in enumerate(prompts):
        assert engine.generate([p], NEW, engine="scan")[0] == batched[i]


@pytest.mark.parametrize("name", ["scan", "host"])
def test_generate_validates_lengths_both_engines(name):
    cfg = get_smoke_config(CONFIGS[0])
    eng = Engine(cfg, T.make_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"), smax=32, device="cpu")
    with pytest.raises(ValueError, match="smax"):
        eng.generate([[1] * 20], max_new_tokens=10, engine=name)
    with pytest.raises(ValueError, match="non-empty"):
        eng.generate([[]], engine=name)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([[1]], max_new_tokens=0, engine=name)
    # the last slot is usable: bucket 8 + 25 new tokens = 32 slots
    out = eng.generate([[1, 2]], max_new_tokens=25, engine=name)
    assert len(out[0]) == 27


def test_unknown_engine_raises():
    cfg = get_smoke_config(CONFIGS[0])
    eng = Engine(cfg, T.make_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"), smax=32, device="cpu")
    with pytest.raises(ValueError, match="engine must be 'scan' or 'host'"):
        eng.generate([[1, 2]], engine="loop")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("with_positions", [True, False])
def test_decode_step_tensor_position_bit_equal(name, with_positions):
    """decode_step at a 0-d tensor position writes the same cache slot and
    returns the same logits, bit for bit, as at the int position."""
    cfg = get_smoke_config(name)
    params = T.make_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    eng = Engine(cfg, params, smax=24, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 8)))
    pad = torch.tensor([0, 3, 5], dtype=torch.int32)
    with torch.inference_mode():
        logits, cache, pos = T.prefill(cfg, eng.params,
                                       {"tokens": toks, "pad": pad}, 24)
        cur = {"tokens": torch.argmax(logits, -1)[:, None]}
        caches = [{"sub0": {k: v.clone() for k, v in cache["sub0"].items()}}
                  for _ in range(2)]
        outs = []
        for c, p in zip(caches, (pos, torch.tensor(pos))):
            positions = p - pad if with_positions else None
            outs.append(T.decode_step(cfg, eng.params, c, cur, p,
                                      positions=positions)[0])
    assert torch.equal(outs[0], outs[1])
    for k in ("k", "v"):
        assert torch.equal(caches[0]["sub0"][k], caches[1]["sub0"][k])
        assert not torch.equal(caches[0]["sub0"][k], cache["sub0"][k])


def test_prefill_into_given_cache():
    """prefill into a handed-in cache (holding stale values) zeroes and
    fills it in place, equal to a fresh one; a cache of the wrong shape
    raises."""
    cfg = get_smoke_config(CONFIGS[0])
    params = T.make_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    batch = {"tokens": torch.arange(1, 9)[None].repeat(2, 1),
             "pad": torch.tensor([0, 2], dtype=torch.int32)}
    with torch.inference_mode():
        want_logits, want, _ = T.prefill(cfg, params, batch, 16)
        mine = T.init_cache(cfg, 2, 16, "cpu")
        for t in mine["sub0"].values():
            t.fill_(3.0)
        ptrs = [t.data_ptr() for t in mine["sub0"].values()]
        logits, got, _ = T.prefill(cfg, params, batch, 16, cache=mine)
        assert got is mine
        assert ptrs == [t.data_ptr() for t in got["sub0"].values()]
        for k in ("k", "v"):
            assert torch.equal(got["sub0"][k], want["sub0"][k])
        assert torch.equal(logits, want_logits)
        with pytest.raises(ValueError, match="cache"):
            T.prefill(cfg, params, batch, 16,
                      cache=T.init_cache(cfg, 3, 16, "cpu"))


def test_scan_states_are_bounded():
    """One state per (lanes, smax, sampled), reused across calls and
    temperatures; at most eight kept."""
    from repro_torch.serve import engine as E

    cfg = get_smoke_config(CONFIGS[0])
    eng = Engine(cfg, T.make_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"), smax=32, device="cpu")
    eng.generate([[1, 2]], 2)
    eng.generate([[3, 4, 5]], 2, temperature=0.5)
    eng.generate([[3, 4, 5]], 2, temperature=0.9, seed=4)
    assert list(eng._scan) == [(1, 32, False), (1, 32, True)]
    for b in range(2, 2 + E._SCAN_CACHE_MAX):
        eng.generate([[1]] * b, 2)
    assert len(eng._scan) == E._SCAN_CACHE_MAX
    assert (1, 32, False) not in eng._scan
    assert eng.scan_replays == 0 and eng.scan_captures == 0   # no graph
