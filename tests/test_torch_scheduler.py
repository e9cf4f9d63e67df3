"""The port's continuous-batching `SlotScheduler` on the CPU.

The contracts of the reference's `tests/test_scheduler.py`, on the smoke
`smollm-135m` (bf16), `rns-smollm-135m-fused` and `-resident` configs: each
request's tokens equal the scheduler's own engine run alone
(``sched.engine.generate([prompt])``, ``lanes == slots``) under burst,
staggered and reversed arrivals; prefix sharing changes no token, counts
its hits and needs fewer blocks; a pool far below the static reservation
defers admission and stays within ``n_blocks − 1``; EOS truncates where the
solo engine does; `serve` is re-entrant; ring-cache stacks, meshes and
oversized requests are rejected.  Sampling: the first token equals the
solo engine's, and so do the later ones (each slot's generator follows the
solo engine's chain); outputs do not depend on arrival order.

Against the reference `SlotScheduler` (its RNS linears on the jnp backend,
on the reference's own `make_params` weights): equal `stats` with no EOS,
and greedy tokens equal wherever the reference's top-2 logit gap exceeds
twice the config's logit tolerance (`_torch_compare.compare_greedy`'s
rule); a near-tie flip is printed, not failed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve import Request as JaxRequest
from repro.serve import SlotScheduler as JaxSlotScheduler
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve import Request, SlotScheduler
from repro_torch.weights import from_jax_params

ARCHS = ["smollm-135m", "rns-smollm-135m-fused", "rns-smollm-135m-resident"]
LOGIT_ATOL = {"smollm-135m": 0.03, "rns-smollm-135m-fused": 0.03,
              "rns-smollm-135m-resident": 0.15}

SLOTS, BLOCK, SLOT_TOKENS, CHUNK = 2, 4, 24, 2


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = get_smoke_config(arch)
    return T.make_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@functools.lru_cache(maxsize=None)
def _sched(arch, **kw):
    return SlotScheduler(get_smoke_config(arch), _params(arch), slots=SLOTS,
                         block_size=BLOCK, slot_tokens=SLOT_TOKENS,
                         decode_chunk=CHUNK, device="cpu", **kw)


def _prompts(cfg, lens, seed=1, head=0):
    """Ragged random prompts; the first ``head`` tokens are shared."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, head).tolist()
    return [shared + rng.integers(1, cfg.vocab_size, n - head).tolist()
            for n in lens]


def _solo(sched, prompts, news, **kw):
    return [sched.engine.generate([p], max_new_tokens=m, **kw)[0]
            for p, m in zip(prompts, news)]


@pytest.mark.parametrize("arch", ARCHS)
def test_arrival_order_invariance(arch):
    sched = _sched(arch)
    prompts = _prompts(sched.cfg, [3, 9, 6, 11])
    news = [8, 3, 6, 4]
    solo = _solo(sched, prompts, news)
    burst = sched.serve([Request(p, m) for p, m in zip(prompts, news)])
    assert burst == solo, f"{arch}: batch-at-t0 diverged from solo"
    stag = sched.serve([Request(p, m, arrival=a)
                        for p, m, a in zip(prompts, news, [0, 0, 3, 5])])
    assert stag == solo, f"{arch}: mid-flight admission changed tokens"
    rev = sched.serve([Request(p, m, arrival=a) for p, m, a in
                       zip(prompts[::-1], news[::-1], [5, 3, 1, 0])])
    assert rev == solo[::-1], f"{arch}: submission order leaked into output"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_sharing_bit_identical_and_counted(arch):
    on = _sched(arch)
    off = _sched(arch, prefix_sharing=False)
    prompts = _prompts(on.cfg, [10, 12, 9], seed=5, head=2 * BLOCK)
    reqs = [Request(p, 5) for p in prompts]
    a, b = on.serve(list(reqs)), off.serve(list(reqs))
    assert a == b == _solo(on, prompts, [5, 5, 5])
    assert on.stats["prefix_hits"] > 0
    assert off.stats["prefix_hits"] == 0
    assert on.stats["peak_blocks"] < off.stats["peak_blocks"]


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_pool_defers_admission_then_reuses_freed_blocks(arch):
    cfg = get_smoke_config(arch)
    full = SLOTS * (SLOT_TOKENS // BLOCK)        # static reservation
    n_blocks = 1 + full // 2
    sched = _sched(arch, n_blocks=n_blocks)
    prompts = _prompts(cfg, [11, 9, 12, 10, 8], seed=7)
    news = [6, 8, 4, 7, 5]
    outs = sched.serve([Request(p, m) for p, m in zip(prompts, news)])
    assert outs == _solo(sched, prompts, news)
    assert sched.stats["peak_blocks"] <= n_blocks - 1   # block 0 is trash
    static = T.init_cache(cfg, SLOTS, SLOT_TOKENS, "meta")
    assert sched.stats["pool_bytes"] < sum(
        t.numel() * t.element_size() for t in static["sub0"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_eos_retires_slot_and_matches_engine(arch):
    base = _sched(arch)
    prompts = _prompts(base.cfg, [7, 5, 10], seed=11)
    ref = _solo(base, prompts, [8, 8, 8])
    eos = int(ref[0][len(prompts[0]) + 3])       # 4th new token of request 0
    sched = _sched(arch, eos_id=eos)
    outs = sched.serve([Request(p, 8) for p in prompts])
    assert outs == _solo(sched, prompts, [8, 8, 8], eos_id=eos)
    assert len(outs[0]) < len(prompts[0]) + 8    # actually stopped early


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_reentrant(arch):
    sched = _sched(arch)
    prompts = _prompts(sched.cfg, [4, 8], seed=13)
    reqs = [Request(p, 6, arrival=a) for p, a in zip(prompts, [0, 2])]
    first = sched.serve(list(reqs))
    second = sched.serve(list(reqs))
    assert first == second == _solo(sched, prompts, [6, 6])


@pytest.mark.parametrize("arch", ARCHS)
def test_admissions_counted_and_timed_on_request(arch):
    cfg = get_smoke_config(arch)
    n_blocks = 1 + SLOTS * (SLOT_TOKENS // BLOCK) // 2   # admissions defer
    sched = SlotScheduler(cfg, _params(arch), slots=SLOTS, block_size=BLOCK,
                          slot_tokens=SLOT_TOKENS, n_blocks=n_blocks,
                          decode_chunk=CHUNK, device="cpu")
    prompts = _prompts(cfg, [11, 9, 12, 10, 8], seed=7)
    reqs = [Request(p, m) for p, m in zip(prompts, [6, 8, 4, 7, 5])]
    untimed = sched.serve(reqs)
    assert (sched.admissions, sched.admit_seconds) == (5, 0.0)
    sched.time_admissions = True
    assert sched.serve(reqs) == untimed
    assert sched.admissions == 10 and sched.admit_seconds > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_non_dense_and_multi_device_rejected_at_construction(arch):
    cfg = get_smoke_config(arch)
    kw = dict(slots=SLOTS, block_size=BLOCK, slot_tokens=SLOT_TOKENS,
              device="cpu")
    # a sliding-window stack's ring positions are shared by the batch
    with pytest.raises(ValueError, match="sliding-window ring cache"):
        SlotScheduler(dataclasses.replace(cfg, attention="swa", window=8),
                      _params(arch), **kw)
    # a layout without a mesh, and a mesh without a "model" axis
    from repro_torch.launch.mesh import Mesh
    for extra, msg in (({"mesh": Mesh({"data": 2})}, "no 'model'"),
                       ({"dist_layout": "channel"}, "without mesh")):
        with pytest.raises(ValueError, match=msg):
            SlotScheduler(cfg, _params(arch), **kw, **extra)
    with pytest.raises(ValueError, match="multiple of block_size"):
        SlotScheduler(cfg, _params(arch), **dict(kw, slot_tokens=22))


@pytest.mark.parametrize("arch", ARCHS)
def test_oversized_requests_rejected_up_front(arch):
    sched = _sched(arch)
    fits = SLOT_TOKENS // 2
    with pytest.raises(ValueError, match="slot_tokens"):
        sched.serve([Request(list(range(1, SLOT_TOKENS)), 8)])
    tiny = _sched(arch, n_blocks=3)
    with pytest.raises(ValueError, match="lifetime block reservation"):
        tiny.serve([Request(list(range(1, fits)), fits)])


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_equals_solo_and_ignores_arrival_order(arch):
    """The first sampled token is the solo engine's draw; the later ones
    follow the slot's own generator chain, which is the solo engine's, and
    nothing depends on arrival order or slot-mates."""
    sched = _sched(arch, temperature=0.9)
    prompts = _prompts(sched.cfg, [3, 9, 6, 11], seed=17)
    news, seeds = [6, 3, 5, 4], [4, 9, 4, 21]
    solo = [sched.engine.generate([p], max_new_tokens=m, temperature=0.9,
                                  seed=s)[0]
            for p, m, s in zip(prompts, news, seeds)]
    firsts = [sched.engine.generate([p], max_new_tokens=1, temperature=0.9,
                                    seed=s)[0]
              for p, s in zip(prompts, seeds)]
    runs = []
    for arrivals in ([0, 0, 0, 0], [0, 0, 3, 5], [6, 4, 2, 0]):
        reqs = [Request(p, m, seed=s, arrival=a)
                for p, m, s, a in zip(prompts, news, seeds, arrivals)]
        runs.append(sched.serve(reqs[::-1])[::-1])
    for out in runs:
        assert [o[:len(p) + 1] for o, p in zip(out, prompts)] == firsts
        assert out == solo


# ------------------------------------------------ against the reference ---
def _jax_config(name):
    cfg = jax_smoke_config(name)
    if cfg.linear_backend.startswith("rns_int8"):
        cfg = dataclasses.replace(cfg, linear_backend="rns_int8:jnp")
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """Both schedulers on the reference's PRNGKey(0) weights, and one serve
    of the same staggered requests (no EOS) through each."""
    arch = request.param
    jcfg, tcfg = _jax_config(arch), get_smoke_config(arch)
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    kw = dict(slots=SLOTS, block_size=BLOCK, slot_tokens=SLOT_TOKENS,
              decode_chunk=CHUNK)
    jsched = JaxSlotScheduler(jcfg, jp, **kw)
    tsched = SlotScheduler(tcfg, tp, device="cpu", **kw)
    # one prefill bucket (8), so that each side compiles one prefill
    prompts = _prompts(tcfg, [5, 8, 7, 8, 6], seed=19, head=BLOCK)
    news = [8, 3, 6, 4, 7]
    arrivals = [0, 0, 3, 5, 5]
    want = jsched.serve([JaxRequest(p, m, arrival=a)
                         for p, m, a in zip(prompts, news, arrivals)])
    got = tsched.serve([Request(p, m, arrival=a)
                        for p, m, a in zip(prompts, news, arrivals)])
    return arch, jsched, tsched, prompts, news, want, got


def _reference_gaps(eng, prompt, seq, new):
    """Top-2 logit gap of the reference engine at every step of ``seq``
    (teacher-forced), the prompt alone in its ``lanes`` rows."""
    batch, plen = eng._pack([prompt])
    logits, cache, _ = eng._prefill(eng.params, batch, smax=eng.smax)
    lanes = batch["tokens"].shape[0]
    gaps = []
    for step in range(new):
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        gaps.append(top2[1] - top2[0])
        if step < new - 1:
            cur = jnp.full((lanes, 1), seq[len(prompt) + step], jnp.int32)
            pos = jnp.int32(plen + step)
            logits, cache = eng._decode(eng.params, cache, {"tokens": cur},
                                        pos, positions=pos - batch["pad"])
    return gaps


def test_stats_equal_reference(both):
    _, jsched, tsched, *_ = both
    assert tsched.stats == jsched.stats
    assert tsched.stats["prefix_hits"] > 0


def test_greedy_tokens_match_reference_where_decisive(both):
    arch, jsched, _, prompts, news, want, got = both
    limit = 2 * LOGIT_ATOL[arch]
    decisive, equal, flips = 0, 0, []
    for p, m, w, g in zip(prompts, news, want, got):
        gaps = _reference_gaps(jsched.engine, p, w, m)
        for step in range(m):
            a, b = w[len(p) + step], g[len(p) + step]
            if gaps[step] > limit:
                assert a == b, (p, step, gaps[step])
                decisive += 1
            elif a != b:
                flips.append((len(p), step, float(gaps[step])))
                break
            equal += 1
    print(f"{arch}: {equal} tokens equal ({decisive} decisive, top-2 gap "
          f"> {limit}); near-tie flips (prompt length, step, gap) {flips}")
    assert equal > 0
