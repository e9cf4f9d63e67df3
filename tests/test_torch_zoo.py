"""The zoo configs through the port's serving surface, on the CPU: the
window and parameter accounting of the published configs, `Engine` on the
smoke twins against the reference's `Engine`, `SlotScheduler` on the pure
SSM stack, the paged pool's refusal of ring caches, the static lint, and
hymba on the fused RNS datapath.

Greedy tokens are held to the reference wherever the reference's top-2
logit gap exceeds twice the logit tolerance (`_torch_compare.
compare_greedy`; a near-tie flip is printed, not failed).  Two tolerances:

  * float32 twins of all eight served configs: every op computes in
    float32 on both sides and logits differ by at most 5e-6
    (`tests/test_torch_families.py`), so F32_ATOL = 2e-5 leaves almost
    every step decisive;
  * the bfloat16 configs themselves (danube, mamba2, hymba): the largest
    prefill/decode logit differences measured over three ragged batches
    are 0.036, 0.0049 and 0.059; BF16_ATOL is two and a half to three
    times each.

Hymba on ``rns_int8:pallas_fused`` with encoded weights holds its logits
within RNS_ATOL = 0.25 of the reference's (its ``rns_int8:jnp`` backend,
bit-equal to its kernels): the largest difference measured is 0.105, the
int8 requantization boundaries amplifying the bfloat16 differences above.
Against the port's own bfloat16 model the relative error stays below the
reference's int8 quantization bound of 0.35 (`tests/test_models.py`).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_compare as cmp

from repro.analysis.lint import lint_arch as ref_lint_arch
from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve.paged_cache import init_paged_cache as ref_init_paged_cache
from repro_torch.analysis.lint import lint_arch
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, SlotScheduler
from repro_torch.serve.engine import Engine, bucket_plen

SERVED = ["hymba-1.5b", "gemma2-2b", "mamba2-1.3b", "h2o-danube-1.8b",
          "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "yi-34b",
          "musicgen-large"]
MOE = {"moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"}
ZOO = SERVED + ["phi-3-vision-4.2b"]
F32_ATOL = 2e-5
BF16_ATOL = {"h2o-danube-1.8b": 0.12, "mamba2-1.3b": 0.015,
             "hymba-1.5b": 0.15}
RNS_ATOL = 0.25
NEW = 8
LENS = [3, 9, 14]


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _engines(name, dtype):
    jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
    if dtype == "float32":
        jcfg, tcfg = _f32(jcfg), _f32(tcfg)
    return cmp.engines(jcfg, tcfg)


@functools.lru_cache(maxsize=None)
def _port_engine(name):
    cfg = get_smoke_config(name)
    params = TT.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return Engine(cfg, params, smax=64, lanes=4, device="cpu")


# ------------------------------------------------------ configs, accounting --
def test_window_array_structures():
    """gemma2 alternates local/global; hymba has 3 explicit global layers;
    each config's windows equal the reference's."""
    w = TT.window_array(get_config("gemma2-2b"), 32768).reshape(-1)
    assert (w[0::2] == 4096).all() and (w[1::2] > 32768 - 1).all()
    wh = TT.window_array(get_config("hymba-1.5b"), 32768).reshape(-1)
    assert (wh[[0, 16, 31]] > 32768 - 1).all()
    assert (np.delete(wh, [0, 16, 31]) == 1024).all()
    for name in list_archs():
        for seq in (64, 32768):
            assert np.array_equal(
                TT.window_array(get_config(name), seq),
                JT.window_array(ref_config(name), seq)), name


def test_param_counts_match_published_and_reference():
    expect = {
        "smollm-135m": (0.134e9, 0.14e9),
        "gemma2-2b": (2.4e9, 2.8e9),
        "yi-34b": (33e9, 36e9),
        "llama4-maverick-400b-a17b": (385e9, 410e9),
        "mamba2-1.3b": (1.2e9, 1.45e9),
        "h2o-danube-1.8b": (1.7e9, 1.95e9),
    }
    for arch, (lo, hi) in expect.items():
        n = TT.count_params(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B outside [{lo},{hi}]"
    active = TT.active_params(get_config("llama4-maverick-400b-a17b"))
    assert 10e9 <= active <= 20e9
    for name in list_archs():
        assert TT.count_params(get_config(name)) == \
            JT.count_params(ref_config(name))
        assert TT.active_params(get_config(name)) == \
            JT.active_params(ref_config(name))


def test_bucket_rounds_to_the_ssm_chunk():
    for name in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = get_config(name)
        assert [bucket_plen(cfg, n) for n in (5, 200, 256, 300, 1000)] == \
            [256, 256, 256, 512, 1024]
    assert bucket_plen(get_smoke_config("mamba2-1.3b"), 3) == 8
    assert bucket_plen(get_config("yi-34b"), 300) == 512


@pytest.mark.parametrize("name", ZOO)
def test_lint_equals_reference(name):
    """`lint_arch` of each zoo config (full and smoke) reports the
    reference's findings."""
    def strs(reps):
        return [(r.subject, sorted(str(f) for f in r.findings))
                for r in reps]

    assert strs(lint_arch(name)) == strs(ref_lint_arch(name))


# ------------------------------------------------------------------ Engine --
@pytest.mark.parametrize("name", SERVED)
def test_float32_greedy_tokens_match_reference(name):
    jeng, teng = _engines(name, "float32")
    prompts = cmp.prompts(jeng.cfg.vocab_size, LENS)
    decisive, equal, flips = cmp.compare_greedy(jeng, teng, prompts, NEW,
                                                atol=F32_ATOL)
    print(f"{name} float32: {equal} equal ({decisive} decisive), near-tie "
          f"flips {flips}")
    assert decisive >= NEW


@pytest.mark.parametrize("name", sorted(BF16_ATOL))
def test_bf16_greedy_tokens_match_reference(name):
    jeng, teng = _engines(name, "bfloat16")
    assert cmp.max_logit_diff(jeng, teng) <= BF16_ATOL[name]
    prompts = cmp.prompts(jeng.cfg.vocab_size, LENS)
    decisive, equal, flips = cmp.compare_greedy(jeng, teng, prompts, NEW,
                                                atol=BF16_ATOL[name])
    print(f"{name} bfloat16: {equal} equal ({decisive} decisive), near-tie "
          f"flips {flips}")
    assert decisive > 0


@pytest.mark.parametrize("name", SERVED)
def test_scan_equals_host_and_batch_invariance(name):
    """Both engines emit the same tokens; outside MoE (whose capacity
    depends on the batchmates) each prompt alone equals its batched run."""
    eng = _port_engine(name)
    prompts = cmp.prompts(eng.cfg.vocab_size, [4, 17, 9])
    scan = eng.generate(prompts, max_new_tokens=NEW)
    assert scan == eng.generate(prompts, max_new_tokens=NEW, engine="host")
    if name in MOE:
        return
    for i, p in enumerate(prompts):
        assert eng.generate([p], max_new_tokens=NEW)[0] == scan[i]


def test_engine_refuses_the_embeddings_frontend():
    cfg = get_smoke_config("phi-3-vision-4.2b")
    params = TT.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = Engine(cfg, params, smax=32, device="cpu")
    with pytest.raises(ValueError, match="embeddings"):
        eng.generate([[1, 2, 3]], max_new_tokens=2)


@pytest.mark.parametrize("name", ZOO)
def test_engine_verify_static_accepts_zoo(name):
    cfg = get_smoke_config(name)
    params = TT.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert Engine(cfg, params, smax=32, verify="static", device="cpu")


# ----------------------------------------------------- scheduler, paging ---
def test_scheduler_serves_mamba2_equal_to_solo():
    """Burst, staggered and reversed arrivals on 2 slots equal the
    scheduler's own engine run alone; the SSM rows are spliced per slot
    and the pool holds no K/V."""
    cfg = get_smoke_config("mamba2-1.3b")
    params = TT.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    sched = SlotScheduler(cfg, params, slots=2, block_size=4,
                          slot_tokens=24, decode_chunk=2, device="cpu")
    assert set(sched._cache["sub0"]) == {"ssm"}
    prompts = cmp.prompts(cfg.vocab_size, [5, 11, 3, 8], seed=2)
    news = [6, 4, 7, 5]
    solo = [sched.engine.generate([p], max_new_tokens=m)[0]
            for p, m in zip(prompts, news)]
    for arrivals in ([0, 0, 0, 0], [0, 3, 5, 9], [9, 5, 3, 0]):
        reqs = [Request(p, m, arrival=a)
                for p, m, a in zip(prompts, news, arrivals)]
        assert sched.serve(reqs) == solo


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "hymba-1.5b",
                                  "gemma2-2b"])
def test_ring_cache_stacks_refused_with_reference_message(name):
    with pytest.raises(ValueError) as want:
        ref_init_paged_cache(jax_smoke_config(name), 2, 4, 1)
    cfg = get_smoke_config(name)
    params = TT.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError) as got:
        SlotScheduler(cfg, params, slots=2, block_size=4, slot_tokens=24,
                      device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- fused RNS hymba ---
def test_hymba_on_the_fused_rns_datapath():
    """Smoke hymba with every attention and MLP linear on
    ``rns_int8:pallas_fused`` (weights encoded at load, the SSM staying
    bf16 as in the reference): logits within RNS_ATOL of the reference's,
    and within the int8 quantization bound of the port's bf16 model."""
    name = "hymba-1.5b"
    fused = dict(linear_backend="rns_int8:pallas_fused", encode_weights=True)
    jcfg = dataclasses.replace(jax_smoke_config(name),
                               linear_backend="rns_int8:jnp",
                               encode_weights=True)
    tcfg = dataclasses.replace(get_smoke_config(name), **fused)
    jeng, teng = cmp.engines(jcfg, tcfg)
    diff = cmp.max_logit_diff(jeng, teng)
    print(f"hymba fused: max |logit diff| {diff:.3g}")
    assert diff <= RNS_ATOL
    jb, tb = cmp.batch(jcfg)
    _, bf16 = cmp.engines(jax_smoke_config(name), get_smoke_config(name))
    with torch.inference_mode():
        got, _, _ = TT.prefill(tcfg, teng.params, tb, 64)
        ref, _, _ = TT.prefill(bf16.cfg, bf16.params, tb, 64)
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.35
    prompts = cmp.prompts(jcfg.vocab_size, LENS)
    assert teng.generate(prompts, NEW) == teng.generate(prompts, NEW,
                                                        engine="host")
