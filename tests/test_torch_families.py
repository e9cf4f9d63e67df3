"""The port's decoder stack on the smoke twins of the nine zoo configs,
against the JAX reference, on the CPU: prefill and decode logits of a
left-padded ragged batch (pads 0, 5 and 11 of 16) and twelve greedy decode
steps, on the reference's own `make_params` weights carried over by
`from_jax_params`.

The smoke twins cover every family: sliding windows whose ring (window 8)
wraps during prefill and again during decode (h2o-danube; hymba's ring
layers around its global layers 0 and 2; gemma2's local layer), softcaps,
post-norms and GeGLU (gemma2), pure SSM (mamba2, chunk 8), the hybrid
stack (hymba), MoE with top-k routing (moonshot, top 2 of 4) and with a
shared expert in dense/MoE pairs (llama4, two layers a block), sinusoidal
positions with a plain gelu MLP (musicgen), the embeddings frontend
(phi-3-vision: a batch of embeds, no tokens) and GQA at head_dim 8 (yi).

Tolerances.  With float32 parameters every op computes in float32 on both
sides and the logits agree to ~5e-6 (|logits| ~3): FLOAT32_ATOL = 2e-5 is
four times the largest difference measured, tight enough that any
difference of semantics (a window off by one, a ring slot, a pad leaking
into SSM state, a routing rule) fails.  In bfloat16 the reference's jitted
program skips intermediate roundings the port's op-by-op program takes
(XLA's excess precision), and those last-bit differences grow through the
layers: the largest differences measured are 1-3% of the reference's
largest |logit| (0.099 for moonshot, |logits| up to 3.5); BF16_RTOL = 0.08
of it is about three times that.
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
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.weights import from_jax_params

ZOO = ["gemma2-2b", "h2o-danube-1.8b", "hymba-1.5b",
       "llama4-maverick-400b-a17b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
       "musicgen-large", "phi-3-vision-4.2b", "yi-34b"]
FLOAT32_ATOL = 2e-5
BF16_RTOL = 0.08
B, S, SMAX, STEPS = 3, 16, 32, 12
PAD = np.array([0, 5, 11], np.int32)


def _configs(name, dtype):
    jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
    return (dataclasses.replace(jcfg, param_dtype=dtype),
            dataclasses.replace(tcfg, param_dtype=dtype))


def _inputs(cfg, rng):
    """(reference batch, port batch) of a (B, S) prompt batch or, for the
    embeddings frontend, (B, S, d) embeds."""
    if cfg.frontend == "embeddings":
        e = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return ({"embeds": jnp.asarray(e).astype(jnp.bfloat16)},
                {"embeds": torch.from_numpy(e).to(torch.bfloat16)})
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks.astype(np.int64))})


@functools.lru_cache(maxsize=None)
def _run(name, dtype):
    """Prefill and STEPS greedy decode steps of both models on the same
    weights and inputs: (reference logits, port logits), each a list of
    (B, vocab) arrays, the port's caches after the run, and its config."""
    jcfg, tcfg = _configs(name, dtype)
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    jb, tb = _inputs(jcfg, rng)
    jb["pad"], tb["pad"] = jnp.asarray(PAD), torch.from_numpy(PAD)
    jl, jc, _ = jax.jit(JT.prefill, static_argnums=(0, 3))(jcfg, jp, jb,
                                                           SMAX)
    with torch.inference_mode():
        tl, tc, n = TT.prefill(tcfg, tp, tb, SMAX)
    assert n == S
    want, got = [np.asarray(jl)], [tl.numpy()]
    dec = jax.jit(JT.decode_step, static_argnums=(0,))
    for step in range(STEPS):
        pos = S + step
        positions = pos - PAD
        if jcfg.frontend == "embeddings":
            jsb, tsb = _inputs(jcfg, rng)
            jsb = {"embeds": jsb["embeds"][:, :1]}
            tsb = {"embeds": tsb["embeds"][:, :1]}
        else:
            cur = np.argmax(want[-1], -1).astype(np.int32)
            jsb = {"tokens": jnp.asarray(cur)[:, None]}
            tsb = {"tokens": torch.from_numpy(cur.astype(np.int64))[:, None]}
        jl, jc = dec(jcfg, jp, jc, jsb, jnp.int32(pos),
                     positions=jnp.asarray(positions))
        with torch.inference_mode():
            tl, tc = TT.decode_step(tcfg, tp, tc, tsb, pos,
                                    positions=torch.from_numpy(positions))
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    return want, got, tc, tcfg


@pytest.mark.parametrize("name", ZOO)
def test_float32_logits_match_reference(name):
    want, got, _, _ = _run(name, "float32")
    diff = max(np.abs(g - w).max() for g, w in zip(got, want))
    print(f"{name} float32: max |logit diff| {diff:.3g}")
    assert all(np.isfinite(g).all() for g in got)
    assert diff <= FLOAT32_ATOL


@pytest.mark.parametrize("name", ZOO)
def test_bf16_logits_within_tolerance(name):
    want, got, _, _ = _run(name, "bfloat16")
    scale = max(np.abs(w).max() for w in want)
    diff = max(np.abs(g - w).max() for g, w in zip(got, want))
    print(f"{name} bfloat16: max |logit diff| {diff:.3g}, |logits| "
          f"{scale:.3g}")
    assert all(np.isfinite(g).all() for g in got)
    assert diff <= BF16_RTOL * scale


def test_rings_wrap_and_hold_the_last_window():
    """danube's ring layers after 16 prompt slots and 12 decode steps: the
    8 slots hold padded positions 20..27, each at slot pos mod 8; hymba's
    global layers keep full caches in its per-block list."""
    _, _, cache, cfg = _run("h2o-danube-1.8b", "float32")
    ring = cache["sub0"]["pos"]
    assert ring.shape == (cfg.n_blocks, cfg.window)
    want = torch.arange(S + STEPS - cfg.window, S + STEPS, dtype=torch.int32)
    for b in range(cfg.n_blocks):
        assert torch.equal(ring[b][want % cfg.window], want)
    _, _, cache, cfg = _run("hymba-1.5b", "float32")
    per_block = cache["sub0"]["per_block"]
    assert ["pos" in c for c in per_block] == [False, True, False]
    assert per_block[0]["k"].shape[1] == SMAX
    assert per_block[1]["k"].shape[1] == cfg.window
    assert set(per_block[1]["ssm"]) == {"state", "conv"}


def test_prefill_into_given_cache_resets_rings():
    """`prefill(cache=)` writes the given buffers in place: a ring's
    unwritten slots go back to −1 and the result equals a fresh prefill."""
    cfg = get_smoke_config("h2o-danube-1.8b")
    params = TT.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {"tokens": torch.arange(1, 6)[None],
             "pad": torch.zeros(1, dtype=torch.int32)}
    with torch.inference_mode():
        _, fresh, _ = TT.prefill(cfg, params, batch, SMAX)
        mine = TT.init_cache(cfg, 1, SMAX, "cpu")
        for t in mine["sub0"].values():
            t.fill_(7)
        ptrs = [t.data_ptr() for t in mine["sub0"].values()]
        _, got, _ = TT.prefill(cfg, params, batch, SMAX, cache=mine)
    assert ptrs == [t.data_ptr() for t in got["sub0"].values()]
    for k in ("k", "v", "pos"):
        assert torch.equal(got["sub0"][k], fresh["sub0"][k])
    assert (got["sub0"]["pos"] == -1).sum() == cfg.n_blocks * (
        cfg.window - 5)


def test_from_jax_params_checks_every_family():
    """Each family's tree converts with every leaf in place (two layers a
    block for llama4, SSM and MoE leaves); a missing or reshaped leaf
    raises."""
    for name in ("hymba-1.5b", "llama4-maverick-400b-a17b"):
        jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
        tree = jax.tree.map(np.asarray,
                            JT.make_params(jcfg, jax.random.PRNGKey(1)))
        tp = from_jax_params(tree, tcfg, device="cpu")
        assert jax.tree.structure(jax.tree.map(lambda a: 0, tree)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, tp))
        spec = jax.tree.map(lambda a: a.shape, tree)
        mine = jax.tree.map(lambda t: tuple(t.shape), tp)
        assert jax.tree.leaves(spec) == jax.tree.leaves(mine)
    blocks = tree["blocks"]
    assert set(blocks) == {"sub0", "sub1"}
    assert "moe" in blocks["sub1"] and "mlp" in blocks["sub0"]
    bad = dict(tree, blocks=dict(blocks, sub1=dict(blocks["sub1"])))
    del bad["blocks"]["sub1"]["moe"]["router"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, tcfg, device="cpu")
    bad["blocks"]["sub1"]["moe"] = dict(blocks["sub1"]["moe"],
                                        router=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="router"):
        from_jax_params(bad, tcfg, device="cpu")


@pytest.mark.parametrize("name", ["gemma2-2b", "mamba2-1.3b", "hymba-1.5b"])
def test_exact_prefill_rows_do_not_depend_on_batchmates(name):
    """The prefill selects the float64 linears (`exact=True`, its
    default): a left-padded prompt's logits alone equal its row of the
    batched prefill bit for bit, and `layers.linear(..., exact=True)` is
    the float64 product rounded once.  Exact comparisons: the float64 sums
    of bf16 terms are exact or off by ~2^-53 before the one rounding."""
    from repro_torch.models import layers as TL

    _, tcfg = _configs(name, "bfloat16")
    tp = TT.make_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    _, tb = _inputs(tcfg, np.random.default_rng(1))
    tb["pad"] = torch.from_numpy(PAD)
    with torch.inference_mode():
        batched = TT.prefill(tcfg, tp, tb, SMAX)[0]
        for i in range(B):
            alone = TT.prefill(tcfg, tp, {k: v[i:i + 1]
                                          for k, v in tb.items()}, SMAX)[0]
            assert torch.equal(alone[0], batched[i])
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 24, generator=g).to(torch.bfloat16)
    w = torch.randn(24, 7, generator=g).to(torch.bfloat16)
    assert torch.equal(TL.linear(x, w, "bf16", exact=True),
                       (x.double() @ w.double()).to(torch.bfloat16))
    assert torch.equal(TL.linear(x, w, "bf16"), torch.matmul(x, w))
