"""Shared helpers of the port's whole-model tests: reference and port models
on one config from the same `make_params` weights, token batches, and the
greedy-token comparison that only counts decisive steps.

Greedy tokens are held to the reference wherever the reference's top-2
logit gap exceeds twice the config's logit tolerance: the logits tests bound
each logit's distance to the reference by that tolerance, so only a smaller
gap can flip the argmax.  At such a step a differing token ends the
comparison for that sequence (the prefixes differ from there on) and is
reported, not failed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as JT
from repro.serve.engine import Engine as JaxEngine
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Engine
from repro_torch.weights import from_jax_params

LOGIT_ATOL = 0.03          # the model tolerance of tests/test_torch_model.py


def t(a):
    """Reference array → torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def batch(cfg, B=3, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    pad = np.array([0, 5, 11][:B], np.int32)
    return ({"tokens": jnp.asarray(toks), "pad": jnp.asarray(pad)},
            {"tokens": torch.from_numpy(toks.astype(np.int64)),
             "pad": torch.from_numpy(pad)})


def engines(jcfg, tcfg, jax_smax=32, smax=64, lanes=4):
    """Reference and port engines on the reference's PRNGKey(0) weights."""
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (JaxEngine(jcfg, jp, smax=jax_smax),
            Engine(tcfg, tp, smax=smax, lanes=lanes, device="cpu"))


def max_logit_diff(jeng, teng, seeds=range(3)):
    """Largest |logit| difference of prefill and one decode step over a few
    token batches, on the engines' (encoded) parameters, through the
    reference engine's own compiled prefill/decode."""
    jcfg, tcfg, smax = jeng.cfg, teng.cfg, jeng.smax
    worst = 0.0
    for seed in seeds:
        jb, tb = batch(jcfg, seed=seed)
        S = jb["tokens"].shape[1]
        jl, jc, _ = jeng._prefill(jeng.params, jb, smax=smax)
        with torch.inference_mode():
            tl, tc, _ = TT.prefill(tcfg, teng.params, tb, smax)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        positions = S - np.asarray(jb["pad"])
        jdl, _ = jeng._decode(jeng.params, jc,
                              {"tokens": jnp.asarray(cur)[:, None]},
                              jnp.int32(S), positions=jnp.asarray(positions))
        with torch.inference_mode():
            tdl, _ = TT.decode_step(
                tcfg, teng.params, tc,
                {"tokens": torch.from_numpy(cur.astype(np.int64))[:, None]},
                S, positions=torch.from_numpy(positions))
        assert torch.isfinite(tl).all() and torch.isfinite(tdl).all()
        worst = max(worst, np.abs(tl.numpy() - np.asarray(jl)).max(),
                    np.abs(tdl.numpy() - np.asarray(jdl)).max())
    return worst


def _reference_gaps(eng, prompts, tokens, new):
    """Top-2 logit gap of the reference at every step of its own greedy
    path (teacher-forced through its prefill/decode executables)."""
    b, plen = eng._pack(prompts)
    logits, cache, _ = eng._prefill(eng.params, b, smax=eng.smax)
    gaps = []
    for step in range(new):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        if step == new - 1:
            break
        cur = jnp.asarray([seq[len(p) + step]
                           for seq, p in zip(tokens, prompts)], jnp.int32)
        pos = jnp.int32(plen + step)
        logits, cache = eng._decode(eng.params, cache,
                                    {"tokens": cur[:, None]}, pos,
                                    positions=pos - b["pad"])
    return np.stack(gaps, axis=1)                  # (B, new)


def compare_greedy(jeng, teng, prompts, new, atol=LOGIT_ATOL):
    """(decisive tokens, equal tokens, near-tie flips); asserts equality at
    every decisive step (reference top-2 gap above 2·atol)."""
    want = jeng.generate(prompts, max_new_tokens=new)
    got = teng.generate(prompts, max_new_tokens=new)
    gaps = _reference_gaps(jeng, prompts, want, new)
    decisive, equal, flips = 0, 0, []
    for i, p in enumerate(prompts):
        for step in range(new):
            a, b = want[i][len(p) + step], got[i][len(p) + step]
            if gaps[i, step] > 2 * atol:
                assert a == b, (i, step, gaps[i, step])
                decisive += 1
            elif a != b:
                flips.append((i, step, float(gaps[i, step])))
                break
            equal += 1
    return decisive, equal, flips


def prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


EXACT_SCRIPT = """
import dataclasses, json, sys
sys.path.insert(0, "tests")
import _torch_compare as cmp
from repro.configs.base import get_smoke_config as J
from repro_torch.configs.base import get_smoke_config as T
out = {}
for name in sys.argv[1:]:
    jcfg = dataclasses.replace(J(name), linear_backend="rns_int8:jnp")
    je, te = cmp.engines(jcfg, T(name))
    ps = cmp.prompts(jcfg.vocab_size, [3, 9, 14])
    out[name] = {"logits": float(cmp.max_logit_diff(je, te, seeds=range(2))),
                 "tokens_equal": je.generate(ps, max_new_tokens=8,
                                             engine="host")
                 == te.generate(ps, max_new_tokens=8)}
print(json.dumps(out))
"""


def compare_without_excess_precision(names):
    """{config: {"logits": max_logit_diff, "tokens_equal": greedy tokens of
    three prompts equal}} of each smoke config, with the reference compiled
    under ``--xla_allow_excess_precision=false`` (XLA then keeps every
    bfloat16 rounding the program asks for), in a fresh process: the flag is
    read once, when JAX starts."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", EXACT_SCRIPT, *names],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
