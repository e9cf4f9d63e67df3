"""The port's optimizers against the reference's (`repro/train/
optimizer.py`) on the CPU: AdamW and Adafactor, one and five updates of
the same parameters (bf16 and float32 leaves, a nested dict) with the same
seeded gradients, the new parameters and every state leaf; the cosine
schedule; global-norm clipping; Adafactor's factored state.

Tolerances (measured after five updates): both sides compute each update
in float32 with the same formulas in the same order; the libraries'
`pow`, `sqrt`/`rsqrt` and reductions (the global norm, Adafactor's means)
may round differently by an ulp.  States within 1.9e-7 of each leaf's
largest |value| (STATE_RTOL = 1e-5); float32 parameters within 1.7e-7
relative, one element a leaf at most (F32_RTOL = 1e-6); bf16 parameters
equal (measured) but for at most one element a leaf by one bf16 ulp
(2^-7 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.train import optimizer as TO
from repro_torch.train.tree import leaves

F32_RTOL = 1e-6
STATE_RTOL = 1e-5
SHAPES = {"w": ((16, 8), "bfloat16"), "b": ((8,), "float32"),
          "blocks": {"k": ((3, 6, 5), "bfloat16"), "n": ((3, 6), "float32")}}


def _trees(seed=0):
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dt = spec
        return rng.standard_normal(shape).astype(np.float32), dt

    return make(SHAPES)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    a, dt = tree
    return jnp.asarray(a).astype(getattr(jnp, dt))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    a, dt = tree
    return torch.from_numpy(a).to(getattr(torch, dt))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _compare_params(got, want):
    for g, w, t in zip(leaves(got), jax.tree.leaves(want), leaves(got)):
        g, w = _np(g), _np(w)
        if t.dtype == torch.bfloat16:
            off = np.abs(g - w) > 0
            assert off.sum() <= 1
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all()
        else:
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=0)


def _compare_state(got, want):
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= STATE_RTOL * max(np.abs(w).max(),
                                                       1e-30)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("updates", [1, 5])
def test_updates_match_reference(kind, updates):
    jopt = getattr(JO, kind)(JO.cosine_schedule(1e-2, 2, 10))
    topt = getattr(TO, kind)(TO.cosine_schedule(1e-2, 2, 10))
    jp, tp = _jax(_trees()), _torch(_trees())
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(updates):
        g = _trees(seed=step + 1)
        jp, js = jax.jit(jopt.update)(_jax(g), js, jp, step)
        tp, ts = topt.update(_torch(g), ts, tp, step)
    _compare_params(tp, jp)
    _compare_state(ts, js)
    assert [t.dtype for t in leaves(tp)] == [
        getattr(torch, str(x.dtype)) for x in jax.tree.leaves(jp)]


@pytest.mark.parametrize("args", [(3e-3, 5, 30), (1e-2, 5, 60),
                                  (3e-4, 200, 10000)])
def test_cosine_schedule_equal(args):
    """Equal step for step, but that the libraries' float32 cosines of the
    same argument may round differently (the port rounds a float64 cosine
    once): measured 1 step of the long schedule's 400 sampled, where
    1 + cos cancels bits; at most 1% of steps, within 8 ulps."""
    jlr, tlr = JO.cosine_schedule(*args), TO.cosine_schedule(*args)
    total = args[2]
    steps = range(0, total + 5, max(1, (total + 5) // 400))
    off = 0
    for step in steps:
        want = np.float32(jlr(step))
        got = tlr(step)
        assert got.dtype == torch.float32
        got = np.float32(got.item())
        assert abs(got - want) <= 8 * np.spacing(want), step
        off += got != want
    assert off <= len(steps) // 100


def test_clip_by_global_norm_matches_reference():
    g = _trees(seed=9)
    jg, jn = JO.clip_by_global_norm(_jax(g), 1.0)
    tg, tn = TO.clip_by_global_norm(_torch(g), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(64),
              "s": torch.zeros(3, 64, 32)}
    st = TO.adafactor(TO.cosine_schedule(1e-3, 1, 10)).init(params)
    assert st["w"]["vr"].shape == (64,) and st["w"]["vc"].shape == (32,)
    assert st["b"]["v"].shape == (64,)
    assert st["s"]["vr"].shape == (3, 64) and st["s"]["vc"].shape == (3, 32)


def test_make_optimizer_follows_config():
    from repro_torch.configs.base import get_config, get_smoke_config
    assert get_config("llama4-maverick-400b-a17b").optimizer == "adafactor"
    assert get_smoke_config("smollm-135m").optimizer == "adamw"
    p = {"w": torch.zeros(4, 3)}
    assert "vr" in TO.make_optimizer(
        get_smoke_config("llama4-maverick-400b-a17b")).init(p)["w"]
    assert set(TO.make_optimizer(get_smoke_config("smollm-135m")).init(p)) \
        == {"m", "v"}
