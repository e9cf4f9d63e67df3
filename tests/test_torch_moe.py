"""The port's mixture-of-experts block (`models/moe.py`) against the
reference's `moe_apply`, on the CPU, on the reference's own
`make_moe_params` weights: the smoke moonshot (4 experts, top 2) and
llama4 (4 experts, top 1, shared expert) configs, at their capacity
factor (8: nothing dropped) and at tight ones (0.5 and 0.25: half to
two thirds of the picks spill to the dropped overflow row), the aux loss, `top_k`'s order on
ties, and the capacity's dependence on the whole batch.

Tolerances.  In float32 the routing, the capacity positions and the drops
are decided on float32 router probabilities computed alike on both sides
(top-2 gaps far above the ~1e-7 differences of the two matmuls); outputs
agree to 6e-7 of values up to 3.1.  ATOL = 1e-5 is far above that and far
below what one wrongly routed, kept or dropped pick changes (~1e-1).
The aux loss agrees to float32 rounding (1e-6).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import moe as JM
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import moe as TM

ATOL = 1e-5
NAMES = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]


def _tree(node):
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in node.items()}


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg = dataclasses.replace(jax_smoke_config(name), param_dtype="float32")
    jp = JM.make_moe_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jp, _tree(jp)


def _x(cfg, B=3, S=8, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _both(name, capacity_factor=None, B=3, S=8):
    jcfg = dataclasses.replace(jax_smoke_config(name), param_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(name), param_dtype="float32")
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jp, tp = _params(name)
    x = _x(jcfg, B, S)
    wy, waux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    gy, gaux = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    return np.asarray(wy), float(waux), gy.numpy(), float(gaux)


def _kept(name, capacity_factor, B=3, S=8):
    """How many picks the reference's rule keeps at this capacity."""
    jcfg = jax_smoke_config(name)
    jp, _ = _params(name)
    T, E, K = B * S, jcfg.num_experts, jcfg.top_k
    cap = max(int(np.ceil(T * K / E * capacity_factor)), 1)
    probs = jax.nn.softmax(jnp.asarray(_x(jcfg, B, S)).reshape(T, -1)
                           @ jp["router"], -1)
    _, idx = jax.lax.top_k(probs, K)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=E)
    return int(np.minimum(counts, cap).sum()), T * K


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity_factor", [None, 0.5, 0.25])
def test_moe_apply_matches_reference(name, capacity_factor):
    wy, waux, gy, gaux = _both(name, capacity_factor)
    np.testing.assert_allclose(gy, wy, atol=ATOL, rtol=0)
    assert abs(gaux - waux) <= 1e-6
    if capacity_factor is not None:
        kept, picks = _kept(name, capacity_factor)
        assert kept < picks             # the tight capacity drops picks


def test_moe_bf16_matches_reference():
    """The bfloat16 block: the reference's bf16 expert products and its
    float32 combine, within one bf16 ulp of the output scale."""
    name = "moonshot-v1-16b-a3b"
    jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
    jp = JM.make_moe_params(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    tp = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).to(torch.bfloat16 if a.dtype ==
                                      jnp.bfloat16 else torch.float32), jp)
    x = _x(jcfg)
    wy, _ = JM.moe_apply(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    gy, _ = TM.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    wy = np.asarray(wy.astype(jnp.float32))
    scale = np.abs(wy).max()
    assert np.abs(gy.float().numpy() - wy).max() <= scale * 2.0 ** -7


def test_top_k_order_on_ties_matches_lax():
    """Descending values, ties to the lower index: the pick order feeds
    the capacity positions."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.5, 0.1, 0.5, 0.1]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = TM.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gv.numpy(), np.asarray(wv))


def test_capacity_depends_on_the_whole_batch():
    """Capacity is set by T = B·S: the same first row routed alone and
    beside batchmates can lose different picks, in the port as in the
    reference (which is why batch invariance is not asked of MoE)."""
    name = "moonshot-v1-16b-a3b"
    for B in (1, 3):
        wy, _, gy, _ = _both(name, capacity_factor=0.25, B=B)
        np.testing.assert_allclose(gy, wy, atol=ATOL, rtol=0)
    alone = _both(name, capacity_factor=0.25, B=1)[2][0]
    batched = _both(name, capacity_factor=0.25, B=3)[2][0]
    assert not np.allclose(alone, batched, atol=1e-3)


def test_moe_params_layout_matches_reference():
    for name in NAMES:
        jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JM.make_moe_params(jax.random.PRNGKey(0), jcfg,
                                               jnp.bfloat16))
        got = TM.make_moe_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).removeprefix("torch.")),
                           got)
        assert got == want
