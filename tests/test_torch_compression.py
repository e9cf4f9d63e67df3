"""The int8 gradient all-reduce (`repro_torch.train.compression`) on
``gloo`` groups of 1, 2 and 4 spawned ranks (`_dist_workers.spawn_group`,
each spawned once for the module and joined with a deadline), over a
gradient tree of the smoke fused model's parameter shapes, each rank's
gradients seeded apart:

  * 1, 2 and 4 ranks: every rank's result equals the reference's own
    `_compress_one` (`repro/train/compression.py`), run under
    ``jax.vmap(..., axis_name=)`` over the stacked per-rank inputs (the
    mapped axis stands for the ranks, so its ``pmax`` and ``psum`` are the
    reference's collectives), bit for bit;
  * 1 rank: within one quantization step of the input (the reference's
    `tests/test_train.py`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.inputs import abstract_params

GROUPS = (1, 2, 4)


def _shapes():
    """(shape, dtype) of every parameter leaf of the smoke fused model, and
    one bfloat16 leaf."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            out.append((tuple(node.shape), torch.float32))

    walk(abstract_params(get_smoke_config("rns-smollm-135m-fused"),
                         encoded=False))
    return out + [((16, 24), torch.bfloat16)]


def _grads(n):
    """Per rank, the gradient leaves (rank r's scaled by 1 + r, one leaf all
    zeros, to reach the 1e-20 floor)."""
    per_rank = []
    for r in range(n):
        rng = np.random.default_rng(100 + r)
        leaves = [torch.from_numpy(
            (rng.standard_normal(s) * (1.0 + r)).astype(np.float32)).to(dt)
            for s, dt in _shapes()]
        leaves[1] = torch.zeros_like(leaves[1])
        per_rank.append(leaves)
    return per_rank


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    out = {}
    for n in GROUPS:
        path = tmp / f"grads{n}.pt"
        grads = _grads(n)
        torch.save(grads, path)
        out[n] = (grads, W.spawn_group(W.compression_task, n, tmp / f"g{n}",
                                       str(path)))
    return out


def _reference_mean(ranks_leaves, i):
    """The reference's `_compress_one` of the ranks' leaf ``i``: one row a
    rank, the ranks as a named mapped axis; every row is that rank's
    result, as a torch tensor of the leaf's dtype."""
    from repro.train.compression import _compress_one

    dtype = ranks_leaves[0][i].dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    stacked = jnp.asarray(np.stack(
        [leaves[i].to(torch.float32).numpy() for leaves in ranks_leaves]),
        jdt)
    out = jax.vmap(functools.partial(_compress_one, axes="r"),
                   axis_name="r")(stacked)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(dtype)


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("n", GROUPS)
def test_compressed_mean_equals_reference_arithmetic(work, n):
    grads, results = work[n]
    for i, (_, dtype) in enumerate(_shapes()):
        want = _reference_mean(grads, i)
        for rank, out in enumerate(results):
            assert out[i].dtype == dtype
            assert out[i].shape == want.shape[1:]
            assert torch.equal(_bits(out[i]), _bits(want[rank])), (rank, i)


@pytest.mark.parametrize("n", GROUPS)
def test_compressed_mean_is_within_a_step(work, n):
    """Each element within one quantization step (scale/2 a rank's rounding,
    averaged) of the true mean; one rank: of the input itself."""
    grads, results = work[n]
    for i, (_, dtype) in enumerate(_shapes()):
        if dtype != torch.float32:
            continue
        gs = np.stack([leaves[i].numpy() for leaves in grads])
        step = max(np.abs(gs).max(), 1e-20) / 127.0
        err = np.abs(results[0][i].numpy() - gs.mean(0)).max()
        assert err <= step + 1e-6, (i, err, step)


def test_one_rank_matches_reference_bound():
    """The reference's single-device case on the port's arithmetic: a
    linspace block round-trips within one quantization step."""
    from repro_torch.train.compression import dequantize, quantize

    g = torch.linspace(-1, 1, 64).reshape(8, 8)
    q, scale = quantize(g, torch.amax(torch.abs(g)))
    out = dequantize(q, scale, 1, g.dtype)
    assert (out - g).abs().max().item() <= 1.0 / 127 + 1e-6
