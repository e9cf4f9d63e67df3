"""The mesh dry run's MoE, SSM and hybrid cells and the model code under
them, on the CPU.

- `models.moe.moe_apply` on DTensors (tokens over "data", experts over
  "model") on a 2-rank ``gloo`` group, on each one-axis mesh: bit-equal to
  the plain call, with a capacity factor that drops picks.
- `models.ssm.ssm_decode_step` on DTensors placed by the dry run's rules,
  3 heads over 2 model ranks: within ``SSM_TOL`` of the plain call (the
  state contraction is summed on each rank, then across them).
- `models.ssm.ssm_apply` (the chunked prefill: its causal conv on each
  rank's block) on DTensors placed the same way, the batch over "data":
  within ``SSM_TOL`` of the plain call.
- `models.layers.local_matmul` on 2 ranks, for each pair of placements
  the attention hands it: bit-equal to torch.matmul where no contraction
  is split, within 1e-12 where it is (a partial sum).
- `models.layers.attention` of one token over a slot-sharded cache on a
  ("pod", "data", "model") = (2, 1, 2) mesh of 4 ranks (the view DTensor
  refused needs both axes above 1): within ``ATTN_TOL`` of the plain call
  (the softmax and the value sum run over the sharded slots).
- `models.layers.matmul` on DTensors (`tp_matmul`: forward and backward
  on each rank's blocks), x's batch over "data" and w's columns, rows or
  FSDP rows sharded, on each one-axis mesh of 2 ranks: the product and
  both gradients within 1e-12 of the plain call's (float64).
- `models.layers.local_weight` (a weight each rank applies to its own
  tokens: the MoE experts and router, the SSM conv) on 2 ranks: its
  gradient is the sum over the token shares, whole or as an FSDP shard,
  within 1e-12 of the plain gradient (float64).
- The train loss's logsumexp and label pick over vocab-sharded logits
  (`train.trainstep._lse_and_label_on_shards`: each rank on its block,
  combined by all-reduces) on each one-axis mesh of 2 ranks: both and
  the logits' gradient within 1e-12 of the plain ops' (float64).
- A causal prefill's `models.layers.attention` and its query gradient on
  a mesh whose "model" dim shards neither the batch nor the 3 KV heads:
  each rank attends a share of the batch (B 2) or of the query rows (B
  1), within ``ATTN_TOL`` of the plain call.
- The two ``decode_32k`` cells on the 16×16 fake mesh that raised before,
  ``moonshot-v1-16b-a3b`` and ``hymba-1.5b``: ``ok``, with ``n_params``,
  ``n_active`` and ``model_flops`` equal to the reference's functions.
"""
import pytest
import torch

import _dist_workers as W
from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.models import transformer as jT
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun as D

# float32, on outputs of ~3: the sharded sums' order (measured 1.2e-6)
SSM_TOL = 1e-5
# float32, on outputs of ~1 (measured 1.2e-7)
ATTN_TOL = 1e-6


def test_moe_on_dtensors_bit_equal(tmp_path):
    shapes = [(2, 1), (1, 2)]
    ranks = W.spawn_group(W.moe_task, 2, tmp_path, "moonshot-v1-16b-a3b",
                          {"capacity_factor": 0.5}, shapes, 4, 3, 0)
    # the same seeded call with room for every pick (no mesh, no group)
    (y_all, _), = W.moe_task(0, 1, None, "moonshot-v1-16b-a3b",
                             {"capacity_factor": 8.0}, [], 4, 3, 0)
    for out in ranks:
        (y0, aux0), *meshes = out
        assert not torch.equal(y0, y_all)         # the factor drops picks
        for y, aux in meshes:
            assert torch.equal(y, y0)
            assert torch.allclose(aux, aux0, rtol=1e-6, atol=0.0)


def test_ssm_decode_heads_the_mesh_does_not_divide(tmp_path):
    ranks = W.spawn_group(W.ssm_decode_task, 2, tmp_path, "hymba-1.5b",
                          {"d_model": 48, "ssm_head_dim": 32,
                           "param_dtype": "float32"}, 2, 0)
    for (y0, s0), (y, s) in ranks:
        assert y.shape == y0.shape == (2, 1, 48)
        assert (y - y0).abs().max() <= SSM_TOL
        assert (s - s0).abs().max() <= SSM_TOL


def test_ssm_prefill_on_dtensors(tmp_path):
    ranks = W.spawn_group(W.ssm_apply_task, 2, tmp_path, "hymba-1.5b",
                          {"d_model": 48, "ssm_head_dim": 32,
                           "param_dtype": "float32"}, 2, 8, 0)
    for want, got in ranks:
        assert got.shape == want.shape == (2, 8, 48)
        assert (got - want).abs().max() <= SSM_TOL


def test_local_matmul_matches_matmul(tmp_path):
    ranks = W.spawn_group(W.local_matmul_task, 2, tmp_path, 0)
    for cases in ranks:
        *exact, (want, got) = cases
        for w, gt in exact:
            assert torch.equal(gt, w)
        assert torch.allclose(got, want, rtol=0.0, atol=1e-12)


def test_attention_over_a_sharded_cache_on_a_3d_mesh(tmp_path):
    ranks = W.spawn_group(W.ring_attention_task, 4, tmp_path, 1, 16, 25, 5,
                          64, 0, (2, 1, 2))
    for want, got in ranks:
        assert got.shape == want.shape == (1, 1, 25, 64)
        assert (got - want).abs().max() <= ATTN_TOL


@pytest.fixture(scope="module")
def mesh_ops(tmp_path_factory):
    """Every rank's results of `_dist_workers.mesh_ops_task` (one 2-rank
    group for the cases below)."""
    return W.spawn_group(W.mesh_ops_task, 2,
                         tmp_path_factory.mktemp("mesh_ops"), 0)


def test_tp_matmul_and_its_gradients(mesh_ops):
    for out in mesh_ops:
        assert len(out["tp_matmul"]) == 12
        for want, got in out["tp_matmul"]:
            assert got.shape == want.shape
            assert torch.allclose(got, want, rtol=0.0, atol=1e-12)


def test_local_weight_gradient_sums_the_token_shards(mesh_ops):
    for out in mesh_ops:
        assert len(out["local_weight"]) == 2
        for want, got in out["local_weight"]:
            assert torch.allclose(got, want, rtol=0.0, atol=1e-12)


def test_vocab_sharded_loss_terms(mesh_ops):
    for out in mesh_ops:
        assert len(out["vocab_loss"]) == 6
        for want, got in out["vocab_loss"]:
            assert got.shape == want.shape
            assert torch.allclose(got, want, rtol=0.0, atol=1e-12)


@pytest.mark.parametrize("B", [2, 1])
def test_prefill_attention_shares_the_unsharded_dims(B, mesh_ops):
    for out in mesh_ops:
        for want, got in out[f"attention_b{B}"]:
            assert got.shape == want.shape
            assert (got - want).abs().max() <= ATTN_TOL


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "hymba-1.5b"])
def test_decode_cell_runs_with_the_reference_counts(arch, tmp_path):
    shape = SHAPES["decode_32k"]
    rec = D.run_cell(get_config(arch), shape, arch=arch, mesh="16x16")
    assert rec["status"] == "ok", rec.get("error")
    jcfg = jbase.get_config(arch)
    n, a = jT.count_params(jcfg), jT.active_params(jcfg)
    assert (rec["n_params"], rec["n_active"]) == (n, a)
    assert rec["model_flops"] == jroof.model_flops_for(
        jcfg, jbase.SHAPES["decode_32k"], n, a)
    assert rec["cost"]["flops"] > 0 and rec["collectives"]
