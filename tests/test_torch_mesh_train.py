"""The sharded train step (`launch.train.build(args, mesh)`,
`TrainLoop(shard_fn=)`, checkpoints of DTensor trees) on a (2, 2) host
mesh of 4 ``gloo`` ranks (`_dist_workers.spawn_group`), held against the
unsharded port on the CPU: 3 steps of the smoke ``rns-smollm-135m-fused``.

- the mesh run's losses are within ``LOSS_TOL`` of the one-process run's
  (the RNS linears give the same bits on their local shards; DTensor
  reorders the float sums of the norms, the loss and the backward);
- a mesh loop resumed from the mesh run's step-2 checkpoint (through its
  ``shard_fn``) takes step 3 bit-equal to the uninterrupted mesh run;
- the mesh run's checkpoint restores in a one-process run (whole tensors,
  equal to the mesh's gathered parameters) and a one-process checkpoint
  restores in a mesh run, each taking step 3 within ``LOSS_TOL``.
"""
import pathlib

import pytest
import torch

import _dist_workers as W
from repro_torch.launch import train as LT
from repro_torch.train import checkpoint as ckpt

ARCH = "rns-smollm-135m-fused"
STEPS = 3
# absolute, on losses of ~4.9: DTensor reorders float sums (measured
# 1.5e-4 at step 3 on torch 2.13, from the parameters' second update)
LOSS_TOL = 1e-3


def _args(workdir):
    return LT.parser().parse_args([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", str(STEPS),
        "--batch", "4", "--seq", "16", "--lr", "1e-2", "--ckpt-every", "2",
        "--workdir", str(workdir)])


def _full(tree):
    from repro_torch.train.tree import leaves
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in leaves(tree)]


def mesh_task(rank, n, _mesh, root):
    """On every rank: the uninterrupted mesh run, its resume from step 2
    (the restored parameters gathered whole on rank 0), and the resume of
    the one-process run's step-2 checkpoint."""
    from repro_torch.launch.mesh import make_host_mesh

    root = pathlib.Path(root)
    mesh = make_host_mesh(model=2)
    _, loop = LT.build(_args(root / "mesh"), mesh)
    placements = {str(p) for t in _full_placements(loop.params)
                  for p in t}
    full = loop.run(STEPS)["losses"]
    _, again = LT.build(_args(root / "mesh"), mesh)
    params = _full(again.params)        # restored and placed by shard_fn
    resumed = (again.start_step, again.run(STEPS)["losses"])
    _, other = LT.build(_args(root / "single"), mesh)
    crossed = (other.start_step, other.run(STEPS)["losses"])
    return {"full": full, "resumed": resumed, "crossed": crossed,
            "params": params if rank == 0 else None,
            "placements": placements}


def _full_placements(tree):
    from repro_torch.train.tree import leaves
    return [t.placements for t in leaves(tree)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train")
    _, single = LT.build(_args(root / "single"))
    plain = single.run(STEPS)["losses"]
    ranks = W.spawn_group(mesh_task, 4, root / "group", str(root),
                          timeout=150.0)
    _, restored = LT.build(_args(root / "mesh"))
    ckpt_params = [t.clone() for t in _leaves(restored.params)]
    back = (restored.start_step, restored.run(STEPS)["losses"])
    return {"plain": plain, "ranks": ranks, "back": back,
            "ckpt_params": ckpt_params, "root": root}


def _leaves(tree):
    from repro_torch.train.tree import leaves
    return leaves(tree)


def test_mesh_losses_match_one_process(runs):
    plain = runs["plain"]
    for r in runs["ranks"]:
        assert len(r["full"]) == STEPS
        assert r["full"] == runs["ranks"][0]["full"]       # every rank
        for got, want in zip(r["full"], plain):
            assert abs(got - want) <= LOSS_TOL, (r["full"], plain)
    # the parameters really were sharded on both mesh axes
    kinds = runs["ranks"][0]["placements"]
    assert any(k.startswith("S(") for k in kinds), kinds


def test_mesh_resume_is_bit_equal(runs):
    for r in runs["ranks"]:
        start, losses = r["resumed"]
        assert start == 2 and len(losses) == 1
        assert losses[0] == r["full"][2]


def test_checkpoints_cross_between_mesh_and_one_process(runs):
    mesh_full = runs["ranks"][0]["full"]
    start, losses = runs["back"]
    assert start == 2 and len(losses) == 1
    assert abs(losses[0] - mesh_full[2]) <= LOSS_TOL
    for r in runs["ranks"]:
        start, losses = r["crossed"]
        assert start == 2 and len(losses) == 1
        assert abs(losses[0] - runs["plain"][2]) <= LOSS_TOL
    # the files are whole tensors: the one-process restore holds, bit for
    # bit, what the mesh's resume placed through its shard_fn
    path = runs["root"] / "mesh" / "ckpt"
    assert ckpt.latest_step(str(path)) == 1
    placed = runs["ranks"][0]["params"]
    assert len(placed) == len(runs["ckpt_params"])
    for got, want in zip(runs["ckpt_params"], placed):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
