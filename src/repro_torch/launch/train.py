"""Training CLI, port of `repro/launch/train.py`.

    python -m repro_torch.launch.train --arch rns-smollm-135m-fused \\
        --steps 30 --batch 8 --seq 256 --workdir build/train/run1
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch rns-smollm-135m-fused --smoke --device cpu --workdir W

Random parameters from ``--seed`` (`models.transformer.make_params`), the
config's optimizer on the cosine schedule, the stateless data pipeline and
the fault-tolerant `train.runtime.TrainLoop` (auto-resume from
``<workdir>/ckpt``, periodic and SIGTERM checkpoints, straggler
watchdog).  Without ``--workdir`` each run gets a new directory under the
temporary directory (``TMPDIR``), named on stderr, so it resumes nothing;
a run resumes only from a ``--workdir`` given again.  Prints the
reference's JSON summary.  Training runs on the
card unless ``--device cpu`` is given, and raises without one.

Started by ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) or with a
process group already initialised, every process joins the group (gloo on
the CPU, NCCL on the card, one card a local rank) and trains on
`launch.mesh.make_host_mesh()`, all data parallel as in the reference:
`build` places the parameters, the optimizer state and every batch as
DTensors by `launch.sharding`'s rules, the train step runs as a DTensor
program, and the loop's ``shard_fn`` places a restored checkpoint the
same way.  Rank 0 prints the summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.launch.sharding import (batch_specs, distribute,
                                         param_specs)
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.runtime import TrainLoop
from repro_torch.train.tree import tree_map
from repro_torch.train.trainstep import make_train_step

__all__ = ["main", "parser", "build", "summary", "train_device",
           "make_batch_fn", "mesh_step", "join_group"]


def train_device(device=None) -> torch.device:
    """``device`` (default "cuda"); raises when CUDA is asked for but
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training needs a CUDA device and none is "
                           "available; pass --device cpu to run on the CPU")
    return dev


def make_batch_fn(cfg, seed: int, batch: int, seq: int, device):
    """step → the step's batch on ``device``: tokens and labels from
    `data.pipeline.batch_for_step`, or, for an embeddings frontend, one-hot
    embeddings of ``token % d_model`` in bf16 (the reference's stub)."""
    def batch_fn(step):
        b = batch_for_step(seed, step, batch, seq, cfg.vocab_size)
        labels = torch.from_numpy(b["labels"]).to(device)
        tokens = torch.from_numpy(b["tokens"]).to(device)
        if cfg.frontend == "embeddings":
            emb = torch.nn.functional.one_hot(
                (tokens % cfg.d_model).long(), cfg.d_model)
            return {"embeds": emb.to(torch.bfloat16), "labels": labels}
        return {"tokens": tokens, "labels": labels}
    return batch_fn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warmup steps (default: a tenth of the steps, at "
                    "most 200)")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="checkpoints and metrics; a run resumes from the "
                    "newest checkpoint here (default: a new directory "
                    "under TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=None,
                    help="optional width override (examples use this)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def mesh_step(step_fn):
    """A train step run as a DTensor program: tensors the step makes
    (schedules, masks, positions) are taken as replicated, and the new
    parameters and optimizer state keep the placements they came in
    (the reference's ``out_shardings``), so every step runs one layout."""
    def pin(new, old):
        return (new.redistribute(old.device_mesh, old.placements)
                if tuple(new.placements) != tuple(old.placements) else new)

    def step(params, opt_state, batch, i):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            new_p, new_s, metrics = step_fn(params, opt_state, batch, i)
        return (tree_map(pin, new_p, params), tree_map(pin, new_s, opt_state),
                metrics)
    return step


def build(args, mesh=None):
    """(config, `TrainLoop`) of parsed arguments: the loop resumes from
    ``<workdir>/ckpt`` when it holds a checkpoint.  Without a workdir,
    ``args.workdir`` is set to a new directory.  With a ``mesh``
    (`launch.mesh.Mesh` over an initialised group) the parameters, the
    optimizer state and each batch are DTensors placed by the rules
    (`sharding.param_specs` / `batch_specs`), and a restored checkpoint
    is placed the same way (``shard_fn``)."""
    dev = train_device(args.device)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="repro-train-")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.layers:
        over["num_layers"] = args.layers
    if over:
        cfg = dataclasses.replace(cfg, **over)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.make_params(cfg, gen, device=dev)
    opt = make_optimizer(cfg, total_steps=args.steps, base_lr=args.lr,
                         warmup=args.warmup)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, n_micro=args.n_micro)
    batch_fn = make_batch_fn(cfg, args.seed, args.batch, args.seq, dev)
    shard_fn = None
    if mesh is not None:
        def shard_fn(tree):
            return distribute(mesh, tree, param_specs(mesh, cfg, tree))

        def mesh_batch(step, plain=batch_fn):
            b = plain(step)
            return distribute(mesh, b, batch_specs(mesh, cfg, b))

        params, opt_state = shard_fn(params), shard_fn(opt_state)
        step_fn, batch_fn = mesh_step(step_fn), mesh_batch
    loop = TrainLoop(train_step=step_fn, batch_fn=batch_fn, params=params,
                     opt_state=opt_state, workdir=args.workdir,
                     ckpt_every=args.ckpt_every, shard_fn=shard_fn)
    return cfg, loop


def join_group(device) -> bool:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1),
    unless one is initialised already: gloo for the CPU, NCCL for the
    card (this process's card its ``LOCAL_RANK``).  True when the run is
    one of several processes."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def summary(cfg, args, res) -> dict:
    """The reference's JSON summary of a run."""
    return {"arch": cfg.name, "steps_run": len(res["losses"]),
            "first_loss": res["losses"][0] if res["losses"] else None,
            "last_loss": res["losses"][-1] if res["losses"] else None,
            "stragglers": res["stragglers"],
            "tokens_per_step": args.batch * args.seq}


def main(argv=None):
    args = parser().parse_args(argv)
    mesh = None
    if join_group(train_device(args.device)):
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(
            device_type=train_device(args.device).type)
        if args.workdir is None:          # one directory for every rank
            box = [tempfile.mkdtemp(prefix="repro-train-")
                   if dist.get_rank() == 0 else None]
            dist.broadcast_object_list(box, src=0)
            args.workdir = box[0]
    cfg, loop = build(args, mesh)
    first = mesh is None or mesh.device_mesh.get_rank() == 0
    if first:
        print(f"workdir: {args.workdir}", file=sys.stderr)
    res = loop.run(args.steps)
    if first:
        print(json.dumps(summary(cfg, args, res), indent=2))
    return res


if __name__ == "__main__":
    main()
