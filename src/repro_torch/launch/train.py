"""Training CLI, port of `repro/launch/train.py`: one card, no mesh.

    python -m repro_torch.launch.train --arch rns-smollm-135m-fused \\
        --steps 30 --batch 8 --seq 256 --workdir build/train/run1

Random parameters from ``--seed`` (`models.transformer.make_params`), the
config's optimizer on the cosine schedule, the stateless data pipeline and
the fault-tolerant `train.runtime.TrainLoop` (auto-resume from
``<workdir>/ckpt``, periodic and SIGTERM checkpoints, straggler
watchdog).  Without ``--workdir`` each run gets a new directory under the
temporary directory (``TMPDIR``), named on stderr, so it resumes nothing;
a run resumes only from a ``--workdir`` given again.  Prints the
reference's JSON summary.  Training runs on the
card unless ``--device cpu`` is given, and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.runtime import TrainLoop
from repro_torch.train.trainstep import make_train_step

__all__ = ["main", "parser", "build", "summary", "train_device",
           "make_batch_fn"]


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


def build(args):
    """(config, `TrainLoop`) of parsed arguments: the loop resumes from
    ``<workdir>/ckpt`` when it holds a checkpoint.  Without a workdir,
    ``args.workdir`` is set to a new directory."""
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
    loop = TrainLoop(train_step=make_train_step(cfg, opt,
                                                n_micro=args.n_micro),
                     batch_fn=make_batch_fn(cfg, args.seed, args.batch,
                                            args.seq, dev),
                     params=params, opt_state=opt.init(params),
                     workdir=args.workdir, ckpt_every=args.ckpt_every)
    return cfg, loop


def summary(cfg, args, res) -> dict:
    """The reference's JSON summary of a run."""
    return {"arch": cfg.name, "steps_run": len(res["losses"]),
            "first_loss": res["losses"][0] if res["losses"] else None,
            "last_loss": res["losses"][-1] if res["losses"] else None,
            "stragglers": res["stragglers"],
            "tokens_per_step": args.batch * args.seq}


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, loop = build(args)
    print(f"workdir: {args.workdir}", file=sys.stderr)
    res = loop.run(args.steps)
    print(json.dumps(summary(cfg, args, res), indent=2))
    return res


if __name__ == "__main__":
    main()
