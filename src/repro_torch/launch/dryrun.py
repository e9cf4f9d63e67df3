"""The dry run on one card, port of `repro/launch/dryrun.py`.

For every (arch × shape) cell, the cell's step runs on tensors on the meta
device (shapes and dtypes, no data, no allocation), under the residency
pass's `analysis.residency.TraceMode`:

    train   → `train.trainstep.make_train_step`: loss, backward, the
              optimizer's update, with the optimizer state
    prefill → `models.transformer.forward` (full-sequence logits)
    decode  → `models.transformer.decode_step`, one token against an
              S-slot cache

and records the parameter counts, MODEL_FLOPS (`roofline.model_flops_for`),
what the trace counts (the counterpart of the reference's compiled
``cost_analysis``: the float flops of the aten ops outside the kernels by
`torch.utils.flop_counter`'s formulas, the kernels' operations from their
call shapes, the kernel calls by wrapper), the counterpart of its
``memory_analysis`` (the argument bytes, and the peak of live bytes of the
storages the step makes as its temp estimate), whether it fits one 80 GB
card, the analytic model on one device (`costs.analytic_cost`) and its
roofline on H100 constants.  A step that needs data on meta (a
data-dependent shape, a host read) is recorded with ``status: "error"``
and the op that raised; a cell in the config's ``skip_shapes`` is
recorded with ``status: "skip"``.  No cell is dropped.

The reference's 16×16 and 2×16×16 meshes wait for the distributed port.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch rns-smollm-135m-fused \\
      --batch 8 --seq 256 --kind train
  python -m repro_torch.launch.dryrun --all [--jobs N] [--out PATH]

Records go to ``--out`` (default ``build/dryrun/dryrun.jsonl`` under the
checkout, which git ignores), one JSON line a cell, appended in the order
of the cells.  ``--jobs`` runs the cells in that many worker processes
(meta ops cost host time only; an SSM prefill at 32k runs ~560k of them).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

from repro_torch.analysis.residency import TraceMode, tensors
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs)
from repro_torch.launch import roofline as RL
from repro_torch.launch.costs import analytic_cost
from repro_torch.launch.inputs import (abstract_cache, abstract_params,
                                       input_specs)
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.trainstep import make_train_step

__all__ = ["run_cell", "main", "DEFAULT_OUT", "SKIP_REASON"]

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "build" / "dryrun"
               / "dryrun.jsonl")
SKIP_REASON = ("full-attention arch: no sub-quadratic structure for 500k "
               "decode")
FLOAT_KERNELS = ("flash_attention",)      # kernels whose operations are flops


def _bytes(tree) -> int:
    """Bytes of the distinct storages of a nested structure's tensors."""
    seen = {}
    for t in tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _step(cfg: ModelConfig, shape: ShapeConfig):
    """(the cell's step as a thunk, its arguments) on meta."""
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        params = abstract_params(cfg, encoded=False)
        opt = make_optimizer(cfg)
        state = opt.init(params)
        step = make_train_step(cfg, opt)
        return (lambda: step(params, state, batch, 0)), (params, state, batch)
    params = abstract_params(cfg)
    if shape.kind == "prefill":
        return (lambda: T.forward(cfg, params, batch)), (params, batch)
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    return (lambda: T.decode_step(cfg, params, cache, batch,
                                  shape.seq_len - 1)), (params, cache, batch)


def run_cell(cfg: ModelConfig, shape: ShapeConfig, *, arch: str | None = None,
             tag: str = "") -> dict:
    """Run one cell on meta; returns its record (never raises)."""
    rec = {"arch": arch or cfg.name, "shape": shape.name, "mesh": "1x1",
           "tag": tag, "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "status": "ok",
           "n_devices": 1}
    if shape.name in cfg.skip_shapes:
        rec.update(status="skip", reason=SKIP_REASON)
        return rec
    t0 = time.perf_counter()
    n_params, n_active = T.count_params(cfg), T.active_params(cfg)
    rec.update(n_params=n_params, n_active=n_active,
               model_flops=RL.model_flops_for(cfg, shape, n_params,
                                              n_active))
    mode = TraceMode(flops=True, memory=True)
    try:
        thunk, args = _step(cfg, shape)
        with torch.set_grad_enabled(shape.kind == "train"), mode:
            thunk()
        s = mode.summary
        kops = {k: v for k, v in s.kernel_ops.items()
                if k not in FLOAT_KERNELS}
        rec["cost"] = {
            "flops": (sum(s.flops.values())
                      + sum(s.kernel_ops.get(k, 0.0)
                            for k in FLOAT_KERNELS)),
            "int8_ops": sum(kops.values()),
            "flops_by_op": dict(s.flops), "kernel_ops": dict(s.kernel_ops)}
        rec["kernel_calls"] = dict(s.kernel_calls)
        rec["host_syncs"] = dict(s.syncs)
        arg = _bytes(args)
        rec["memory"] = {"argument_bytes": arg, "temp_bytes": s.peak_bytes}
        rec["fits"] = arg + s.peak_bytes <= RL.HBM_BYTES
        rec["analytic"] = analytic_cost(cfg, shape, n_pods=1, data=1,
                                        model=1).as_dict()
        a = RL.analyze(rec)
        rec["roofline"] = {
            "compute_s": a.compute_s, "memory_s": a.memory_s,
            "collective_s": a.collective_s, "dominant": a.dominant,
            "bound_s": a.bound_s, "useful_ratio": a.useful_ratio,
            "roofline_fraction": a.roofline_fraction}
    except Exception as e:      # a cell that cannot run on meta is recorded
        rec.update(status="error", op=mode.summary.failed_op,
                   error=f"{type(e).__name__}: {e}"[:500],
                   traceback=traceback.format_exc()[-2000:])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _cell(arch: str, shape: ShapeConfig) -> dict:
    return run_cell(get_config(arch), shape, arch=arch)


def _cost_rank(arch: str, shape: ShapeConfig) -> tuple:
    """Slowest cells first: SSM stacks loop over chunks, and full-sequence
    steps run far more ops than a decode step."""
    cfg = get_config(arch)
    return (shape.kind == "decode", not cfg.ssm, shape.kind != "train")


def _single_thread() -> None:
    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--kind", default=None,
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--all", action="store_true",
                    help="every registered arch × every shape")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (default 1: in this process)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    custom = (args.batch, args.seq, args.kind)
    if any(v is not None for v in custom):
        if None in custom or args.shape or args.all:
            ap.error("--batch, --seq and --kind go together, without "
                     "--shape or --all")
        shapes = [ShapeConfig(f"{args.kind}_b{args.batch}_s{args.seq}",
                              args.seq, args.batch, args.kind)]
    else:
        shapes = [SHAPES[n] for n in
                  (SHAPES if args.all or not args.shape else [args.shape])]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    cells = [(a, s) for a in archs for s in shapes]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                 initializer=_single_thread) as pool:
            futures = {c: pool.submit(_cell, *c)
                       for c in sorted(cells, key=lambda c: _cost_rank(*c))}
            recs = [futures[c].result() for c in cells]
    else:
        recs = (_cell(*c) for c in cells)
    counts = {"ok": 0, "skip": 0, "error": 0, "fits": 0}
    for rec in recs:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        counts[rec["status"]] += 1
        counts["fits"] += bool(rec.get("fits"))
        if rec["status"] == "ok":
            extra = (f"flops {rec['cost']['flops']:.3e} int8 "
                     f"{rec['cost']['int8_ops']:.3e} | args "
                     f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB "
                     f"temp {rec['memory']['temp_bytes'] / 1e9:.2f} GB "
                     f"fits {rec['fits']} | dominant "
                     f"{rec['roofline']['dominant']} frac "
                     f"{rec['roofline']['roofline_fraction']:.3f}")
        else:
            extra = rec.get("reason") or f"{rec['op']}: {rec['error']}"
        print(f"[dryrun] {rec['arch']} × {rec['shape']}: {rec['status']} "
              f"({rec.get('seconds', 0):.1f} s) {extra}", flush=True)
    print(f"[dryrun] {counts} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
