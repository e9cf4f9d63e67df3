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

Mesh cells (``mesh="16x16"`` or ``"2x16x16"``) follow the reference's
``lower_cell``: the step runs as a DTensor program on meta over the
production mesh of a ``fake`` process group (`launch.mesh.
fake_production_mesh`), with the reference's parameter form (the raw
float weights, ``abstract_params(cfg, encoded=False)``, for every kind)
placed by ``param_specs(mesh, cfg, params, mode)``, the optimizer state
by the same rules, batches by ``batch_specs`` and caches by
``cache_specs`` (`launch.sharding.distribute`).  Plain tensors the step
makes are taken as replicated (DTensor's ``implicit_replication``); a
kernel wrapper runs on its local shards by its rule
(`kernels/dtensor_rules.py`).  The trace (`residency.TraceMode(dtensor=
True)`) counts the local ops DTensor runs, at local shapes, so ``cost``
(flops, int8 ops, kernel calls) is per device; DTensor's sharding
propagation runs each op once more at global shapes to learn its output
shape, and those ops are left out (the mode ignores what runs inside the
propagator).  ``memory.argument_bytes`` is the local shards' bytes,
``memory.temp_bytes`` the peak of live local storages.  ``collectives``
prices the collectives DTensor issued, in the reference's keys
(`roofline.collective_bytes`; CPU meshes run DTensor's all-to-all as an
all-gather, and it is priced as one), and the roofline's collective term
is priced at `roofline.IB_BW`.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch rns-smollm-135m-fused \\
      --batch 8 --seq 256 --kind train
  python -m repro_torch.launch.dryrun --all [--jobs N] [--out PATH]
  python -m repro_torch.launch.dryrun --arch rns-smollm-135m-fused \\
      --both-meshes [--mode tp] [--mesh-split 64,4] [--set remat=False]

Records go to ``--out`` (default ``build/dryrun/dryrun.jsonl`` under the
checkout, which git ignores), one JSON line a cell, appended in the order
of the cells; a cell already recorded ``ok`` or ``skip`` there (same arch,
shape, mesh and tag) is skipped, as the reference's ``_done_cells``.
``--jobs`` runs the cells in that many worker processes (meta ops cost
host time only; an SSM prefill at 32k runs ~560k of them).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import multiprocessing
import os
import re
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
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         distribute, mode_for, param_specs)
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.trainstep import make_train_step

__all__ = ["run_cell", "main", "DEFAULT_OUT", "SKIP_REASON", "MESHES"]

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "build" / "dryrun"
               / "dryrun.jsonl")
SKIP_REASON = ("full-attention arch: no sub-quadratic structure for 500k "
               "decode")
FLOAT_KERNELS = ("flash_attention",)      # kernels whose operations are flops
MESHES = ("1x1", "16x16", "2x16x16")


def _bytes(tree) -> int:
    """Bytes of the distinct storages of a nested structure's tensors (a
    DTensor's: its local shard's)."""
    seen = {}
    for t in tensors(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
          mode: str | None = None):
    """(the cell's step as a thunk, its arguments) on meta; on a mesh, the
    raw float weights, the optimizer state, the batch and the cache as
    DTensors placed by the rules."""
    batch = input_specs(cfg, shape)
    raw = mesh is not None or shape.kind == "train"
    params = abstract_params(cfg, encoded=not raw)
    state = opt = None
    if shape.kind == "train":
        opt = make_optimizer(cfg)
        state = opt.init(params)
    cache = (abstract_cache(cfg, shape.global_batch, shape.seq_len)
             if shape.kind == "decode" else None)
    if mesh is not None:
        params = distribute(mesh, params,
                            param_specs(mesh, cfg, params, mode))
        batch = distribute(mesh, batch, batch_specs(mesh, cfg, batch, mode))
        if state is not None:
            state = distribute(mesh, state,
                               param_specs(mesh, cfg, state, mode))
        if cache is not None:
            cache = distribute(mesh, cache, cache_specs(mesh, cfg, cache))
    if shape.kind == "train":
        step = make_train_step(cfg, opt)
        return (lambda: step(params, state, batch, 0)), (params, state, batch)
    if shape.kind == "prefill":
        return (lambda: T.forward(cfg, params, batch)), (params, batch)
    return (lambda: T.decode_step(cfg, params, cache, batch,
                                  shape.seq_len - 1)), (params, cache, batch)


def _failed_op(mode: TraceMode, e: Exception) -> str:
    """The op that raised: the trace's, else the aten op DTensor's message
    names, else the port's function that raised."""
    if mode.summary.failed_op:
        return mode.summary.failed_op
    m = re.search(r"(aten\.[\w.]+)", str(e))
    if m:
        return m.group(1)
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    where = frames[-1] if frames else traceback.extract_tb(
        e.__traceback__)[-1]
    return f"{Path(where.filename).stem}.{where.name}"


def run_cell(cfg: ModelConfig, shape: ShapeConfig, *, arch: str | None = None,
             mesh: str | None = None, mode: str | None = None,
             mesh_split: tuple | None = None, overrides: dict | None = None,
             tag: str = "") -> dict:
    """Run one cell on meta; returns its record (never raises).  ``mesh``
    None or "1x1" is one card; "16x16" / "2x16x16" a DTensor cell over
    the fake production mesh, ``mesh_split`` = (data, model) refactoring
    its pod(s), ``mode`` the sharding mode (default `mode_for`).
    ``overrides`` replace config fields."""
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = mesh or "1x1"
    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh!r}")
    rec = {"arch": arch or cfg.name, "shape": shape.name, "mesh": mesh,
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
    on_mesh = mesh != "1x1"
    trace = TraceMode(flops=True, memory=True, dtensor=on_mesh)
    try:
        if on_mesh:
            multi_pod = mesh == "2x16x16"
            with fake_production_mesh(multi_pod=multi_pod,
                                      split=mesh_split) as m:
                mode = mode or mode_for(cfg)
                rec.update(mode=mode, n_devices=math.prod(m.shape.values()))
                if mesh_split:
                    rec["mesh_split"] = list(mesh_split)
                _trace(cfg, shape, rec, trace, m, mode)
                dd, mm = mesh_split or (16, 16)
                rec["analytic"] = analytic_cost(
                    cfg, shape, n_pods=2 if multi_pod else 1, data=dd,
                    model=mm, mode=mode).as_dict()
        else:
            _trace(cfg, shape, rec, trace)
            rec["analytic"] = analytic_cost(cfg, shape, n_pods=1, data=1,
                                            model=1).as_dict()
        a = RL.analyze(rec)
        rec["roofline"] = {
            "compute_s": a.compute_s, "memory_s": a.memory_s,
            "collective_s": a.collective_s, "dominant": a.dominant,
            "bound_s": a.bound_s, "useful_ratio": a.useful_ratio,
            "roofline_fraction": a.roofline_fraction,
            "link_bw": RL.link_bw(rec)}
    except Exception as e:      # a cell that cannot run on meta is recorded
        rec.update(status="error", op=_failed_op(trace, e),
                   error=f"{type(e).__name__}: {e}"[:500],
                   traceback=traceback.format_exc()[-2000:])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _trace(cfg, shape, rec, trace, mesh=None, mode=None) -> None:
    """Run the cell's step under ``trace`` and write what it counted into
    ``rec``."""
    thunk, args = _step(cfg, shape, mesh, mode)
    with torch.set_grad_enabled(shape.kind == "train"), trace:
        if mesh is None:
            thunk()
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                thunk()
    s = trace.summary
    kops = {k: v for k, v in s.kernel_ops.items() if k not in FLOAT_KERNELS}
    rec["cost"] = {
        "flops": (sum(s.flops.values())
                  + sum(s.kernel_ops.get(k, 0.0) for k in FLOAT_KERNELS)),
        "int8_ops": sum(kops.values()),
        "flops_by_op": dict(s.flops), "kernel_ops": dict(s.kernel_ops)}
    rec["kernel_calls"] = dict(s.kernel_calls)
    rec["host_syncs"] = dict(s.syncs)
    if mesh is not None:
        rec["collectives"] = RL.collective_bytes(s.wire)
        rec["collective_calls"] = len(s.wire)
    arg = _bytes(args)
    rec["memory"] = {"argument_bytes": arg, "temp_bytes": s.peak_bytes}
    rec["fits"] = arg + s.peak_bytes <= RL.HBM_BYTES


def _cell(arch: str, shape: ShapeConfig, mesh: str = "1x1", kw=None) -> dict:
    return run_cell(get_config(arch), shape, arch=arch, mesh=mesh,
                    **(kw or {}))


def _cost_rank(arch: str, shape: ShapeConfig, mesh: str) -> tuple:
    """Slowest cells first: mesh cells dispatch every op through DTensor,
    SSM stacks loop over chunks, and full-sequence steps run far more ops
    than a decode step."""
    cfg = get_config(arch)
    return (mesh == "1x1", shape.kind == "decode", not cfg.ssm,
            shape.kind != "train")


def _single_thread() -> None:
    torch.set_num_threads(1)


def _done_cells(path: str) -> set:
    """(arch, shape, mesh, tag) of the cells recorded ok or skip in
    ``path``."""
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("tag", "")))
    return done


def _overrides(items) -> dict:
    """``key=value`` config overrides, values as Python literals where
    they parse."""
    out = {}
    for kv in items:
        k, v = kv.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="one arch, or several separated by commas")
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--kind", default=None,
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--all", action="store_true",
                    help="every registered arch × every shape")
    ap.add_argument("--mesh", default=None, choices=MESHES,
                    help="one mesh (default 1x1, one card)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16x16 and 2x16x16 meshes")
    ap.add_argument("--mode", default=None, choices=("dp", "tp", "fsdp_tp"),
                    help="sharding mode of mesh cells (default: mode_for)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh-split", default=None,
                    help="logical data,model split of each 256-rank pod, "
                         "e.g. 64,4")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable; Python "
                         "literals), e.g. --set remat=False")
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
    if args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    elif args.multi_pod:
        meshes = ["2x16x16"]
    else:
        meshes = [args.mesh or ("16x16" if args.mesh_split else "1x1")]
    kw = {"mode": args.mode, "tag": args.tag,
          "overrides": _overrides(args.set) or None,
          "mesh_split": (tuple(int(v) for v in args.mesh_split.split(","))
                         if args.mesh_split else None)}
    archs = (list_archs() if args.all or not args.arch
             else args.arch.split(","))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    done = _done_cells(args.out)
    cells = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                if (a, s.name, m, args.tag) in done:
                    print(f"[dryrun] SKIP (done) {a} × {s.name} × {m}",
                          flush=True)
                else:
                    cells.append((a, s, m, kw))
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                 initializer=_single_thread) as pool:
            slow_first = sorted(cells, key=lambda c: _cost_rank(*c[:3]))
            futures = {id(c): pool.submit(_cell, *c) for c in slow_first}
            recs = [futures[id(c)].result() for c in cells]
    else:
        recs = (_cell(*c) for c in cells)
    counts = {"ok": 0, "skip": 0, "error": 0, "fits": 0}
    for rec in recs:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        counts[rec["status"]] += 1
        counts["fits"] += bool(rec.get("fits"))
        if rec["status"] == "ok":
            coll = sum(v for k, v in rec.get("collectives", {}).items()
                       if not k.endswith("_output_bytes"))
            extra = (f"flops {rec['cost']['flops']:.3e} int8 "
                     f"{rec['cost']['int8_ops']:.3e} | args "
                     f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB "
                     f"temp {rec['memory']['temp_bytes'] / 1e9:.2f} GB "
                     f"fits {rec['fits']} | dominant "
                     f"{rec['roofline']['dominant']} frac "
                     f"{rec['roofline']['roofline_fraction']:.3f}"
                     + (f" | wire {coll / 1e9:.3f} GB"
                        if rec["mesh"] != "1x1" else ""))
        else:
            extra = rec.get("reason") or f"{rec['op']}: {rec['error']}"
        print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: "
              f"{rec['status']} ({rec.get('seconds', 0):.1f} s) {extra}",
              flush=True)
    print(f"[dryrun] {counts} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
