#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]   # from a checkout, one card

Phases, each of which must pass:
  1. device  — the card's name and power limit (nvidia-smi), the kernel
     library built from `src/repro_torch/csrc` (build seconds, registers
     and spills printed; flash instances by route on a second line);
  2. kernels — each CUDA kernel against its plain PyTorch version, bit for
     bit, at every launch shape of the three serving paths and at an odd
     shape, with median times (CUDA events; weights read cold from device
     memory), the plain version's time, a one-call PyTorch yardstick and
     the least time the card could take (bytes over HBM rate or int8 ops
     over the int8 peak, whichever is larger).  Past 16 rows the tile
     kernel runs pinned at each height, the 32-row `mma.sync` tile and
     the 16-row `__dp4a` tile, and for a raw int8 A operand (the staged
     path's broadcast `rns_matmul`) first the 64-row `wgmma` + TMA tile,
     each held bit for bit and the heights timed in turns (a row's own
     time is the launch as the tuner resolves it); `prefill:` lines sum
     each served path's launches of one layer at M = 512 for each
     height, `decode:` lines each
     path's launches of one layer at M = 8 (the 16-row tile, K split over
     thread-block clusters).  The conversion kernels (`rns_forward`,
     `rns_reverse`) are timed over operand copies that outgrow the L2; an
     `edge:` line holds both bit-equal to their plain versions on every
     length 0-33, views off a 16-byte boundary, C = 1-12, moduli up to
     2^31 - 1, INT32_MIN/MAX and every (C, L) instance of the reverse
     with and without a scale, and a `convert:` line sums one layer's
     conversions at decode and prefill; `rns_modmul` at the staged
     chain's (7, 8·1536) and (7, 512·1536), int8 and int32 out, over
     operand pairs that outgrow the L2 (`modmul:` line);
  3. serve   — three full 30-layer models (published widths, seeded random
     weights) served through `serve.Engine`: `rns-smollm-135m-fused`
     (encoded weights, one fused launch per linear),
     `rns-smollm-135m-resident` (residue-resident QKV and MLP chains) and
     `rns-smollm-135m-pallas` (live weights on the staged kernels); each
     under both engines, the per-token loop (``engine="host"``: its
     launch counts, the prefill's tile launches at 32 rows, every decode
     step's at 16) and the captured decode step replayed
     (``engine="scan"``: the warm-up's and the capture's launches equal
     to one host step's, one replay a token, greedy tokens equal to the
     host loop's), batch invariance with pinned lanes under both, prefill
     time, decode ms a token of both engines timed in turns, and one
     traced generate of each (host 4 tokens, scan 32: device busy share).
     Launch counts are exact without the profiler: the captured step's
     kernel nodes, read from the CUDA graph by function name
     (`kernels._build.graph_kernels`), equal its counted launches, the
     replays the engine's counter, the eager prefill's counted launches one
     prefill's;
  4. sched   — `serve.SlotScheduler` on the full fused and resident
     models: 8 slots of 256 tokens over a paged pool of 65 blocks of 16
     (half the static reservation), decode chunks of 8 replayed steps of
     one captured paged step, a synthetic trace of 24 seeded requests
     with Poisson arrivals (six sharing a 2-block head): outputs equal to
     the engine's solo generate (greedy, and sampled on a second
     scheduler), peak blocks, prefix hits and pool bytes against the
     static reservation, the captured step's launches equal to one eager
     paged step's, a traced burst serve (8 admissions, 8 replays): the
     paged graph's kernel nodes equal the step's counted launches and the
     admissions' counted launches 8 prefills', and serves of the trace and
     of the same requests as a burst timed in turns with the static
     engine's one-batch generate of the same prompts;
  5. chain   — `rns_chain_linear` on the staged kernels equal bit for bit
     to the fused kernel at the full-width MLP shapes;
  6. entry   — the entry points no served model calls, once each at full
     width with their launches counted: `flash_attention` (8 lanes, 9
     heads, head_dim 64, 2048 keys, prefill and decode; outputs held
     against the plain version), `fold`, and one smollm layer's linears as
     one-channel `rns_fused_crt_partial` slices composed by
     `dist.rns_shard.channel_sliced_matmul` and held bit for bit against
     `rns_fused_matmul`; then the `int8` phase: the exact-int8 entry
     `rns_int_matmul` on its three routes (fused raw-int8
     `rns_fused_matmul`; staged forward + broadcast `rns_matmul` +
     reverse; per-channel, both operands converted), encoded and live
     weights, scales none, (1, N), (M, 1), (M, N), on the four smollm
     layer shapes at M = 8 and 512, every result bit-equal to the float64
     product of the int8 operands times the scale and to its plain
     version, the launches of each call as its route implies, and the
     raw-int8 `rns_fused_crt_partial` (encoded and live) as one-channel
     slices composed through `crt_finish`; the new forms timed (`int8:`
     lines: one layer at decode and prefill beside `torch._int_mm` and
     bf16 `torch.matmul`; at prefill the 64-row `wgmma` tile and the
     32-row `mma.sync` tile pinned, in turns, each held bit for bit);
  7. tune    — before serve: the tile kernel's autotuner
     (`kernels/tune.py`, reading and writing a copy of the committed H100
     table under build/) on the three full models: every decode shape an
     Engine warms is a table hit and init sweeps nothing; greedy tokens and
     prefill logits bit-equal between the tuned and the static choices in
     turns; a `tune:` line per distinct shape with both choices' device µs.
     Over the serve and sched phases: no tuner miss inside a graph capture
     and no sweep inside a timed call;
  8. verify  — ``Engine(verify="static")`` accepts every registered config
     at full width, refuses another ``verify`` value, and `check_pipeline`
     refuses the undersized chain basis with AnalysisError;
  9. twit    — the paper's twit multiplier and adder as tensors on the
     card: every pair of every modulus at n = 5 and 8, 2^16 seeded pairs
     of each at n = 11, bit-equal to (a·b, a+b) mod m and to the scalar
     models; on the paper's n = 5 basis equal to the `rns_modmul` kernel;
     timed;
  10. check  — finite logits of each served batch, and each smoke config's
     logits on the card against the same model on the CPU (plain versions);
  11. families — the other model families at their published widths, one
     model at a time (seeded weights, freed before the next), each through
     `serve.Engine` under both engines in 8 lanes: hymba-1.5b (32 layers;
     prompts bucketed to 1024, so its 1024-slot rings wrap during decode),
     the same weights on `rns_int8:pallas_fused` (the fused kernel at C = 5
     and 6, read from the captured graph by channel count; prefill logits
     within the reference's int8 check, relative error below 0.35, of the
     bf16 run's), gemma2-2b, mamba2-1.3b (also through `SlotScheduler`,
     equal to solo), moonshot-v1-16b-a3b (12 of its 48 layers) and the
     dense bf16 smollm-135m: scan == host, batch invariance (not for MoE),
     launches a step, prefill ms (and the prefill alone with its plain
     linears summed in float64, as served, against the library GEMM, in
     turns), decode ms a step of each engine in turns, tokens/s, peak
     device memory; the fused run's `rns_fused_matmul` and `rns_forward`
     at its own shapes (C = 5 and 6, every M it launches, both tile
     heights) bit for bit against their plain versions; then the nine zoo
     smoke twins on the card against the CPU;
  12. train  — the training path of `rns-smollm-135m-fused` at full width
     (B 8 × S 256, so every linear is a live raw-int8 `rns_fused_matmul`
     launch at M = 2048): those four launch shapes bit for bit against
     the plain version, timed against their bound and bf16 `torch.matmul`;
     30 AdamW steps (lr 1e-3, warmup 5, seed 0) through the CLI's
     `TrainLoop` (`launch.train.build`), the mean loss of the last 5 steps
     below the first 5's less 0.3; one step launches exactly 14 fused
     kernels a layer under remat "full" and 7 under "none", and no other
     port kernel; a step of the fused and of bf16 `smollm-135m` on the same
     data timed in turns (ms, tokens/s, peak memory) and one traced fused
     step (busy share, top kernels, the tile kernel's share); 2 steps, a
     checkpoint, an auto-resumed `TrainLoop` and 2 steps bit-equal to the
     run's first 4 steps (parameters and both AdamW moments); one smoke train
     step of the fused, staged and bf16 twins on the card within the CPU
     tests' bounds of the CPU's, fused == staged bit for bit; the encoded
     weight's straight-through gx bit-equal to x @ ŵ; the trained weights
     and the same weights restored from the run's checkpoint served by
     `Engine` (scan, 8 greedy tokens) give the same tokens.
  13. analysis — the trace passes and the cost layer: one eager prefill
     and decode step of each served 30-layer path and one train step of
     `rns-smollm-135m-fused` (B 8 × S 256, remat full) under the
     residency pass (`repro_torch.analysis.residency`, a dispatch trace
     whose kernel regions are the wrappers): kernel calls by wrapper equal
     `residency.expected_*` (210 fused; 150 fused + 60 `rns_forward`;
     3 × 210 staged; 420 fused a train step), no host sync in a decode
     step, no remainder outside a kernel on the resident path; the
     counted flops and int8 ops beside `launch.costs.analytic_cost`'s; a
     `roofline:` line for each path's prefill and scan decode step and the
     train step (analytic bound on the H100 constants of
     `launch.roofline` against the serve and train phases' times); the dry
     run (`launch.dryrun --all`, meta tensors, worker processes started
     with the script, beside the kernel build and the device-timed kernel
     rows, and ended before the serve phase, whose times are the host's)
     over every registered config ×
     `SHAPES` (a `dryrun:` count line), the mesh dry run beside it
     (`launch.dryrun --both-meshes` for `rns-smollm-135m-pallas` and
     `-fused`: DTensor programs on meta over a fake 256- and 512-rank
     group; a `dryrun-mesh:` line with the counts, 12 ok and 4 skip
     required, the parameter counts and MODEL_FLOPS held equal to
     `experiments/dryrun.jsonl`, and the collective bytes beside GSPMD's),
     and the train step's meta memory estimate within 25% of its
     `max_memory_allocated` plus arguments.
  14. dist   — sharded serving (`repro_torch.dist`) on `torch.distributed`:
     ranks are spawned processes on the one card in a ``gloo`` group over
     a `FileStore`, each joined with its own deadline; any rank's failure
     fails the phase.  A 5-rank group (channel layout: C = 5 on every
     basis, one channel a rank) and a 2-rank group (column layout forced)
     each check every distinct full-width linear of `-fused` and the
     resident chain's shapes (``emit="residues"`` included) at M = 8 and
     512: every rank's `sharded_fused_matmul` bit-equal to the full-basis
     `rns_fused_matmul`, the rank's kernel device µs (graph-timed, one rank
     at a time) beside the full-basis launch's and the bound, the wall µs
     of the collective step that follows the kernel (the all-reduce and
     the epilogue, as `rns_shard.rank_launch` splits the launch) and
     `comms` wire bytes; then
     `rns-smollm-135m-sharded` (5 ranks channel, 2 ranks column) and
     `-resident-sharded` (5 ranks auto) through `Engine(mesh=…)`: 4 ragged
     prompts in 8 lanes, 8 greedy tokens (4 for the 5-rank channel run)
     under ``engine="host"`` and 2 under the uncaptured ``"scan"``, tokens
     and prefill logits bit-equal to the unsharded Engine's on every rank,
     a decode step's launches a rank as `dist.engine.decode_launches`
     reads them off the placed weights (210 `rns_fused_crt_partial` and
     no `rns_fused_matmul` for the channel run); one channel decode step
     under the residency pass (only limb-plane and float collectives,
     `check_reduced_wire` clean, `comms.collective_wire_bytes` beside
     `costs.comms_bytes_decode`); `compressed_mean_all_reduce` on 2 ranks
     over the fused model's parameter shapes bit-equal to the formula on
     one process; each group also runs `rns_int_matmul` with raw int8
     x in its layout (5 ranks channel, 2 column), live and encoded
     weights, every scale form: every rank bit-equal to the unsharded
     launch.
Phase 2 also holds `flash_attention` (|err| <= 2^-7*|want| + 1e-3 in
bf16, one output ulp; 2e-5 in float32; fully masked rows exactly 0) on
the route each shape takes (`split`, `mma`, `fma` or `wide`, named on
its row; bf16 prefill also pinned to `fma`, held alike and timed in turns
with `mma`; a `flash:` line sums up decode, prefill and `fold`),
`fold` and `rns_fused_crt_partial` (bit for bit; every crt shape composed
for n = 1 and n = C) against their plain versions; the flash rows include
the zoo's other head sizes (256, 80, 96, and 8 padded to 16) and D = 512
on the wide route, whose rows name the backend
`scaled_dot_product_attention` picked (a `flash heads:` line).  Lines:
per-shape kernel rows, the `edge:` and `convert:` lines, a `kernels:` summary, the
`decode:` and `prefill:` sums, the `tune:` lines, a `verify:` line, one
`serve:` line per model, one `sched:` line per scheduled model, a
`chain:` line, an `entry:` line, the `int8:` lines, the `twit:` lines, one `check:`
line per smoke config, the `families:` lines, the `train:` lines, the
`residency:`, `costs:`, `roofline:`, `dryrun:` and `dryrun-mesh:` lines,
the `dist:`
lines, the nvidia-smi line, the kernels JSON line and, last, the device JSON line.  ``--record
PATH`` also writes every row, the serve numbers and the traces as JSON.
Exits non-zero without a CUDA device or without the port's sources beside
it.
"""
import argparse
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# flash_attention against its plain version, which also computes in
# float32: |got - want| <= rtol*|want| + atol elementwise, one bf16 ulp of
# the output for bf16; fully masked rows must be exactly 0.
FLASH_TOL = {"bfloat16": (2.0**-7, 1e-3), "float32": (0.0, 2e-5)}
COLD_L2_BYTES = 120 << 20          # > 2x the 50 MB L2: weights read cold
# the raw-int8 tile instances: 16-row by channel count, then 32-row
RAW_TILE_SOURCES = ("rns_tile_raw.cu", "rns_tile_raw_wide.cu",
                    "rns_tile_mma_raw.cu", "rns_tile_wg_raw.cu",
                    "rns_tile_wg_raw_live.cu")
# the 64-row wgmma + TMA instances of the raw int8 A mode (rns_tile_wg.cuh)
WG_TILE_SOURCES = ("rns_tile_wg_raw.cu", "rns_tile_wg_raw_live.cu")
# rounds of the serve phase's decode timing, host and scan in turns
DECODE_ROUNDS = 2
ARCH = "rns-smollm-135m-fused"
RESIDENT = "rns-smollm-135m-resident"
STAGED = "rns-smollm-135m-pallas"
# Tolerance of each smoke model's logits, card vs CPU: the bound the CPU
# tests hold the port to against the JAX reference (tests/test_torch_model,
# tests/test_torch_chain, tests/test_torch_staged).
LOGIT_ATOL = {ARCH: 0.03, STAGED: 0.03, RESIDENT: 0.15}


def peaks():
    """The H100 data sheet's rates (`repro_torch.launch.roofline`): HBM_BW,
    PEAK_INT8_OPS, PEAK_FLOPS (bf16), F32_FLOPS."""
    from repro_torch.launch import roofline

    return roofline


def bound_ms(nbytes, ops, rate=None):
    """The least time in ms for ``nbytes`` at the HBM rate or ``ops`` at
    ``rate`` (default the int8 peak), the larger, and which bounds it."""
    rate = peaks().PEAK_INT8_OPS if rate is None else rate
    t_bytes, t_ops = nbytes / peaks().HBM_BW, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps=30, warmup=3):
    """Median time of one ``fn(i)`` call as issued from Python (CUDA events
    around each call): the device time, or the host's, whichever is the
    longer — small launches are host-bound."""
    import torch

    for i in range(warmup):
        fn(i)
    pairs = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(warmup + i)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def _capture(fn, n):
    """``n`` calls ``fn(i)`` (i = 0..n-1) captured in a CUDA graph, after
    a warm-up, and replayed once."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(n, 3)):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph, n):
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n, reps=7):
    """Device time of one ``fn(i)``: ``n`` calls (i = 0..n-1) captured in a
    CUDA graph, the graph replayed ``reps`` times, median replay / n.  The
    host's launch overhead is out of the measurement."""
    graph = _capture(fn, n)
    times = [_replay_ms(graph, n) for _ in range(reps)]
    return sorted(times)[reps // 2]


def _pinned(fn, rows):
    """``fn()`` with every tile launch pinned to the ``rows``-row tile."""
    from repro_torch.kernels.rns_fused import _pin_tile_rows

    with _pin_tile_rows(rows):
        return fn()


def _heights(wg=False):
    """The tile heights a launch is held and timed at: the 32-row
    ``mma.sync`` tile and the 16-row ``__dp4a`` one, and first the 64-row
    wgmma + TMA tile for a raw int8 (``wg``) launch."""
    from repro_torch.kernels.rns_fused import TM, TM_MMA, TM_WG

    return ((TM_WG,) if wg else ()) + (TM_MMA, TM)


def device_ms_heights(fn, n, reps=8, wg=False):
    """`device_ms` of a tile-kernel launch pinned to each tile height
    (`_heights`): the graphs are replayed in turns (A B B A ..., A B C C B
    A ... for three); medians by height."""
    heights = _heights(wg)
    graphs = [_pinned(lambda: _capture(fn, n), h) for h in heights]
    return dict(zip(heights, _in_turns(graphs, n, reps)))


def _in_turns(graphs, n, reps):
    """Captured graphs of ``n`` calls replayed in turns (A B B A ... for
    two, A B C C B A ... for three): the median time of one call in
    each."""
    times = tuple([] for _ in graphs)
    order = list(range(len(graphs)))
    for r in range(reps):
        for h in (order if r % 2 == 0 else order[::-1]):
            times[h].append(_replay_ms(graphs[h], n))
    return [sorted(t)[reps // 2] for t in times]


def device_ms_routes(fn, n, routes, reps=8):
    """`device_ms` of a flash_attention call pinned to each of ``routes``:
    the graphs replayed in turns (A B B A ...); medians by route."""
    from repro_torch.kernels.flash_attention import _pin_route

    graphs = []
    for route in routes:
        with _pin_route(route):
            graphs.append(_capture(fn, n))
    return dict(zip(routes, _in_turns(graphs, n, reps)))


def _both_heights(again, want, wg=False):
    """``again()`` at each tile height (`_heights`), bit for bit against
    ``want``."""
    import torch

    return {h: torch.equal(_pinned(again, h), want) for h in _heights(wg)}


def _launched_rows(fn):
    """The tile height the launcher takes for ``fn()`` (one launch), read
    off the launch counters: the tuner's choice."""
    from repro_torch.kernels.rns_fused import tile_launches

    before = dict(tile_launches)
    fn()
    return next(h for h in tile_launches if tile_launches[h] != before[h])


def _height_info(eq, hts, picked):
    """Row fields and the printed part of every height's verdict."""
    if eq is None:
        return {}, ""
    info, text = {"rows": picked}, f"[rows={picked}] "
    for h in eq:
        info[f"equal_tm{h}"], info[f"ms_tm{h}"] = eq[h], hts[h]
        text += f"tm{h}: equal={eq[h]} ms={hts[h]:.4f} "
    return info, text


def _clusters(layer_shapes, decode_m, prefill_m):
    """The K splits (cluster sizes) the static rule picks for one layer's
    16-row launches at decode and at prefill, by (K, N)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rns_fused import TM, _split_k, tile_rows

    sms = _build.num_sms(0)
    out = {}
    for m in (decode_m, prefill_m):
        for _, k, n, _ in layer_shapes:
            if tile_rows(m, n, 5, sms) == TM:
                out[f"M={m} K={k} N={n}"] = _split_k(m, k, n, sms, TM)[0]
    return out


def phase_device(layer_shapes, decode_m, prefill_m):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rns_fused import (A_BF16, A_F32, A_PLANES,
                                               A_SHARED)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    # ptxas -v per kernel: its entry, then spills, then registers; each
    # source's compile seconds on its "==" line
    kernels, spills, files = [], [], {}
    for ln in log.splitlines():
        if ln.startswith("== ") and ln.endswith(" s)"):
            name, secs = ln[3:].rsplit(" (", 1)
            files[name] = float(secs[:-3])
        elif "Compiling entry function" in ln:
            kernels.append({"kernel": ln.split("'")[1]})
        elif "spill stores" in ln and kernels:
            kernels[-1]["spill"] = ln.strip()
            if " 0 bytes spill" not in ln:
                spills.append(f"{kernels[-1]['kernel']}: {ln.strip()}")
        elif "registers" in ln and kernels:
            kernels[-1]["ptxas"] = ln.split(":", 1)[1].strip()
    mma = [k for k in kernels if "rns_tile_kernelILi32E" in k["kernel"]]
    mma_regs = [int(k["ptxas"].split()[1]) for k in mma if "ptxas" in k]
    t16 = [k for k in kernels if "rns_tile_kernelILi16E" in k["kernel"]]
    t16_regs = [int(k["ptxas"].split()[1]) for k in t16 if "ptxas" in k]
    # dynamic shared memory of every compiled 16-row instance
    lib = _build.library()
    smem = [lib.rns_tile16_smem(am, c, enc)
            for am in (A_F32, A_BF16, A_SHARED, A_PLANES)
            for c in range(1, _build.MAXC) for enc in (0, 1)]
    smem = [b for b in smem if b > 0]
    clusters = _clusters(layer_shapes, decode_m, prefill_m)
    flash = _flash_instances(kernels)
    print(f"device: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"build: {build_s:.1f} s -> {os.path.relpath(so, ROOT)} "
          f"({len(kernels)} kernels, {len(mma)} of them 32-row tiles with "
          f"{min(mma_regs, default=0)}-{max(mma_regs, default=0)} "
          f"registers, {len(t16)} 16-row tiles with "
          f"{min(t16_regs, default=0)}-{max(t16_regs, default=0)} "
          f"registers and {min(smem) / 1024:.1f}-{max(smem) / 1024:.1f} KB "
          f"dynamic shared memory; spills: {spills or 'none'}) | "
          f"16-row clusters (K splits) of one layer, static rule: "
          f"{clusters}")
    print("build: compile seconds by source (all at once, beside the dry "
          "run): " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
              files.items(), key=lambda kv: -kv[1])))
    print("build: flash_attention routes (instance: registers/spill "
          "bytes): " + "; ".join(
              f"{route} {len(ins)} instances "
              + ", ".join(f"{k}: {r}/{sp}" for k, r, sp in ins)
              for route, ins in flash.items()))
    return {"name": name, "smi": smi, "build_s": build_s,
            "compile_s": files,
            "ptxas": kernels, "spills": spills, "flash_instances": flash,
            "tile16_smem_bytes": [min(smem), max(smem)],
            "clusters": clusters}


def _flash_instances(kernels):
    """The flash_attention instances of the build by route: (template
    arguments, registers, spill-store bytes) from ptxas -v."""
    import re

    names = {"split": "flash_split_kernel", "mma": "flash_mma_kernel",
             "fma": "flash_fma_kernel", "wide": "flash_wide_kernel"}
    out = {}
    for route, fn in names.items():
        out[route] = []
        for k in kernels:
            if fn not in k["kernel"]:
                continue
            tmpl = k["kernel"].split(fn, 1)[1]
            args = re.findall(r"Li(\d+)E", tmpl) + (
                ["bf16"] if "bfloat16" in tmpl else
                ["f32"] if route != "mma" else [])
            regs = int(k["ptxas"].split()[1]) if "ptxas" in k else -1
            spill = re.search(r"(\d+) bytes spill stores",
                              k.get("spill", ""))
            label = "/".join(args)
            out[route].append((("D" if args[0].isdigit() else "") + label,
                               regs,
                               int(spill.group(1)) if spill else -1))
    return out


def _copies(make, nbytes):
    """Enough distinct operands that cycling them reads device memory."""
    return [make() for _ in range(max(1, min(256,
                                             math.ceil(COLD_L2_BYTES
                                                       / nbytes))))]


def phase_kernels(layer_shapes, decode_m, prefill_m, dev):
    import torch
    from repro_torch.core.quant import quant_scale, quantize_int8
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.core.rns_tensor import encode
    from repro_torch.kernels import ref, rns_forward, rns_fused_matmul

    g = torch.Generator(device=dev).manual_seed(0)
    rows, ok, max_err = [], True, 0.0

    # rns_fused_matmul: every serving shape, encoded and live, plus ragged
    shapes = sorted({(k, n) for _, k, n, _ in layer_shapes})
    cases = [(m, k, n, enc) for k, n in shapes
             for m in (1, decode_m, 64, prefill_m) for enc in (True, False)]
    cases += [(13, 200, 70, True), (13, 200, 70, False)]
    for m, k, n, enc in cases:
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        x[0, :2] = torch.tensor([40.0, -40.0])
        w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
        sx = quant_scale(x)
        basis = basis_for_int8_matmul(k)
        C = len(basis.moduli)
        if enc:
            wt = encode(w)
            arg, scol = wt.residues, wt.scale
        else:
            arg, scol = quantize_int8(w, dim=0)
        got = rns_fused_matmul(x, arg, basis, scale_row=sx, scale_col=scol)
        want = ref.rns_fused_matmul_ref(x, arg, basis, scale_row=sx,
                                        scale_col=scol)
        # past 16 rows: both tile heights, each held against the plain
        # version
        eq = None if m <= 16 else _both_heights(
            lambda: rns_fused_matmul(x, arg, basis, scale_row=sx,
                                     scale_col=scol), want)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same = torch.equal(got, want)
        ok &= same and (eq is None or all(eq.values()))
        max_err = max(max_err, err)
        wbytes = arg.numel()
        pool = _copies(lambda: torch.randint(0, 37, tuple(arg.shape),
                                             dtype=torch.int8, device=dev),
                       wbytes)
        def launch(i):
            rns_fused_matmul(x, pool[i], basis, scale_row=sx, scale_col=scol)
        hts = device_ms_heights(launch, len(pool)) if eq else None
        picked = _launched_rows(lambda: launch(0)) if eq else None
        ms = device_ms(launch, len(pool))
        hinfo, htext = _height_info(eq, hts, picked)
        call = time_ms(lambda i: launch(i % len(pool)))
        plain = time_ms(lambda i: ref.rns_fused_matmul_ref(
            x, arg, basis, scale_row=sx, scale_col=scol), reps=5, warmup=1)
        wlib = _copies(lambda: torch.randn(k, n, generator=g, device=dev)
                       .to(torch.bfloat16), 2 * k * n)
        lib = device_ms(lambda i: torch.matmul(x, wlib[i]), len(wlib))
        nbytes = 2 * m * k + 4 * m + wbytes + 4 * n + 4 * m * n
        b, by = bound_ms(nbytes, 2 * C * m * k * n)
        rows.append({"kernel": "rns_fused_matmul", "M": m, "K": k, "N": n,
                     "weights": "encoded" if enc else "live", "C": C,
                     "equal": same, "max_abs_err": err, "ms": ms,
                     "call_ms": call, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b, "bound_by": by, **hinfo})
        print(f"  rns_fused_matmul M={m:4d} K={k:4d} N={n:4d} "
              f"{rows[-1]['weights']:7s} equal={same} ms={ms:.4f} {htext}"
              f"call={call:.4f} plain={plain:.3f} bf16_matmul={lib:.4f} "
              f"bound={b:.4f}")

    # rns_forward: the encode of each stacked linear weight (int8 → C planes)
    fwd_ok = True
    for name, k, n, stack in layer_shapes:
        mods = basis_for_int8_matmul(k).moduli
        q = torch.randint(-128, 128, (stack, k, n), dtype=torch.int8,
                          device=dev)
        q.view(-1)[:4] = torch.tensor([-128, -127, 0, 127], dtype=torch.int8)
        got = rns_forward(q, mods, dtype=torch.int8)
        want = ref.rns_forward_ref(q, mods, torch.int8)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        fwd_ok &= same
        del got, want
        # timed over copies of q whose reads and writes outgrow the L2
        nbytes = q.numel() * (1 + len(mods))
        pool = _copies(q.clone, nbytes)
        npool = len(pool)
        ms = device_ms(lambda i: rns_forward(pool[i], mods,
                                             dtype=torch.int8), npool)
        call = time_ms(lambda i: rns_forward(pool[i % npool], mods,
                                             dtype=torch.int8), reps=10)
        plain = time_ms(lambda i: ref.rns_forward_ref(q, mods, torch.int8),
                        reps=5, warmup=1)
        mcol = torch.tensor(mods, dtype=torch.int8,
                            device=dev).reshape(-1, 1, 1, 1)
        lib = device_ms(lambda i: torch.remainder(pool[i][None], mcol),
                        npool)
        b, by = bound_ms(nbytes, 0)
        del pool
        rows.append({"kernel": "rns_forward", "leaf": name,
                     "shape": [stack, k, n], "C": len(mods), "equal": same,
                     "max_abs_err": 0 if same else
                     (got.int() - want.int()).abs().max().item(),
                     "ms": ms, "call_ms": call, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b, "bound_by": by})
        print(f"  rns_forward {name:6s} {stack}x{k}x{n} equal={same} "
              f"ms={ms:.4f} call={call:.4f} plain={plain:.3f} "
              f"remainder={lib:.4f} bound={b:.4f}")
    return rows, ok, fwd_ok, max_err


def _sum(rows):
    out = {k: sum(r[k] for r in rows)
           for k in ("ms", "call_ms", "plain_ms", "bound_ms")}
    libs = [r["library_ms"] for r in rows]
    out["library_ms"] = None if None in libs else sum(libs)
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                       else "operations")
    return out


def _measure(rows, kernel, label, got, want, launch, plain, lib, pool_n,
             nbytes, ops, rate=None, tol=None, again=None, wg=False,
             **info):
    """Compare one launch with its plain version (bit for bit, or within
    ``tol`` = (rtol, atol), see `_within`) and time kernel, plain version
    and yardstick; appends the row and returns the verdict.  ``again``
    recomputes ``got`` for a tile-kernel launch past 16 rows: it is run
    pinned to each tile height (the 64-row one too for a raw int8 launch,
    ``wg``), each held bit for bit against ``want``, and the heights timed
    in turns; ``ms`` is the launch as the tuner resolves it (``info`` holds
    M, N and C)."""
    import torch

    eq = None if again is None else _both_heights(again, want, wg)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = 0.0 if same else (got.double() - want.double()).abs().max().item()
    ok = same if tol is None else _within(got, want, tol)
    ok &= eq is None or all(eq.values())
    hts = device_ms_heights(launch, pool_n, wg=wg) if eq else None
    picked = _launched_rows(lambda: launch(0)) if eq else None
    ms = device_ms(launch, pool_n)
    hinfo, htext = _height_info(eq, hts, picked)
    call = time_ms(lambda i: launch(i % pool_n))
    plain_ms = time_ms(lambda i: plain(), reps=5, warmup=1)
    lib_ms = device_ms(lib[0], lib[1]) if lib else None
    b, by = bound_ms(nbytes, ops, rate)
    rows.append(dict(kernel=kernel, label=label, equal=same, ok=ok,
                     max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b, bound_by=by, **hinfo,
                     **info))
    libs = "none" if lib_ms is None else f"{lib_ms:.4f}"
    verdict = f"equal={same}" if tol is None else \
        f"max_abs_err={err:.3g} within(rtol,atol)={tol}:{ok}"
    print(f"  {kernel} {label} {verdict} ms={ms:.4f} {htext}call={call:.4f} "
          f"plain={plain_ms:.3f} library={libs} bound={b:.4f}")
    return ok


def _sdpa_backend(call) -> str:
    """The backend `scaled_dot_product_attention` picked for ``call``, by
    the names of the kernels one profiled call ran: flash, efficient
    (cutlass fmha), cudnn, or math (plain matmuls and softmax)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = " ".join(e.key.lower() for e in prof.key_averages())
    except RuntimeError as e:             # the name only; the row stands
        return f"not measured (profiler: {e})"
    for key, name in (("flash", "flash"), ("fmha", "efficient"),
                      ("efficient", "efficient"), ("cudnn", "cudnn")):
        if key in names:
            return name
    return "math" if names else "unknown (no kernels profiled)"


def _within(got, want, tol):
    """|got - want| <= rtol*|want| + atol at every element."""
    rtol, atol = tol
    want = want.double()
    return bool(((got.double() - want).abs()
                 <= rtol * want.abs() + atol).all())


def _bf16_matmul(x_shape, k, n, g, dev):
    """The yardstick of an (M, K) × (K, N) integer product: one bf16
    torch.matmul of the same shape, weights read cold."""
    import torch

    x = torch.randn(x_shape, generator=g, device=dev).to(torch.bfloat16)
    wl = _copies(lambda: torch.randn(k, n, generator=g, device=dev)
                 .to(torch.bfloat16), 2 * k * n)
    return (lambda i: torch.matmul(x, wl[i]), len(wl))


def phase_kernels_slice2(staged_shapes, chain, decode_m, prefill_m, dev):
    """The kernels of the resident and staged paths at their launch shapes:
    the residue-in fused forms, rns_matmul (broadcast and canonical),
    rns_reverse, rns_modmul, and rns_forward at its per-step shapes."""
    import torch
    from repro_torch.core.conversion_plan import ConversionPlan
    from repro_torch.core.quant import requant_const
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
    from repro_torch.core.rns_tensor import (RNSTensor, encode,
                                             encode_activation)
    from repro_torch.kernels import (ref, rns_forward, rns_fused_matmul,
                                     rns_matmul, rns_modmul, rns_reverse)

    g = torch.Generator(device=dev).manual_seed(1)
    rows, ok = [], True
    d, F, qkv_n = chain
    ms_odd = (13, 200, 70)

    def act(m, k, basis):
        x = torch.randn(m, k, generator=g, device=dev)
        x[0, :2] = torch.tensor([40.0, -40.0])
        return encode_activation(x, basis)

    # residue-in fused launches: (label, basis, M, K, N, form)
    res_cases = []
    for m in (decode_m, prefill_m):
        res_cases += [("qkv", basis_for_int8_matmul(d), m, d, qkv_n, "float"),
                      ("gate", basis_for_chain(F), m, d, F, "float"),
                      ("up", basis_for_chain(F), m, d, F, "residues"),
                      ("down", basis_for_chain(F), m, F, d, "gated")]
    res_cases += [("odd-" + f, basis_for_chain(ms_odd[1]), *ms_odd, f)
                  for f in ("float", "residues", "gated")]
    for label, basis, m, k, n, form in res_cases:
        xa = act(m, k, basis)
        wt = encode(torch.randn(k, n, generator=g, device=dev) / k ** 0.5,
                    basis)
        gate = None
        if form == "gated":
            gate = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                                 dtype=torch.int8)
        emit = "residues" if form == "residues" else "float"
        C = len(basis.moduli)
        pool = _copies(lambda: torch.randint(0, 31, (C, k, n),
                                             dtype=torch.int8, device=dev),
                       C * k * n)

        def launch(i, xa=xa, wt=wt, gate=gate, emit=emit, pool=pool):
            w = RNSTensor(pool[i], wt.scale, wt.basis)
            return rns_fused_matmul(xa, w, scale_row=xa.scale,
                                    scale_col=wt.scale, gate=gate, emit=emit)

        def compute(xa=xa, wt=wt, gate=gate, emit=emit):
            got = rns_fused_matmul(xa, wt, scale_row=xa.scale,
                                   scale_col=wt.scale, gate=gate, emit=emit)
            return got.residues if emit == "residues" else got

        got = compute()
        creq = requant_const(wt.scale, k) if emit == "residues" else None
        want = ref.rns_fused_matmul_ref(xa.residues, wt.residues, basis,
                                        scale_row=xa.scale,
                                        scale_col=wt.scale, gate=gate,
                                        creq=creq)
        out_bytes = C * m * n if emit == "residues" else 4 * m * n
        nbytes = (C * m * k + C * k * n + (m * k if gate is not None else 0)
                  + 4 * m + 4 * n + out_bytes)
        ok &= _measure(
            rows, "rns_fused_matmul:residue_in", f"{label} M={m} K={k} N={n}",
            got, want, launch,
            lambda xa=xa, wt=wt, gate=gate, creq=creq, basis=basis:
            ref.rns_fused_matmul_ref(xa.residues, wt.residues, basis,
                                     scale_row=xa.scale, scale_col=wt.scale,
                                     gate=gate, creq=creq),
            _bf16_matmul((m, k), k, n, g, dev), len(pool), nbytes,
            2 * C * m * k * n, again=compute if m > 16 else None,
            leaf=label, M=m, K=k, N=n, C=C, form=form)

    # rns_matmul: broadcast (staged linears) and canonical (staged chain)
    mm_cases = []
    for m in (decode_m, prefill_m):
        mm_cases += [(name, basis_for_int8_matmul(k), m, k, n, True)
                     for name, k, n in staged_shapes]
        mm_cases += [("chain-gate/up", basis_for_chain(F), m, d, F, False),
                     ("chain-down", basis_for_chain(F), m, F, d, False)]
    mm_cases += [("odd-broadcast", basis_for_int8_matmul(ms_odd[1]),
                  *ms_odd, True),
                 ("odd-canonical", basis_for_chain(ms_odd[1]), *ms_odd,
                  False)]
    for label, basis, m, k, n, signed in mm_cases:
        mods = basis.moduli
        C = len(mods)
        if signed:
            a = torch.randint(-128, 128, (1, m, k), generator=g, device=dev,
                              dtype=torch.int8)
        else:
            a = act(m, k, basis).residues
        w_res = rns_forward(torch.randint(-127, 128, (k, n), generator=g,
                                          device=dev, dtype=torch.int8),
                            mods, dtype=torch.int8)
        pool = _copies(lambda: torch.randint(0, 31, (C, k, n),
                                             dtype=torch.int8, device=dev),
                       C * k * n)
        ok &= _measure(
            rows, "rns_matmul", f"{label} M={m} K={k} N={n}",
            rns_matmul(a, w_res, mods, signed_a=signed),
            ref.rns_matmul_ref(a, w_res, mods, signed_a=signed),
            lambda i, a=a, pool=pool, mods=mods, signed=signed:
            rns_matmul(a, pool[i], mods, signed_a=signed),
            lambda a=a, w=w_res, mods=mods, signed=signed:
            ref.rns_matmul_ref(a, w, mods, signed_a=signed),
            _bf16_matmul((m, k), k, n, g, dev), len(pool),
            a.numel() + C * k * n + 4 * C * m * n, 2 * C * m * k * n,
            again=(lambda a=a, w=w_res, mods=mods, signed=signed:
                   rns_matmul(a, w, mods, signed_a=signed)) if m > 16
            else None, wg=signed, leaf=label, M=m, K=k, N=n, C=C,
            form="broadcast" if signed else "canonical")

    # rns_reverse: the (C, M·N) residues of every staged linear's output
    rv_cases = []
    for m in (decode_m, prefill_m):
        rv_cases += [(name, basis_for_int8_matmul(k), m, n, False)
                     for name, k, n in staged_shapes]
        rv_cases += [("chain-gate/up", basis_for_chain(F), m, F, False),
                     ("chain-down", basis_for_chain(F), m, d, False)]
    rv_cases += [("odd-scaled", basis_for_chain(ms_odd[1]), ms_odd[0],
                  ms_odd[2], True)]
    for label, basis, m, n, scaled in rv_cases:
        conv = ConversionPlan.for_basis(basis)
        half = basis.M // 2
        v = torch.randint(-half, half, (m, n), generator=g, device=dev)
        r = torch.stack([torch.remainder(v, mm) for mm in basis.moduli]) \
            .to(torch.int32)
        sc = torch.rand((m, 1), generator=g, device=dev) if scaled else None
        C = len(basis.moduli)
        nbytes = 4 * C * m * n + 4 * m * n + (4 * m if scaled else 0)
        # timed over copies of the residues that outgrow the L2
        pool = _copies(r.clone, nbytes)
        ok &= _measure(
            rows, "rns_reverse", f"{label} M={m} N={n}",
            rns_reverse(r, conv, scale=sc), ref.rns_reverse_ref(r, conv, sc),
            lambda i, pool=pool, conv=conv, sc=sc: rns_reverse(
                pool[i], conv, scale=sc),
            lambda r=r, conv=conv, sc=sc: ref.rns_reverse_ref(r, conv, sc),
            None, len(pool), nbytes, 0, leaf=label, M=m, N=n, C=C)
        del pool

    # rns_modmul: the staged chain's gate multiply, (C, M·F) int8 into the
    # chain's int8 residues (as the chain launches it) and into int32 (the
    # reference's contract), timed over operand pairs that outgrow the L2
    for m, n in ((decode_m, F), (prefill_m, F), (ms_odd[0], ms_odd[1])):
        basis = basis_for_chain(F if n == F else n)
        mods = basis.moduli
        C = len(mods)
        mcol = torch.tensor(mods, dtype=torch.int32,
                            device=dev).reshape(-1, 1, 1)
        for otype in (torch.int8, torch.int32):
            osize = torch.empty((), dtype=otype).element_size()
            nbytes = (2 + osize) * C * m * n
            pool = _copies(lambda m=m, n=n, basis=basis: (
                act(m, n, basis).residues, act(m, n, basis).residues),
                nbytes)
            a, b = pool[0]
            lib = [(x.int(), y.int()) for x, y in pool]
            ok &= _measure(
                rows, "rns_modmul", f"M={m} F={n} out={str(otype)[6:]} "
                f"C={C}",
                rns_modmul(a, b, mods, out_dtype=otype),
                ref.rns_modmul_ref(a, b, mods, out_dtype=otype),
                lambda i, pool=pool, mods=mods, otype=otype: rns_modmul(
                    *pool[i], mods, out_dtype=otype),
                lambda a=a, b=b, mods=mods, otype=otype:
                ref.rns_modmul_ref(a, b, mods, out_dtype=otype),
                (lambda i, lib=lib, mcol=mcol: torch.remainder(
                    lib[i][0] * lib[i][1], mcol), len(lib)),
                len(pool), nbytes, 0, M=m, N=n, C=C, out=str(otype)[6:])
            del pool, lib

    # rns_forward at its per-step shapes: activation encodes, the staged
    # path's weight conversion, the staged chain's gate and requantized up
    fw_cases = []
    for m in (decode_m, prefill_m):
        fw_cases += [("act-qkv", basis_for_int8_matmul(d), (m, d),
                      torch.int8),
                     ("act-mlp", basis_for_chain(F), (m, d), torch.int8),
                     ("gate", basis_for_chain(F), (m, F), torch.int8),
                     ("requant-up", basis_for_chain(F), (m, F),
                      torch.int32)]
    fw_cases += [(f"weight-{name}", basis_for_int8_matmul(k), (k, n),
                  torch.int8) for name, k, n in staged_shapes]
    for label, basis, shape, dtype in fw_cases:
        mods = basis.moduli
        q = torch.randint(-127, 128, shape, generator=g, device=dev).to(dtype)
        mcol = torch.tensor(mods, dtype=dtype, device=dev).reshape(-1, 1, 1)
        nbytes = q.numel() * (q.element_size() + len(mods))
        # timed over copies of q whose reads and writes outgrow the L2
        pool = _copies(q.clone, nbytes)
        ok &= _measure(
            rows, "rns_forward", f"{label} {shape[0]}x{shape[1]}",
            rns_forward(q, mods, dtype=torch.int8),
            ref.rns_forward_ref(q, mods, torch.int8),
            lambda i, pool=pool, mods=mods: rns_forward(pool[i], mods,
                                                        dtype=torch.int8),
            lambda q=q, mods=mods: ref.rns_forward_ref(q, mods, torch.int8),
            (lambda i, pool=pool, mcol=mcol: torch.remainder(pool[i][None],
                                                             mcol),
             len(pool)),
            len(pool), nbytes, 0, leaf=label, shape=list(shape),
            C=len(mods), M=shape[0] if label[0] != "w" else None)
        del pool
    return rows, ok


def phase_edges(dev):
    """rns_forward and rns_reverse against their plain versions, bit for
    bit, on the edge cases of `tests/test_torch_cuda.py` (built by
    `tests/_convert_cases.py`): every length 0-33, lengths at the vector
    body and input views that start off a 16-byte boundary, C = 1-12
    moduli (int8 and int32 residues), moduli 2, 64, 2^15 + 3 and 2^31 - 1
    (int32 residues), INT32_MIN and INT32_MAX, and every (C, L) instance
    of the reverse without a scale and with one of four broadcast
    scales."""
    import torch
    from repro_torch.core.conversion_plan import ConversionPlan
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.kernels import ref, rns_forward, rns_reverse
    from repro_torch.kernels.rns_convert import REVERSE_INSTANCES

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _convert_cases as cc

    g = torch.Generator(device=dev).manual_seed(7)
    counts = {"rns_forward": 0, "rns_reverse": 0}
    fails = []

    def values(n, dtype, offset=0):
        return cc.forward_values(n, dtype, sum(counts.values()), offset,
                                 dev)

    def fwd(name, x, mods, dtype):
        counts["rns_forward"] += 1
        got = rns_forward(x, mods, dtype=dtype)
        if not torch.equal(got, ref.rns_forward_ref(x, mods, dtype)):
            fails.append(f"rns_forward {name} {tuple(x.shape)} {x.dtype}->"
                         f"{dtype} {mods}")

    def rev(name, r, conv, sc):
        counts["rns_reverse"] += 1
        got = rns_reverse(r, conv, scale=sc)
        if not torch.equal(got, ref.rns_reverse_ref(r, conv, sc)):
            fails.append(f"rns_reverse {name} C={conv.k} L={conv.nlimbs} "
                         f"{tuple(r.shape)} scale="
                         f"{None if sc is None else tuple(sc.shape)}")

    def scales(shape):
        """Four scales that broadcast against ``shape`` (M, N): full,
        per row, per column, one value."""
        M, N = shape
        return [torch.rand(s, generator=g, device=dev)
                for s in ((M, N), (M, 1), (N,), ())]

    # the least lengths the kernels take in 16- and 4-element vectors
    # (rns_convert.vectors); shorter ones run one element a thread
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fbig, rbig = 32 * 16 * sms, 32 * 4 * sms
    served = basis_for_int8_matmul(576).moduli
    types = [(i, o) for i in (torch.int8, torch.int32)
             for o in (torch.int8, torch.int32)]
    for it, ot in types:
        for S in range(34):
            fwd("ragged", values(S, it), served, ot)
        for S in (fbig, fbig + 1, fbig + 4, 8 * 576):
            for off in (0, 1, 3):
                fwd("misaligned", values(S, it, off), served, ot)
        for C in range(1, 13):
            for S in (8 * 576, fbig + 16):
                fwd(f"C={C}", values(S, it), cc.SMALL_MODULI[:C], ot)
    for it in (torch.int8, torch.int32):
        for S in (33, 4096, fbig):
            fwd("large moduli", values(S, it), cc.LARGE_MODULI, torch.int32)
            fwd("large moduli", values(S, it, 1), cc.LARGE_MODULI[::-1],
                torch.int32)
    for i, (C, L) in enumerate(sorted(REVERSE_INSTANCES)):
        basis = cc.basis_with_limbs(C, L)
        conv = ConversionPlan.for_basis(basis)
        for shape in ((8, 192), (13, 70), (-(-rbig // 192), 192)):
            r = cc.edge_residues(basis, shape, i, dev)
            rev("instance", r, conv, None)
            rev("instance", r, conv, scales(shape)[i % 4])
    basis = basis_for_int8_matmul(576)
    conv = ConversionPlan.for_basis(basis)
    for S in range(34):
        r = cc.edge_residues(basis, (1, S), S, dev)
        rev("ragged", r, conv, None)
        rev("ragged", r, conv, scales((1, S))[S % 4])
    for S in (rbig, rbig + 1, rbig + 2, rbig + 3, 1536 + 2):
        r = cc.edge_residues(basis, (S,), S, dev)
        big = torch.empty(5 * S + 3, dtype=torch.int32, device=dev)
        for off in (1, 2):
            view = big[off:off + 5 * S].view(5, S)
            view.copy_(r)
            rev("misaligned", view, conv, None)
            sc = torch.rand(S + 1, generator=g, device=dev)[1:]
            rev("misaligned", view, conv, sc)
    if fails:
        raise AssertionError(f"{len(fails)} edge cases differ from the "
                             f"plain versions, first: {fails[:5]}")
    return counts


def _flash_inputs(case, dtype, g, dev):
    """q, k, v and the mask keywords of one flash case at B = 8 lanes."""
    import torch

    B, H, Sq, Sk, D, causal, window, softcap, masking = case
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
               for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, window=window, softcap=softcap)
    if masking == "pad":
        # ragged lanes left-padded to the bucket, one lane all padding
        kw["pad"] = torch.tensor([0, 1, 17, Sk // 4, Sk // 2, Sk - 1, Sk, 5],
                                 dtype=torch.int32, device=dev)[:B]
    elif masking == "pos":
        # paged gather: shuffled key positions, dead key slots and rows
        kp = torch.stack([torch.randperm(Sk, generator=g, device=dev)
                          for _ in range(B)]).int()
        kp[1, : Sk // 3] = -1
        kp[2] = -1
        qp = (torch.arange(Sq, device=dev, dtype=torch.int32)
              + (Sk - Sq)).repeat(B, 1)
        qp[3, ::3] = -1
        kw.update(qpos=qp.contiguous(), kpos=kp.contiguous())
    return q, k, v, kw


# (label, B, H, Sq, Sk, D, causal, window, softcap, masking) at smollm-135m's
# attention widths: 9 query heads (3 KV heads repeated), head_dim 64
FLASH_CASES = [
    ("prefill-pad", 8, 9, 2048, 2048, 64, True, None, None, "pad"),
    ("prefill-window-softcap", 8, 9, 2048, 2048, 64, True, 512, 50.0, "pad"),
    ("decode-128", 8, 9, 1, 128, 64, True, None, None, "pad"),
    ("decode-2048", 8, 9, 1, 2048, 64, True, None, None, "pad"),
    ("noncausal-2000", 8, 9, 2000, 2000, 64, False, None, None, None),
    ("positions", 8, 9, 64, 2048, 64, True, None, None, "pos"),
]
# the zoo's other head sizes, at their models' heads and masks: gemma2-2b
# (256, 8 heads, window 4096, softcap 50 on the prefill), h2o-danube-1.8b
# (80, 32 heads, window 4096), phi-3-vision-4.2b (96, 32 heads) and the
# yi-34b smoke twin (8, 8 heads: padded to the compiled 16)
FLASH_HEADS = [
    ("prefill-pad D256", 8, 8, 2048, 2048, 256, True, 4096, 50.0, "pad"),
    ("decode-2048 D256", 8, 8, 1, 2048, 256, True, 4096, None, "pad"),
    ("prefill-pad D80", 8, 32, 2048, 2048, 80, True, 4096, None, "pad"),
    ("decode-2048 D80", 8, 32, 1, 2048, 80, True, 4096, None, "pad"),
    ("prefill-pad D96", 8, 32, 2048, 2048, 96, True, None, None, "pad"),
    ("decode-2048 D96", 8, 32, 1, 2048, 96, True, None, None, "pad"),
    ("prefill-pad D8", 8, 8, 2048, 2048, 8, True, None, None, "pad"),
    ("decode-2048 D8", 8, 8, 1, 2048, 8, True, None, None, "pad"),
    # above 256: the wide route (no config has such a head; the
    # reference's kernel takes any D)
    ("prefill-pad D512", 8, 8, 2048, 2048, 512, True, None, None, "pad"),
    ("decode-2048 D512", 8, 8, 1, 2048, 512, True, None, None, "pad"),
]
FLASH_CASES += FLASH_HEADS


def phase_entries(layer_shapes, chain, lanes, dev):
    """The slice-3 entry points driven once each, as a user calls them, at
    full width: flash_attention at prefill and decode, fold of a K = 1536
    accumulator, and one smollm layer's float-emit linears as channel
    slices (n = C) composed through crt_finish and checked bit for bit
    against rns_fused_matmul; the flash outputs are held against their
    plain version.  Counts are set to 0 just before and read just after;
    inputs are made before."""
    import torch
    from repro_torch.core.quant import quant_scale
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
    from repro_torch.core.rns_tensor import (RNSTensor, encode,
                                             encode_activation)
    from repro_torch.dist.rns_shard import channel_sliced_matmul
    from repro_torch.kernels import (flash_attention, fold, ref,
                                     rns_fused_matmul)
    from repro_torch.kernels.flash_attention import flash_route

    g = torch.Generator(device=dev).manual_seed(3)
    d, F, qkv_n = chain
    flash = [_flash_inputs(FLASH_CASES[i][1:], torch.bfloat16, g, dev)
             for i in (0, 3)]
    S = 512 * 1536
    fbound = 1536 * 46 * 46
    fmods = basis_for_int8_matmul(1536).moduli
    fx = torch.randint(0, fbound, (len(fmods), S), generator=g, device=dev,
                       dtype=torch.int32)
    layer = []
    for name, k, n, _ in layer_shapes:
        x = torch.randn(lanes, k, generator=g, device=dev).to(torch.bfloat16)
        layer.append((name, basis_for_int8_matmul(k), x, None,
                      encode(torch.randn(k, n, generator=g, device=dev)
                             / k ** 0.5)))
    for name, basis, k, n in (("qkv", basis_for_int8_matmul(d), d, qkv_n),
                              ("down", basis_for_chain(F), F, d)):
        xa = encode_activation(torch.randn(lanes, k, generator=g, device=dev),
                               basis)
        gate = (torch.randint(-127, 128, (lanes, k), generator=g, device=dev,
                              dtype=torch.int8) if name == "down" else None)
        layer.append((name, basis, xa, gate,
                      encode(torch.randn(k, n, generator=g, device=dev)
                             / k ** 0.5, basis)))
    torch.cuda.synchronize()

    reset_launches()
    outs = [flash_attention(q, k, v, **kw) for q, k, v, kw in flash]
    folded = fold(fx, fmods, fbound)
    composed = []
    for name, basis, x, gate, wt in layer:
        srow = x.scale if isinstance(x, RNSTensor) else quant_scale(x)
        composed.append((name, channel_sliced_matmul(
            x, wt, len(basis.moduli), scale_row=srow, scale_col=wt.scale,
            gate=gate)))
    torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(flash_attention.route_launches)
    # each call went through the route its shape names
    ok = routes == {r: sum(flash_route(q.shape[2], q.dtype, q.shape[3]) == r
                           for q, _, _, _ in flash)
                    for r in routes}

    ok &= all(o.shape == q.shape and torch.isfinite(o.float()).all()
             and _within(o, ref.attention_ref(q, k, v, **kw),
                         FLASH_TOL["bfloat16"])
             for o, (q, k, v, kw) in zip(outs, flash))
    ok &= torch.equal(folded.long(), fx.long() % torch.tensor(
        fmods, device=dev)[:, None])
    for (name, val), (_, basis, x, gate, wt) in zip(composed, layer):
        srow = x.scale if isinstance(x, RNSTensor) else quant_scale(x)
        ok &= torch.equal(val, rns_fused_matmul(
            x, wt, scale_row=srow, scale_col=wt.scale, gate=gate))
    return {"launches": {k: launches[k] for k in SLICE3},
            "flash_routes": routes, "ok": bool(ok)}


INT8_ROUTES = {"fused": {"backend": "auto"}, "staged": {"backend": "pallas"},
               "per_channel": {"broadcast": False}}


def _int8_counters():
    from repro_torch.kernels import (rns_forward, rns_fused_crt_partial,
                                     rns_fused_matmul, rns_matmul,
                                     rns_reverse)

    return (rns_fused_matmul, rns_forward, rns_matmul, rns_reverse,
            rns_fused_crt_partial)


def _int8_plain(route, x, w, wenc, basis, s):
    """The plain version of one `rns_int_matmul` call on the card: the
    fused kernel's, or the staged route's three kernels' composed."""
    import torch
    from repro_torch.core.channel_plan import ChannelPlan
    from repro_torch.core.conversion_plan import ConversionPlan
    from repro_torch.kernels import ref
    from repro_torch.kernels.rns_fused import lower_scale

    mods = basis.moduli
    w_res = wenc.residues if wenc is not None else \
        ref.rns_forward_ref(w, mods, torch.int8)
    if route == "fused":
        M, N = x.shape[0], w_res.shape[-1]
        srow, scol, sc = lower_scale(s, M, N, None, None, x.device)
        return ref.rns_fused_matmul_ref(x, w_res, basis, scale_row=srow,
                                        scale_col=scol, scale=sc)
    if route == "staged":
        res = ref.rns_matmul_ref(x[None], w_res, mods, signed_a=True)
    else:
        plan = ChannelPlan.for_matmul(mods, x.shape[-1])
        res = ref.rns_matmul_ref(ref.rns_forward_ref(x, mods, torch.int8),
                                 w_res, mods, plan=plan)
    return ref.rns_reverse_ref(res, ConversionPlan.for_basis(basis), s)


def phase_int8(layer_shapes, decode_m, prefill_m, dev, big_m=2048):
    """The exact-int8 entry, `core.rns_linear.rns_int_matmul`, at the
    reference's signature on its three routes (fused: one raw-int8
    `rns_fused_matmul`; staged: forward, broadcast `rns_matmul`, reverse;
    per-channel: both operands forward-converted, canonical `rns_matmul`,
    reverse), encoded and live weights, each scale form (none, (1, N),
    (M, 1), (M, N)), on the four smollm-135m layer shapes at M = 8 and
    512, driven once with the counts set to 0 just before and read just
    after; the raw-int8 `rns_fused_crt_partial` (encoded and live) as
    one-channel slices of the same launches composed through
    `crt_finish`.  Gates: every result bit-equal to the float64 product
    of the int8 operands (exact: |sum| <= 1536·128² < 2^53) times the
    scale, and to its plain version; each call's launches.  Then the new
    forms timed over operand copies that outgrow the L2: the raw-int8
    fused launch (encoded and live) beside `torch._int_mm` (M > 16) and
    bf16 `torch.matmul`, and the one-channel raw-int8 slices; past 16 rows
    each at every tile height in turns, the raw-int8 fused launch at
    ``big_m`` rows too."""
    import torch
    from repro_torch.core import rns_linear
    from repro_torch.core.channel_plan import ChannelPlan
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.core.rns_tensor import RNSTensor
    from repro_torch.dist.rns_shard import (channel_sliced_matmul,
                                            crt_tables, local_plan)
    from repro_torch.kernels import (ref, rns_fused_crt_partial,
                                     rns_fused_matmul, tune)
    from repro_torch.kernels.rns_fused import TM_WG, tile_launches

    g = torch.Generator(device=dev).manual_seed(26)
    shapes = sorted({(k, n) for _, k, n, _ in layer_shapes})
    ops = {}
    for M in (decode_m, prefill_m):
        for K, N in shapes:
            x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                              dtype=torch.int8)
            x[0, :] = -128                  # the worst accumulator K·128²
            w[:, 0] = -128

            def u(*shape):
                return torch.rand(shape, generator=g, device=dev) + 0.01
            scales = {"none": None, "1n": u(1, N), "m1": u(M, 1),
                      "mn": u(M, N)}
            ops[(M, K, N)] = (x, w, RNSTensor.from_int8(w), scales)
    torch.cuda.synchronize()
    sweeps = tune.stats["sweeps"]
    fns = _int8_counters()
    for f in fns:
        f.launches = 0
    fns[0].raw_launches = fns[4].raw_launches = 0
    tile_launches[TM_WG] = 0
    outs, calls = [], []
    for (M, K, N), (x, w, wenc, scales) in ops.items():
        basis = basis_for_int8_matmul(K)
        for route, kw in INT8_ROUTES.items():
            for wname, wq in (("encoded", wenc), ("live", w)):
                for sname, s in scales.items():
                    before = [f.launches for f in fns[:4]]
                    out = rns_linear.rns_int_matmul(x, wq, scale=s, **kw)
                    calls.append((route, wname,
                                  [f.launches - b for f, b in
                                   zip(fns[:4], before)]))
                    outs.append(((M, K, N), route, wname, sname, out))
        for wname, wq in (("encoded", wenc), ("live", w)):
            outs.append(((M, K, N), "crt", wname, "none",
                         channel_sliced_matmul(x, wq, len(basis.moduli),
                                               basis=basis)))
    torch.cuda.synchronize()
    launches = {"rns_fused_matmul": fns[0].launches,
                "raw_int8": fns[0].raw_launches,
                "rns_forward": fns[1].launches, "rns_matmul": fns[2].launches,
                "rns_reverse": fns[3].launches,
                "rns_fused_crt_partial": fns[4].launches,
                "crt_raw_int8": fns[4].raw_launches,
                "tile_wg": tile_launches[TM_WG]}
    want_calls = {("fused", "encoded"): [1, 0, 0, 0],
                  ("fused", "live"): [1, 0, 0, 0],
                  ("staged", "encoded"): [0, 0, 1, 1],
                  ("staged", "live"): [0, 1, 1, 1],
                  ("per_channel", "encoded"): [0, 1, 1, 1],
                  ("per_channel", "live"): [0, 2, 1, 1]}
    calls_ok = all(c == want_calls[(r, wn)] for r, wn, c in calls)
    exact_ok = plain_ok = True
    for (M, K, N), route, wname, sname, out in outs:
        x, w, wenc, scales = ops[(M, K, N)]
        s = scales[sname]
        exact = (x.double() @ w.double()).float()
        exact_ok &= torch.equal(out, exact if s is None else exact * s)
        if route != "crt":
            plain = _int8_plain(route, x, w, wenc if wname == "encoded"
                                else None, basis_for_int8_matmul(K), s)
            plain_ok &= torch.equal(out, plain)
    swept = tune.stats["sweeps"] - sweeps

    # timing: the raw-int8 fused launch and the one-channel raw slices
    rows, ok = [], True
    for (M, K, N), (x, w, wenc, _) in ops.items():
        basis = basis_for_int8_matmul(K)
        C = len(basis.moduli)
        pool = _copies(lambda: torch.randint(0, 37, (C, K, N), dtype=torch.int8,
                                             device=dev), C * K * N)
        live = _copies(lambda: torch.randint(-128, 128, (K, N),
                                             dtype=torch.int8, device=dev),
                       K * N)
        bf16 = _bf16_matmul((M, K), K, N, g, dev)
        bf16_ms = device_ms(*bf16)
        lib, extra = None, {}
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            # cuBLASLt's int8 GEMM wants a column-major mat2: (N, K) copies
            # read transposed; the row-major (K, N) one is timed beside it
            live_t = _copies(lambda: torch.randint(
                -128, 128, (N, K), dtype=torch.int8, device=dev), K * N)
            lib = (lambda i, x=x, live_t=live_t: torch._int_mm(
                x, live_t[i].t()), len(live_t))
            extra["int_mm_row_major_ms"] = device_ms(
                lambda i, x=x, live=live: torch._int_mm(x, live[i]),
                len(live))
        for wname, arg, wpool in (("encoded", wenc.residues, pool),
                                  ("live", w, live)):
            def launch(i, x=x, wpool=wpool, basis=basis):
                return rns_fused_matmul(x, wpool[i], basis)

            def plain(x=x, arg=arg, basis=basis):
                return ref.rns_fused_matmul_ref(x, arg, basis)

            # bound: the exact int8 product's 2·M·K·N operations (what
            # `torch._int_mm` does); the C channels' 2·C·M·K·N beside it
            nbytes = M * K + arg.numel() + 4 * M * N
            ok &= _measure(
                rows, "rns_fused_matmul:raw_int8",
                f"M={M} K={K} N={N} {wname}",
                rns_fused_matmul(x, arg, basis), plain(), launch, plain,
                lib, len(wpool), nbytes, 2 * M * K * N,
                again=(lambda x=x, arg=arg, basis=basis: rns_fused_matmul(
                    x, arg, basis)) if M > 16 else None, wg=True,
                M=M, K=K, N=N, C=C, weights=wname, bf16_ms=bf16_ms,
                bound_channels_ms=bound_ms(nbytes, 2 * C * M * K * N)[0],
                **extra)
        # the first one-channel raw-int8 slice (encoded, live) of the
        # launches composed above
        v, mc, L1 = crt_tables(basis)
        plan = ChannelPlan.for_matmul(basis.moduli, K, signed=True)
        tables = dict(plan=local_plan(plan, C), mods=plan.mods[:1],
                      sched=plan.sched[:1], crt_v=v[:1], crt_mc=mc[:1])
        for wname, arg, wpool in (("encoded", wenc.residues[:1], pool),
                                  ("live", w, live)):
            def run(i, x=x, wpool=wpool, wname=wname, tables=tables):
                wi = wpool[i][:1] if wname == "encoded" else wpool[i]
                return rns_fused_crt_partial(x, wi, **tables)

            def plain(x=x, arg=arg, tables=tables):
                return ref.rns_fused_crt_partial_ref(x, arg, **tables)

            def full(i, x=x, wpool=wpool, basis=basis):
                return rns_fused_matmul(x, wpool[i], basis)

            ok &= _measure(
                rows, "rns_fused_crt_partial:raw_int8",
                f"M={M} K={K} N={N} {wname} slice 1/{C}",
                rns_fused_crt_partial(x, arg, **tables), plain(), run,
                plain, (full, len(wpool)), len(wpool),
                M * K + K * N + 4 * L1 * M * N, 2 * M * K * N,
                again=(lambda x=x, arg=arg, tables=tables:
                       rns_fused_crt_partial(x, arg, **tables))
                if M > 16 else None, wg=True,
                M=M, K=K, N=N, C=C, weights=wname)
        del pool, live
    # the raw-int8 fused launch at a training batch's rows (M = 2048, the
    # train phase's B 8 x S 256): every height held against the plain
    # version and timed in turns, beside `torch._int_mm` and the bound
    M = big_m
    for K, N in shapes:
        basis = basis_for_int8_matmul(K)
        C = len(basis.moduli)
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        wenc = RNSTensor.from_int8(w)
        pool = _copies(lambda: torch.randint(0, 37, (C, K, N), dtype=torch.int8,
                                             device=dev), C * K * N)
        live = _copies(lambda: torch.randint(-128, 128, (K, N),
                                             dtype=torch.int8, device=dev),
                       K * N)
        live_t = _copies(lambda: torch.randint(-128, 128, (N, K),
                                               dtype=torch.int8, device=dev),
                         K * N)
        lib = (lambda i, x=x, live_t=live_t: torch._int_mm(x, live_t[i].t()),
               len(live_t))
        for wname, arg, wpool in (("encoded", wenc.residues, pool),
                                  ("live", w, live)):
            def launch(i, x=x, wpool=wpool, basis=basis):
                return rns_fused_matmul(x, wpool[i], basis)

            def plain(x=x, arg=arg, basis=basis):
                return ref.rns_fused_matmul_ref(x, arg, basis)

            nbytes = M * K + arg.numel() + 4 * M * N
            ok &= _measure(
                rows, "rns_fused_matmul:raw_int8",
                f"M={M} K={K} N={N} {wname}",
                rns_fused_matmul(x, arg, basis), plain(), launch, plain,
                lib, len(wpool), nbytes, 2 * M * K * N,
                again=lambda x=x, arg=arg, basis=basis: rns_fused_matmul(
                    x, arg, basis), wg=True,
                M=M, K=K, N=N, C=C, weights=wname,
                bf16_ms=0.0,
                bound_channels_ms=bound_ms(nbytes, 2 * C * M * K * N)[0])
        del pool, live, live_t
    return {"launches": launches, "calls": len(calls), "calls_ok": calls_ok,
            "exact_ok": bool(exact_ok), "plain_ok": bool(plain_ok),
            "sweeps": swept, "rows": rows, "ok": bool(ok and calls_ok
                                                     and exact_ok
                                                     and plain_ok)}


def int8_per_layer(rows, layer_shapes, M, kernel, weights):
    """One layer's 7 launches of ``kernel`` (``weights`` encoded or live)
    at M rows, summed (`_sum`), with the bf16 yardstick's sum."""
    picked = [next(r for r in rows if r["kernel"] == kernel
                   and r["M"] == M and (r["K"], r["N"]) == (k, n)
                   and r["weights"] == weights)
              for _, k, n, _ in layer_shapes]
    agg = _sum(picked)
    for key in ("bf16_ms", "bound_channels_ms", "int_mm_row_major_ms",
                "ms_tm64", "ms_tm32"):
        agg[key] = sum(r.get(key, 0.0) for r in picked)
    return agg


def print_int8(res, layer_shapes, decode_m, prefill_m, smi):
    """The `int8:` lines and the phase's gates."""
    print(f"int8: rns_int_matmul (fused, staged, per-channel routes; "
          f"encoded and live weights; scales none, (1, N), (M, 1), (M, N)) "
          f"on the 4 smollm-135m layer shapes at M={decode_m} and "
          f"{prefill_m}: {res['calls']} calls, bit-equal to the float64 "
          f"product times the scale {res['exact_ok']}, to the plain "
          f"versions {res['plain_ok']}, launches per call as the route "
          f"implies {res['calls_ok']} | raw-int8 rns_fused_crt_partial "
          f"(encoded and live) as one-channel slices composed == exact "
          f"{res['exact_ok']} | launches {res['launches']} | tuner sweeps "
          f"{res['sweeps']}")
    for kernel, what in (("rns_fused_matmul:raw_int8", "launches"),
                         ("rns_fused_crt_partial:raw_int8",
                          "one-channel slices")):
        big = sorted({r["M"] for r in res["rows"] if r["kernel"] == kernel}
                     - {decode_m, prefill_m})
        for M in (decode_m, prefill_m, *big):
            parts = []
            for weights in ("encoded", "live"):
                a = int8_per_layer(res["rows"], layer_shapes, M, kernel,
                                   weights)
                lib = ("n/a" if a["library_ms"] is None
                       else f"{1e3 * a['library_ms']:.1f} us")
                fused = kernel.startswith("rns_fused_matmul")
                if fused and a["int_mm_row_major_ms"]:
                    lib += (f" (row-major mat2 "
                            f"{1e3 * a['int_mm_row_major_ms']:.1f} us)")
                yard = (f"torch._int_mm {lib}" + (
                    f", bf16 torch.matmul {1e3 * a['bf16_ms']:.1f} us"
                    if a["bf16_ms"] else "")
                    if fused else f"the full-basis raw-int8 launch {lib}")
                chans = (f"; over the C channels "
                         f"{1e3 * a['bound_channels_ms']:.2f} us"
                         if fused else "")
                turns = ("" if M <= 16 else
                         f"; in turns: 64-row wgmma {1e3 * a['ms_tm64']:.1f}"
                         f" us, 32-row mma.sync {1e3 * a['ms_tm32']:.1f} us")
                parts.append(f"{weights} {1e3 * a['ms']:.1f} us as launched"
                             f"{turns} ({yard}, bound "
                             f"{1e3 * a['bound_ms']:.2f} us{chans})")
            print(f"int8: {kernel} one layer's 7 {what} at M={M}: "
                  + "; ".join(parts) + f" | on {smi}")
    if not res["ok"]:
        raise AssertionError("int8: a result, a plain version or a launch "
                             "count disagrees")


def phase_kernels_slice3(layer_shapes, chain, decode_m, prefill_m, dev):
    """flash_attention, fold and rns_fused_crt_partial at full width, each
    against its plain version and timed.  Every crt launch shape is also
    composed over its slices, for n = 1 and n = C, and held bit for bit
    against rns_fused_matmul on the full basis."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.quant import quant_scale
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
    from repro_torch.core.rns_tensor import (RNSTensor, encode,
                                             encode_activation)
    from repro_torch.dist.rns_shard import (channel_partials,
                                            channel_sliced_matmul, crt_tables)
    from repro_torch.kernels import (flash_attention, fold, ref,
                                     rns_fused_matmul)
    from repro_torch.kernels.flash_attention import _pin_route, flash_route

    g = torch.Generator(device=dev).manual_seed(4)
    rows, ok = [], True
    d, F, qkv_n = chain

    # flash_attention: every case in bf16 and float32, each on the route
    # it takes; bf16 prefill also pinned to the CUDA-core route (the
    # "before"), held to the same tolerance and timed in turns with it
    for label, *case in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, kw = _flash_inputs(case, dtype, g, dev)
            B, H, Sq, D = q.shape
            Sk = k.shape[2]
            mask = ref.attention_mask(B, Sq, Sk, device=dev, **{
                n: kw.get(n) for n in ("causal", "window", "pad", "qpos",
                                       "kpos")})
            got = flash_attention(q, k, v, **kw)
            dead = (~mask.any(-1))[:, None].expand(-1, H, -1)
            zeros = bool((got[dead] == 0).all())
            tname = str(dtype).split(".")[1]
            route = flash_route(Sq, dtype, D)
            want = ref.attention_ref(q, k, v, **kw)
            # bytes the function must move: q read and the output written
            # once, and the K and V rows of the keys some row of the lane
            # attends (not those under pad, past the frontier or dead)
            reach = int(mask.any(1).sum())
            nbytes = q.element_size() * (2 * q.numel() + 2 * H * D * reach)
            # timed over copies of (q, k, v) that together read more than
            # the L2 holds, so K and V come from device memory
            pool = _copies(lambda q=q, k=k, v=v: (q.clone(), k.clone(),
                                                  v.clone()), nbytes)
            lib = None
            if kw["softcap"] is None:
                amask = mask[:, None]
                lib = (lambda i, pool=pool, amask=amask:
                       Fn.scaled_dot_product_attention(*pool[i],
                                                       attn_mask=amask),
                       len(pool))

            def launch(i, pool=pool, kw=kw):
                return flash_attention(*pool[i], **kw)

            ok &= zeros and _measure(
                rows, "flash_attention", f"{label} {tname} route={route}",
                got, want, launch,
                lambda q=q, k=k, v=v, kw=kw: ref.attention_ref(q, k, v, **kw),
                lib, len(pool), nbytes, 4 * D * H * int(mask.sum()),
                rate=(peaks().PEAK_FLOPS if dtype == torch.bfloat16
                      else peaks().F32_FLOPS),
                tol=FLASH_TOL[tname], leaf=label, dtype=tname, route=route,
                B=B, H=H, Sq=Sq, Sk=Sk, D=D, dead_rows_zero=zeros)
            if route == "wide" and lib is not None:
                rows[-1]["sdpa_backend"] = _sdpa_backend(
                    lambda lib=lib: lib[0](0))
                print(f"    sdpa picked the {rows[-1]['sdpa_backend']} "
                      "backend")
            if route == "mma":
                with _pin_route("fma"):
                    before = flash_attention(q, k, v, **kw)
                fma_ok = _within(before, want, FLASH_TOL[tname]) and bool(
                    (before[dead] == 0).all())
                turns = device_ms_routes(launch, len(pool), ("mma", "fma"))
                rows[-1].update(ms=turns["mma"], ms_fma=turns["fma"],
                                fma_ok=fma_ok)
                ok &= fma_ok
                print(f"    in turns: mma {turns['mma']:.4f} ms, fma "
                      f"(pinned) {turns['fma']:.4f} ms, fma within "
                      f"tolerance: {fma_ok}")
                del before
            del q, k, v, got, want, mask, pool

    # fold: K = 576 / 1536 accumulators of the 5- and 7-channel bases
    S = 512 * 1536
    for mods in (basis_for_int8_matmul(1536).moduli,
                 basis_for_chain(1536).moduli):
        for bound in (2**31 - 1, 1536 * 46 * 46):
            C = len(mods)
            x = torch.randint(0, bound, (C, S), generator=g, device=dev,
                              dtype=torch.int32)
            x[:, :2] = torch.tensor([0, bound - 1], dtype=torch.int32)
            mcol = torch.tensor(mods, dtype=torch.int32, device=dev)[:, None]
            # timed over copies of x that together outgrow the L2
            pool = _copies(x.clone, 4 * C * S)
            ok &= _measure(
                rows, "fold", f"C={C} S={S} bound={bound}",
                fold(x, mods, bound), ref.fold_ref(x, mods, bound),
                lambda i, pool=pool, mods=mods, bound=bound: fold(
                    pool[i], mods, bound),
                lambda x=x, mods=mods, bound=bound: ref.fold_ref(x, mods,
                                                                 bound),
                (lambda i, pool=pool, mcol=mcol: torch.remainder(pool[i],
                                                                 mcol),
                 len(pool)),
                len(pool), 8 * C * S, 0, C=C, S=S, bound=bound)
            del pool

    # rns_fused_crt_partial: one smollm layer's float-emit launches
    specs = [(name, basis_for_int8_matmul(k), k, n, "quantize")
             for name, k, n, _ in layer_shapes]
    specs += [("qkv", basis_for_int8_matmul(d), d, qkv_n, "residue_in"),
              ("down", basis_for_chain(F), F, d, "gated")]
    for name, basis, k, n, form in specs:
        mods = basis.moduli
        C = len(mods)
        wt = encode(torch.randn(k, n, generator=g, device=dev) / k ** 0.5,
                    basis)
        pool = _copies(lambda: torch.randint(0, 37, (C, k, n),
                                             dtype=torch.int8, device=dev),
                       C * k * n)
        L1 = crt_tables(basis)[2]
        for m in (decode_m, prefill_m):
            xf = torch.randn(m, k, generator=g, device=dev)
            xf[0, :2] = torch.tensor([40.0, -40.0])
            gate = None
            if form == "quantize":
                x = xin = xf.to(torch.bfloat16)
                srow = quant_scale(x)
            else:
                xin = encode_activation(xf, basis)
                x, srow = xin.residues, xin.scale
                if form == "gated":
                    gate = torch.randint(-127, 128, (m, k), generator=g,
                                         device=dev, dtype=torch.int8)
            full = rns_fused_matmul(xin, wt, scale_row=srow,
                                    scale_col=wt.scale, gate=gate)
            for nsl in (1, C):
                kw = dict(scale_row=srow, gate=gate)

                def run(w, xin=xin, wt=wt, nsl=nsl, kw=kw):
                    return channel_partials(
                        xin, RNSTensor(w, wt.scale, wt.basis), nsl, **kw)

                def plain(xin=xin, wt=wt, nsl=nsl, kw=kw):
                    return channel_partials(xin, wt, nsl, plain=True, **kw)

                parts = run(wt.residues)
                composed = channel_sliced_matmul(xin, wt, nsl,
                                                 scale_col=wt.scale, **kw)
                torch.cuda.synchronize()
                same = torch.equal(composed, full)
                ok &= same

                def lib(i, xin=xin, gate=gate, srow=srow, wt=wt, pool=pool):
                    return rns_fused_matmul(
                        xin, RNSTensor(pool[i], wt.scale, wt.basis),
                        scale_row=srow, scale_col=wt.scale, gate=gate)

                xbytes = x.numel() * x.element_size()
                nbytes = (xbytes + C * k * n + 4 * m + (m * k if gate is
                                                          not None else 0)
                          + 4 * L1 * m * n * nsl)
                ok &= _measure(
                    rows, "rns_fused_crt_partial",
                    f"{name} M={m} K={k} N={n} n={nsl}",
                    torch.stack(parts), torch.stack(plain()),
                    lambda i, run=run, pool=pool: run(pool[i]), plain,
                    (lib, len(pool)), len(pool), nbytes, 2 * C * m * k * n,
                    again=(lambda run=run, wt=wt: torch.stack(
                        run(wt.residues))) if m > 16 else None,
                    leaf=name, M=m, K=k, N=n, C=C, slices=nsl, form=form,
                    composed_equal=same)
    return rows, bool(ok)


def convert_sums(rows, rows2, names, ms):
    """Per-layer sums of the conversion kernels: the 7 encodes at Engine
    init; the staged path's 7 weight conversions (the same at every M);
    at each M the staged path's 7 reverses and the resident path's 2
    activation encodes."""
    def of(kernel, pick):
        return _sum([r for r in rows2 if r["kernel"] == kernel and pick(r)])

    out = {"init encodes": _sum([r for r in rows
                                 if r["kernel"] == "rns_forward"]),
           "staged weight conversions": of(
               "rns_forward", lambda r: r["leaf"].startswith("weight-"))}
    for m in ms:
        out[f"staged reverses M={m}"] = of(
            "rns_reverse", lambda r: r["leaf"] in names and r["M"] == m)
        out[f"resident activation encodes M={m}"] = of(
            "rns_forward", lambda r: r["leaf"] in ("act-qkv", "act-mlp")
            and r["M"] == m)
    return out


def per_layer(rows, rows2, layer_shapes, m):
    """Each served path's tile-kernel launches of one layer at M = m,
    summed at the heights the launcher picks (``ms``) and, past 16 rows,
    at each height pinned: fused (the 7 quantize launches), resident
    (qkv, gate, up, gated down residue-in + the quantize wo) and staged
    (the 7 broadcast rns_matmul)."""
    def fused(k, n):
        return next(r for r in rows if r["kernel"] == "rns_fused_matmul"
                    and r["weights"] == "encoded" and r["M"] == m
                    and (r["K"], r["N"]) == (k, n))

    def row2(kernel, label):
        return next(r for r in rows2 if r["kernel"] == kernel
                    and r["label"].startswith(label + " ") and r["M"] == m)

    _, wo_k, wo_n, _ = next(s for s in layer_shapes if s[0] == "wo")
    paths = {"fused": [fused(k, n) for _, k, n, _ in layer_shapes],
             "resident": [row2("rns_fused_matmul:residue_in", lab)
                          for lab in ("qkv", "gate", "up", "down")]
             + [fused(wo_k, wo_n)],
             "staged": [row2("rns_matmul", name)
                        for name, _, _, _ in layer_shapes]}
    keys = ("ms", "bound_ms", "library_ms") + (
        ("ms_tm64", "ms_tm32", "ms_tm16") if m > 16 else ())
    return {path: {"launches": len(rs),
                   **{k: sum(r[k] for r in rs) for k in keys
                      if all(k in r for r in rs)}}
            for path, rs in paths.items()}


SLICE3 = ("flash_attention", "fold", "rns_fused_crt_partial")
COUNTED = ("rns_fused_matmul", "residue_in", "rns_forward", "rns_matmul",
           "rns_reverse", "rns_modmul") + SLICE3


def _counters():
    from repro_torch.kernels import (flash_attention, fold, rns_forward,
                                     rns_fused_crt_partial, rns_fused_matmul,
                                     rns_matmul, rns_modmul, rns_reverse)

    return (rns_fused_matmul, rns_forward, rns_matmul, rns_modmul,
            rns_reverse, flash_attention, fold, rns_fused_crt_partial)


def reset_launches():
    from repro_torch.kernels.rns_fused import tile_launches

    for f in _counters():
        f.launches = 0
    _counters()[0].residue_in_launches = 0
    for h in tile_launches:
        tile_launches[h] = 0
    for r in _counters()[5].route_launches:
        _counters()[5].route_launches[r] = 0


def read_launches():
    fused, fwd, mm, mod, rev, flash, fold, crt = _counters()
    return {"rns_fused_matmul": fused.launches,
            "residue_in": fused.residue_in_launches,
            "rns_forward": fwd.launches, "rns_matmul": mm.launches,
            "rns_reverse": rev.launches, "rns_modmul": mod.launches,
            "flash_attention": flash.launches, "fold": fold.launches,
            "rns_fused_crt_partial": crt.launches}


def expected_launches(cfg, steps):
    """Launches of a ``steps``-step generate (prefill + steps−1 decode
    steps) including the weight encodes at Engine init
    (`repro_torch.analysis.residency.expected_launches`)."""
    from repro_torch.analysis import residency

    return residency.expected_launches(cfg, steps)


# the port's kernels by the name the profiler shows, and the launch
# counters (`read_launches`) each is counted by
KERNEL_COUNTERS = {"rns_tile_kernel": ("rns_fused_matmul", "rns_matmul"),
                   "rns_forward_kernel": ("rns_forward",),
                   "rns_reverse_kernel": ("rns_reverse",),
                   "rns_modmul_kernel": ("rns_modmul",)}


def _step_launches(cfg):
    """Launches of one decode step (a host-loop step or the captured one):
    `repro_torch.analysis.residency.expected_step`."""
    from repro_torch.analysis import residency

    return residency.expected_step(cfg)


def _prefill_launches(cfg):
    """Launches of one eager prefill (a generate's first step, less the
    weight encodes at Engine init): `residency.expected_prefill`."""
    from repro_torch.analysis import residency

    return residency.expected_prefill(cfg)


def _graph_launches(graph):
    """The port's kernels in a captured graph by name (`KERNEL_COUNTERS`),
    read from the graph's kernel nodes (`_build.graph_kernels`), with no
    profiler: what one replay launches."""
    from repro_torch.kernels import _build

    nodes = _build.graph_kernels(graph)
    return {k: sum(c for name, c in nodes.items() if k in name)
            for k in KERNEL_COUNTERS}


def _by_kernel(launches):
    """Counted launches by the kernel name they launch (`KERNEL_COUNTERS`)."""
    return {k: sum(launches[c] for c in cs)
            for k, cs in KERNEL_COUNTERS.items()}


def _traced(eng, prompts, n, engine):
    """One profiled ``generate`` of ``n`` tokens: wall and device busy
    time, the longest kernels, the port's kernels by name as the profiler
    saw them (informative only: it drops a record now and then), and the
    launch counters' and the scan replays' increase over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_launches()
    replays = eng.scan_replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.generate(prompts, max_new_tokens=n, engine=engine)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    counted = read_launches()
    # kernel rows only: an aten op's row repeats its kernels' device time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in kernels), reverse=True)[:8]
    ours = {}
    for e in kernels:
        for name in KERNEL_COUNTERS:
            if name in e.key:
                us, c = ours.get(name, (0.0, 0))
                ours[name] = (us + e.self_device_time_total, c + e.count)
    return {"engine": engine, "tokens": n, "wall_ms": 1e3 * traced_s,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / (1e6 * traced_s),
            "top_device": [{"us": u, "name": k[:80], "count": c}
                           for u, k, c in top if u > 0],
            "port_kernels": {k: {"us": us, "count": c}
                             for k, (us, c) in ours.items()},
            "counted": counted, "replays": eng.scan_replays - replays}


def phase_serve(cfg, dev, lanes, n_prompts=4, new_tokens=32, smax=128):
    """One served config under both engines: the per-token loop
    (``engine="host"``) and the captured decode step replayed
    (``engine="scan"``), their launches, tokens, timings in turns and
    traced busy shares."""
    import numpy as np
    import torch
    from repro_torch.kernels import tune
    from repro_torch.kernels.rns_fused import (TM, TM_MMA, TM_WG,
                                               tile_launches)
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    lens = [5, 17, 38, 60][:n_prompts]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]

    # the host path: encode at init (if the config encodes), then one
    # batched generate, with every launch count set to 0 just before
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, smax=smax, lanes=lanes, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = eng.generate(prompts, max_new_tokens=new_tokens, engine="host")
    torch.cuda.synchronize()
    launches = read_launches()
    heights = dict(tile_launches)
    want = expected_launches(cfg, new_tokens)
    if launches != want:
        raise AssertionError(f"{cfg.name} launches {launches}, expected "
                             f"{want} over {new_tokens} prefill/decode "
                             "steps")
    # the prefill (M = lanes x bucket) at the heights the tuner picks,
    # every decode step on the 16-row tile (the only decode candidate)
    tiles = (want["rns_fused_matmul"] + want["rns_matmul"]) // new_tokens
    if sum(heights.values()) != tiles * new_tokens or \
            not heights[TM] >= tiles * (new_tokens - 1) or \
            heights[TM_MMA] + heights[TM_WG] > tiles:
        raise AssertionError(f"{cfg.name} tile launches by height "
                             f"{heights}: expected every decode launch at "
                             f"{TM} rows, the {TM_MMA}- and {TM_WG}-row "
                             f"ones among the {tiles} prefill launches")
    for p, o in zip(prompts, out):
        gen = o[len(p):]
        if o[:len(p)] != p or len(gen) != new_tokens or \
                not all(0 <= t < cfg.vocab_size for t in gen):
            raise AssertionError("malformed generate output")

    # the scan path: prefill, a warm-up step and the captured step counted
    # per step function call (the counters count at capture, not replay),
    # then new_tokens - 1 replays
    steps = []
    step = eng._step

    def counted_step(st):
        reset_launches()
        step(st)
        steps.append(read_launches())

    eng._step = counted_step
    scan = eng.generate(prompts, max_new_tokens=new_tokens, engine="scan")
    torch.cuda.synchronize()
    del eng._step
    one = _step_launches(cfg)
    if eng.scan_captures != 1 or eng.scan_replays != new_tokens - 1 or \
            steps != [one, one]:
        raise AssertionError(f"{cfg.name} scan: {eng.scan_captures} "
                             f"captures, {eng.scan_replays} replays, step "
                             f"launches (warm-up, capture) {steps}, "
                             f"expected {one} each")
    if scan != out:
        raise AssertionError(f"{cfg.name}: greedy scan tokens differ from "
                             "the host loop's")

    # batch invariance: each prompt alone (same lanes) == its batched run
    for i, p in enumerate(prompts):
        for engine in ("scan", "host"):
            solo = eng.generate([p], max_new_tokens=new_tokens,
                                engine=engine)[0]
            if solo != out[i]:
                raise AssertionError(f"prompt {i} alone ({engine}) differs "
                                     "from its batched tokens")

    # timing: prefill = generate(1 token), at the launcher's tile heights
    # and with every tile launch pinned to 16 rows, in turns (4 rounds);
    # decode = the rest, per step, host and scan in turns (2 rounds, A B
    # B A: a host generate of the staged model takes ~10 s)
    def once(n, engine="host"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.generate(prompts, max_new_tokens=n, engine=engine)
        torch.cuda.synchronize()
        return time.perf_counter() - t, res

    sweeps = tune.stats["sweeps"]
    pre = {TM_MMA: [], TM: []}
    for r in range(4):
        for pin in ((None, TM) if r % 2 == 0 else (TM, None)):
            pre[pin or TM_MMA].append(
                _pinned(lambda: once(1)[0], pin) if pin else once(1)[0])
    pre_s, pre16_s = (statistics.median(pre[h]) for h in (TM_MMA, TM))
    full = {"host": [], "scan": []}
    for r in range(DECODE_ROUNDS):
        for engine in (("host", "scan") if r % 2 == 0 else ("scan", "host")):
            t, res = once(new_tokens, engine)
            if res != out:
                raise AssertionError(f"greedy generate ({engine}) is not "
                                     "deterministic")
            full[engine].append(t)
    dec_ms = {e: 1e3 * (statistics.median(ts) - pre_s) / (new_tokens - 1)
              for e, ts in full.items()}
    if tune.stats["sweeps"] != sweeps:
        raise AssertionError(f"{cfg.name}: the tuner swept "
                             f"{tune.stats['sweeps'] - sweeps} shapes "
                             "inside timed generates")

    # traced generates: the device busy share of each engine (the host
    # loop over 4 tokens, as before the scan existed: its trace is the
    # profiler's costliest).  The scan's launches, exactly and without the
    # profiler: the captured graph's kernel nodes by name == the step's
    # counted launches, its replays == new_tokens - 1 by the engine's
    # counter, and its eager prefill's counted launches == one prefill's
    traces = {"host": _traced(eng, prompts, 4, "host"),
              "scan": _traced(eng, prompts, new_tokens, "scan")}
    tr = traces["scan"]
    nodes = _graph_launches(eng._scan[(lanes, smax, False)].graph)
    tr["graph_nodes"] = nodes
    if tr["replays"] != new_tokens - 1 or nodes != _by_kernel(one) or \
            tr["counted"] != _prefill_launches(cfg):
        raise AssertionError(f"{cfg.name} traced scan generate: graph "
                             f"kernel nodes {nodes}, expected "
                             f"{_by_kernel(one)}; {tr['replays']} replays, "
                             f"expected {new_tokens - 1}; prefill launches "
                             f"{tr['counted']}, expected "
                             f"{_prefill_launches(cfg)}")

    # finite logits at the served shape
    batch, _ = eng._pack(prompts)
    with torch.inference_mode():
        logits, _, _ = T.prefill(cfg, eng.params, batch, smax)
    if not (logits.shape == (lanes, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite / wrong shape")
    per_step = {k: (v - expected_launches(cfg, 0)[k]) // new_tokens
                for k, v in want.items()}
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "launches": launches, "launches_per_step": per_step,
            "captured_step_launches": one,
            "tile_launches_by_rows": heights,
            "init_s": init_s, "prefill_ms": 1e3 * pre_s,
            "prefill_ms_tm16": 1e3 * pre16_s,
            "decode_ms_per_token": dec_ms["host"],
            "decode_ms_per_token_scan": dec_ms["scan"],
            "decode_tokens_per_s": n_prompts * 1e3 / dec_ms["host"],
            "decode_tokens_per_s_scan": n_prompts * 1e3 / dec_ms["scan"],
            "prompt_lens": lens, "lanes": lanes, "new_tokens": new_tokens,
            "smax": smax, "batch_invariant": True, "scan_equals_host": True,
            "trace": traces["host"], "trace_scan": traces["scan"]}


# the scheduled serve: 8 slots of 256 tokens over a pool of half the
# static reservation (1 + 8·16 blocks), so admissions defer
SCHED = {"slots": 8, "block_size": 16, "slot_tokens": 256, "n_blocks": 65,
         "decode_chunk": 8}


def sched_requests(vocab, n=24, seed=0):
    """``n`` requests from a seeded generator, a synthetic trace that
    exercises the scheduler's mechanisms (it follows no public serving
    trace, so its numbers say nothing of real traffic): prompts of 5-120
    tokens, six of them (three pairs of neighbours in arrival order)
    opening with one 32-token head (2 blocks), 16-64 new tokens each,
    Poisson arrivals at one every 4 virtual steps on average, so slots
    turn over mid-flight."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, 32).tolist()
    sharers = {2, 3, 9, 10, 16, 17}
    arrivals = np.cumsum(rng.exponential(4.0, n)) - 4.0
    reqs = []
    for i in range(n):
        if i in sharers:
            prompt = head + rng.integers(
                1, vocab, int(rng.integers(8, 89))).tolist()
        else:
            prompt = rng.integers(1, vocab, int(rng.integers(5, 121))).tolist()
        reqs.append(Request(prompt, int(rng.integers(16, 65)), seed=i,
                            arrival=max(0.0, float(arrivals[i]))))
    return reqs, sorted(sharers)


def _traced_serve(sched, reqs):
    """One whole serve of ``reqs`` under the profiler, after the capture
    (a whole serve of the Poisson trace costs the profiler minutes, so the
    caller passes a small fixed burst).  Its wall and device busy time,
    the port's kernels by name, and the launch counters', the replays' and
    the admissions' increase over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    replays, admissions = sched.chunk_replays, sched.admissions
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = sched.serve(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    counted = read_launches()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ours = {}       # as the profiler saw them: informative only
    for e in kernels:
        for name in KERNEL_COUNTERS:
            if name in e.key:
                ours[name] = ours.get(name, 0) + e.count
    return out, {"requests": len(reqs),
                 "new_tokens": sched.stats["new_tokens"],
                 "wall_ms": 1e3 * wall_s,
                 "device_busy_ms": busy_us / 1e3,
                 "device_busy_share": busy_us / (1e6 * wall_s),
                 "port_kernels": ours, "counted": counted,
                 "replays": sched.chunk_replays - replays,
                 "admissions": sched.admissions - admissions}


def phase_sched(cfg, dev):
    """The continuous-batching scheduler on one full model: `SCHED` over
    `sched_requests`, greedy.  Gates: four requests and every head-sharer
    equal to the engine's solo generate; the pool within n_blocks - 1
    blocks, prefix hits, pool bytes below the static reservation; the
    captured paged step's launches equal to one eager paged step's (the
    warm-up); sampled outputs (a second scheduler at temperature 0.8, the
    first 8 requests) equal to the solo sampled generate; the kernels by
    name of a traced serve (the first 8 requests as a burst at step 0, 9
    new tokens each: 8 admissions, one chunk of 8 replays) equal to its
    admissions' counted prefill launches plus the step's times its
    replays.  Timed in
    turns: serves of the trace, serves of the same 24 requests as a burst
    at step 0, and the static engine's one-batch generate of the same
    prompts (scan, the longest request's new tokens for every prompt):
    the burst and the static generate face the same requests, all present
    at the start.  Each serve's share of wall time spent in admissions
    (prefill, splice, first token) comes from the scheduler's own timer
    (`time_admissions`)."""
    import torch
    from repro_torch.kernels import tune
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, SlotScheduler
    from repro_torch.serve.paged_cache import paged_cache_nbytes

    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    sched = SlotScheduler(cfg, params, device=dev, **SCHED)
    reqs, sharers = sched_requests(cfg.vocab_size)
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 1)
        t_part[0] = now

    # the first serve: the paged step captured (warm-up and capture
    # counted), then the chunks replayed; every count set to 0 before it
    steps = []
    step = sched._step

    def counted_step():
        before = read_launches()
        step()
        steps.append({k: v - before[k] for k, v in read_launches().items()})

    sched._step = counted_step
    torch.cuda.synchronize()
    reset_launches()
    out = sched.serve(reqs)
    torch.cuda.synchronize()
    launches = read_launches()
    del sched._step
    part("first serve")
    one = _step_launches(cfg)
    stats = dict(sched.stats)
    if sched.chunk_captures != 1 or steps != [one, one] or \
            sched.chunk_replays != stats["chunks"] * SCHED["decode_chunk"]:
        raise AssertionError(f"{cfg.name} sched: {sched.chunk_captures} "
                             f"captures, {sched.chunk_replays} replays over "
                             f"{stats['chunks']} chunks, step launches "
                             f"(warm-up, capture) {steps}, expected {one}")
    static = T.init_cache(cfg, SCHED["slots"], SCHED["slot_tokens"], "meta")
    static_bytes = paged_cache_nbytes(static)
    if not (stats["peak_blocks"] <= SCHED["n_blocks"] - 1
            and stats["prefix_hits"] > 0
            and stats["pool_bytes"] < static_bytes):
        raise AssertionError(f"{cfg.name} sched stats {stats}, static "
                             f"reservation {static_bytes} bytes")
    checked = sorted({0, 7, 13, 21} | set(sharers))
    for i in checked:
        r = reqs[i]
        solo = sched.engine.generate([r.prompt], r.max_new_tokens)[0]
        if out[i] != solo:
            raise AssertionError(f"{cfg.name} sched: request {i} differs "
                                 "from the engine's solo generate")
    for r, o in zip(reqs, out):
        gen = o[len(r.prompt):]
        if len(gen) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab_size for t in gen):
            raise AssertionError("malformed scheduled output")
    part("solo")

    # sampled: a second scheduler at temperature 0.8, every slot's
    # generator registered with its graph, over the first 8 requests (16
    # new tokens at most): each equal to the engine's solo sampled generate

    samp = SlotScheduler(cfg, params, device=dev, temperature=0.8, **SCHED)
    few = [Request(r.prompt, min(r.max_new_tokens, 16), seed=r.seed,
                   arrival=r.arrival) for r in reqs[:8]]
    sampled = samp.serve(few)
    for r, o in zip(few, sampled):
        solo = samp.engine.generate([r.prompt], r.max_new_tokens,
                                    temperature=0.8, seed=r.seed)[0]
        if o != solo:
            raise AssertionError(f"{cfg.name} sampled sched: request seed "
                                 f"{r.seed} differs from its solo generate")
    del samp
    part("sampled")

    # traced: a fixed burst (8 admissions, one chunk of 8 replays).  Its
    # launches, exactly and without the profiler: the captured paged
    # step's kernel nodes by name == the step's counted launches, 8
    # replays and 8 admissions by the scheduler's counters, and the
    # admissions' counted launches == 8 eager prefills'
    burst8 = [Request(r.prompt, 9, seed=r.seed) for r in reqs[:8]]
    traced_out, tr = _traced_serve(sched, burst8)
    nodes = _graph_launches(sched._graph)
    tr["graph_nodes"] = nodes
    prefills = {k: 8 * v for k, v in _prefill_launches(cfg).items()}
    want_out = [o[:len(r.prompt) + 9] for r, o in zip(burst8, out)]
    if traced_out != want_out or nodes != _by_kernel(one) or \
            tr["counted"] != prefills or \
            (tr["admissions"], tr["replays"]) != (8, 8):
        raise AssertionError(f"{cfg.name} traced serve: graph kernel nodes "
                             f"{nodes}, expected {_by_kernel(one)}; "
                             f"admissions' launches {tr['counted']}, "
                             f"expected {prefills}; {tr['admissions']} "
                             f"admissions and {tr['replays']} replays, "
                             f"expected 8 and 8; tokens equal to the "
                             f"trace's {traced_out == want_out}")

    part("trace")

    # timed in turns: trace, burst, static, static, burst, trace; every
    # serve's admissions timed by the scheduler
    burst = [Request(r.prompt, r.max_new_tokens, seed=r.seed)
             for r in reqs]
    prompts = [r.prompt for r in reqs]
    longest = max(r.max_new_tokens for r in reqs)
    sched.engine.generate(prompts, longest)         # capture at 24 lanes
    kinds = ("trace", "burst", "static")
    times = {k: [] for k in kinds}
    admit_share = {"trace": [], "burst": []}
    burst_stats = None
    sched.time_admissions = True
    sweeps = tune.stats["sweeps"]
    for order in (kinds, kinds[::-1]):
        for kind in order:
            admitted, sched.admit_seconds = sched.admissions, 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "static":
                sched.engine.generate(prompts, longest)
            else:
                res = sched.serve(reqs if kind == "trace" else burst)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            times[kind].append(dt)
            if kind != "static":
                if res != out:
                    raise AssertionError(f"{cfg.name} {kind}: greedy "
                                         "outputs differ from the first "
                                         "serve's")
                if sched.admissions - admitted != len(reqs) or \
                        not sched.admit_seconds > 0.0:
                    raise AssertionError(
                        f"{cfg.name} {kind}: {sched.admissions - admitted}"
                        f" admissions timed at {sched.admit_seconds} s, "
                        f"expected {len(reqs)} taking some time")
                admit_share[kind].append(sched.admit_seconds / dt)
                if kind == "burst":
                    burst_stats = dict(sched.stats)
    sched.time_admissions = False
    if tune.stats["sweeps"] != sweeps:
        raise AssertionError(f"{cfg.name}: the tuner swept "
                             f"{tune.stats['sweeps'] - sweeps} shapes "
                             "inside timed serves")
    wall = {k: statistics.median(v) for k, v in times.items()}
    new = stats["new_tokens"]
    part("timed")
    return {"arch": cfg.name, "layers": cfg.num_layers, **SCHED,
            "stats": stats, "static_cache_bytes": static_bytes,
            "launches": launches, "captured_step_launches": one,
            "solo_checked": checked, "sharers": sharers,
            "times_s": times, "wall_s": wall["trace"],
            "tokens_per_s": new / wall["trace"],
            "burst_wall_s": wall["burst"],
            "burst_tokens_per_s": new / wall["burst"],
            "burst_stats": burst_stats,
            "static_wall_s": wall["static"],
            "static_tokens_per_s": new / wall["static"],
            "static_new_tokens": longest,
            "admit_share": {k: statistics.median(v)
                            for k, v in admit_share.items()},
            "trace": tr, "part_s": parts}


def phase_tune(dev, lanes, bucket, smi):
    """The tile kernel's autotuner on the three full served models: every
    decode shape `Engine.__init__` warms is a hit of the committed H100
    table and init sweeps nothing; greedy tokens (scan, graphs captured
    afresh under each rule) and prefill logits are bit-equal between the
    tuner's choices and the static rule, in turns (tuned, static, static,
    tuned); then one line per distinct shape (each warmed decode shape and
    each prefill launch at M = lanes x bucket) with both choices and their
    device µs, two CUDA graphs of 20 launches on seeded operands replayed
    in turns (operands stay warm in the L2: a comparison of the two
    choices, not the kernel rows' cold-weight time)."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, tune
    from repro_torch.kernels.rns_fused import static_choice
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    sms = _build.num_sms(0)
    rng = np.random.default_rng(5)
    shapes, configs = {}, {}
    for arch in (ARCH, RESIDENT, STAGED):
        cfg = get_config(arch)
        params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        sweeps = tune.stats["sweeps"]
        eng = Engine(cfg, params, smax=128, lanes=lanes, device=dev)
        report = eng.tune_report
        if not report or not all(r["hit"] for r in report) or \
                tune.stats["sweeps"] != sweeps:
            raise AssertionError(
                f"{arch}: Engine init swept {tune.stats['sweeps'] - sweeps} "
                f"shapes; table misses "
                f"{[r['key'] for r in report if not r['hit']]}")
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (5, 17, 38, 60)]
        batch, _ = eng._pack(prompts)
        runs = {"tuned": [], "static": []}
        for rule in ("tuned", "static", "static", "tuned"):
            eng._scan.clear()            # capture the step under this rule
            ctx = tune.static_rule() if rule == "static" else \
                contextlib.nullcontext()
            with ctx:
                toks = eng.generate(prompts, max_new_tokens=16)
                with torch.inference_mode():
                    logits, _, _ = T.prefill(cfg, eng.params, batch, 128)
            runs[rule].append((toks, logits.float().cpu()))
        ref_toks, ref_logits = runs["tuned"][0]
        equal = all(t == ref_toks and torch.equal(lg, ref_logits)
                    for r in runs.values() for t, lg in r)
        if not equal:
            raise AssertionError(f"{arch}: tokens or prefill logits differ "
                                 "between the tuned and the static choices")
        configs[arch] = {"warmed": len(report), "hits": len(report),
                         "tokens_equal": True, "logits_equal": True}
        del eng
        for s in tune.decode_shapes_for(
                cfg, tune.ZOO_BATCH_SIZES + (lanes * bucket,)):
            shapes.setdefault((s["backend"], s["dtype"], s["C"], s["M"],
                               s["K"], s["N"]), s)
    rows, n = [], 20
    for (backend, dtype, C, M, K, N), s in sorted(shapes.items(),
                                                  key=lambda kv: (kv[0][3],
                                                                  kv[0])):
        static = static_choice(M, K, N, C, sms)
        tuned = tune.blocks_for(M, K, N, C, dtype=dtype, backend=backend,
                                device=dev, moduli=s["moduli"])
        launch = tune.launcher_for(M, K, N, C, dtype, backend, dev,
                                   moduli=s["moduli"])
        graphs = [_capture(lambda i, b=b: launch(b), n)
                  for b in (static, tuned)]
        st_ms, tu_ms = _in_turns(graphs, n, 8)
        rows.append({"backend": backend, "dtype": dtype, "C": C, "M": M,
                     "K": K, "N": N, "static": list(static),
                     "tuned": list(tuned), "static_us": 1e3 * st_ms,
                     "tuned_us": 1e3 * tu_ms})
        print(f"tune: {backend} {dtype} C={C} M={M} K={K} N={N} static "
              f"(tm, splits) {static} {1e3 * st_ms:.2f} us | tuned "
              f"{tuned} {1e3 * tu_ms:.2f} us | on {smi}")
    return {"configs": configs, "shapes": rows}


def phase_verify(dev):
    """``Engine(verify="static")`` on every registered config at full
    width (the static gate runs before any weight is encoded), another
    ``verify`` value refused with ValueError, and `check_pipeline` refusing
    the undersized chain basis of the reference's `tests/test_analysis.py`
    (d_ff 1536 on `basis_for_int8_matmul`) with AnalysisError."""
    import torch
    from repro_torch.analysis import (AnalysisError, PipelineSpec,
                                      check_pipeline)
    from repro_torch.configs.base import _REGISTRY, _ensure_loaded, get_config
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    _ensure_loaded()
    base = get_config(ARCH)
    params = T.make_params(base, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    accepted = []
    for name in sorted(_REGISTRY):
        cfg = get_config(name)
        Engine(cfg, params, smax=64, verify="static", device=dev)
        accepted.append(name)
    try:
        Engine(base, params, smax=64, verify="dynamic", device=dev)
        raise AssertionError("Engine(verify='dynamic') was accepted")
    except ValueError as e:
        refused = str(e)
    F = 1536
    spec = PipelineSpec.for_basis(basis_for_int8_matmul(F), F, x_bound=127,
                                  w_bound=127, residue_in=True, gate=True,
                                  label="undersized-chain")
    rep, _ = check_pipeline(spec)
    try:
        rep.raise_if_failed()
        raise AssertionError("the undersized chain basis was accepted")
    except AnalysisError:
        pass
    return {"accepted": accepted, "refused": refused,
            "findings": [str(f) for f in rep.errors]}


def phase_twit(dev, smi):
    """The paper's twit multiplier and adder as tensors on the card
    (`core.modmul.mulmod_twit_tensor`, `core.modadd.addmod_twit_tensor`):
    every residue pair of every admissible modulus at n = 5 and n = 8
    (both signs, every δ), 2^16 seeded pairs of each at n = 11; each
    result bit-equal to (a·b) mod m and (a+b) mod m, and to the scalar
    models on 8 pairs a modulus.  On the paper's n = 5 basis (its 11
    channels of the form 2^5 ± δ) the tensor multiplier equals the
    `rns_modmul` kernel over the same planes (every pair of every
    channel; int32 and int8).  Timed on the device (`device_ms`): one call
    of each over 2^24 pairs, and both multipliers over (11, 2^20) planes
    of that basis."""
    import torch
    from repro_torch.core.modadd import addmod_twit, addmod_twit_tensor
    from repro_torch.core.modmul import mulmod_twit, mulmod_twit_tensor
    from repro_torch.core.rns import PAPER_N5_MODULI
    from repro_torch.core.twit import Modulus, admissible_deltas
    from repro_torch.kernels import rns_modmul

    g = torch.Generator(device=dev).manual_seed(11)
    widths = {}
    for n, count in ((5, None), (8, None), (11, 1 << 16)):
        mods = [Modulus(n, d, sgn) for sgn in (+1, -1)
                for d in admissible_deltas(n)]
        pairs = samples = 0
        for mod in mods:
            m = mod.m
            if count is None:
                idx = torch.arange(m * m, device=dev)
                a, b = idx // m, idx % m
            else:
                a = torch.randint(0, m, (count,), generator=g, device=dev)
                b = torch.randint(0, m, (count,), generator=g, device=dev)
            prod = mulmod_twit_tensor(a, b, mod)
            add = addmod_twit_tensor(a, b, mod)
            if not (torch.equal(prod, torch.remainder(a * b, m))
                    and torch.equal(add, torch.remainder(a + b, m))):
                raise AssertionError(f"twit tensor models differ from "
                                     f"(a·b, a+b) mod {m} ({mod})")
            pick = torch.randint(0, a.numel(), (8,), generator=g,
                                 device=dev)
            for x, y, p, q in zip(*(t[pick].tolist()
                                    for t in (a, b, prod, add))):
                if mulmod_twit(x, y, mod) != p or \
                        addmod_twit(x, y, mod) != q:
                    raise AssertionError(f"tensor and scalar twit models "
                                         f"differ at ({x}, {y}) mod {m}")
            pairs += a.numel()
            samples += 8
        widths[n] = {"moduli": len(mods), "pairs": pairs,
                     "scalar_samples": samples,
                     "exhaustive": count is None}

    # the paper's n = 5 basis against the rns_modmul kernel
    chans = [m for m in PAPER_N5_MODULI if m != 1024]
    tw = [Modulus.from_value(m, n=5) for m in chans]
    S = 47 * 47
    idx = torch.arange(S, device=dev)
    mcol = torch.tensor(chans, device=dev).reshape(-1, 1)
    a = (idx // 47)[None] % mcol
    b = (idx % 47)[None] % mcol
    twit = torch.stack([mulmod_twit_tensor(a[c], b[c], tw[c])
                        for c in range(len(chans))])
    kern32 = rns_modmul(a.to(torch.int32), b.to(torch.int32), chans)
    kern8 = rns_modmul(a.to(torch.int8), b.to(torch.int8), chans,
                       out_dtype=torch.int8)
    if not (torch.equal(kern32.long(), twit)
            and torch.equal(kern8.long(), twit)):
        raise AssertionError("rns_modmul differs from the twit multiplier "
                             "on the paper's n = 5 basis")

    # timing (device time: `device_ms`, three calls captured in a graph):
    # one call over 2^24 pairs; both multipliers on (11, 2^20) planes
    big = 1 << 24
    timing = {}
    for n, d, sgn in ((5, 15, +1), (11, 1023, +1)):
        mod = Modulus(n, d, sgn)
        x = torch.randint(0, mod.m, (big,), generator=g, device=dev)
        y = torch.randint(0, mod.m, (big,), generator=g, device=dev)
        for op, fn in (("mulmod", mulmod_twit_tensor),
                       ("addmod", addmod_twit_tensor)):
            ms = device_ms(lambda i, fn=fn: fn(x, y, mod), 3, reps=5)
            timing[f"{op} {mod}"] = {"us": 1e3 * ms, "pairs": big,
                                     "per_s": big / (ms * 1e-3)}
        del x, y
    S2 = 1 << 20
    pa = torch.stack([torch.randint(0, m, (S2,), generator=g, device=dev)
                      for m in chans])
    pb = torch.stack([torch.randint(0, m, (S2,), generator=g, device=dev)
                      for m in chans])
    pa32, pb32 = pa.to(torch.int32), pb.to(torch.int32)
    ms_t = device_ms(lambda i: [mulmod_twit_tensor(pa[c], pb[c], tw[c])
                                for c in range(len(chans))], 3, reps=5)
    ms_k = device_ms(lambda i: rns_modmul(pa32, pb32, chans), 3, reps=5)
    for name, ms in (("twit tensor model, 11 channels", ms_t),
                     ("rns_modmul kernel int32, 11 channels", ms_k)):
        timing[name] = {"us": 1e3 * ms, "pairs": len(chans) * S2,
                        "per_s": len(chans) * S2 / (ms * 1e-3)}
    print("twit: " + " | ".join(
        f"n={n}: {w['moduli']} moduli, "
        f"{'every pair' if w['exhaustive'] else '2^16 seeded pairs each'}"
        f" ({w['pairs']} pairs) bit-equal to (a*b, a+b) mod m, "
        f"{w['scalar_samples']} against the scalar models"
        for n, w in widths.items())
        + f" | paper n=5 basis ({len(chans)} channels, every pair) == "
        f"rns_modmul int32 and int8 | on {smi}")
    print("twit: timing " + " | ".join(
        f"{k}: {v['us']:.1f} us, {v['per_s']:.4g} results/s over "
        f"{v['pairs']} pairs" for k, v in timing.items()) + f" | on {smi}")
    return {"widths": widths, "basis_channels": chans, "timing": timing}


# the families phase: the other model families at their published widths
# (seeded random weights), published one at a time and freed before the
# next, each served through `serve.Engine` under both engines.  Rows:
# (label, arch, layers kept or None, config overrides, smax, prompt lens,
# new tokens).  hymba's prompts bucket to 1024 (the SSM chunk is 256), so
# its 1024-slot rings are full after the prefill and wrap during decode;
# moonshot keeps 12 of its 48 layers (all 48 take ~56 GB of weights);
# the dense bf16 smollm-135m times its prefill's float64 linears too.
FUSED = {"linear_backend": "rns_int8:pallas_fused", "encode_weights": True}
FAMILY_RUNS = [
    ("hymba-1.5b", "hymba-1.5b", None, {}, 2048, [1000, 5, 61, 200], 64),
    ("hymba-1.5b-fused", "hymba-1.5b", None, FUSED, 2048,
     [1000, 5, 61, 200], 64),
    ("gemma2-2b", "gemma2-2b", None, {}, 512, [200, 5, 61, 130], 32),
    ("mamba2-1.3b", "mamba2-1.3b", None, {}, 512, [200, 5, 61, 130], 32),
    ("moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b", 12, {}, 512,
     [200, 5, 61, 130], 32),
    ("smollm-135m", "smollm-135m", None, {}, 512, [200, 5, 61, 130], 32),
]
ZOO = ["gemma2-2b", "h2o-danube-1.8b", "hymba-1.5b",
       "llama4-maverick-400b-a17b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
       "musicgen-large", "phi-3-vision-4.2b", "yi-34b"]
# card vs CPU on the zoo's smoke twins: the tolerance the CPU tests hold
# the port to against the reference (tests/test_torch_families.py), a
# share of the largest |logit|
ZOO_RTOL = 0.08
# the host loop's timed generates: 5 decode steps (its per-token cost
# does not change with the position; the scan's generates take them all;
# cut from 8 to pay for the 64-row tile's rows in the int8 and staged
# kernel phases)
FAMILY_HOST_TOKENS = 6
# the scheduled mamba2 serve: 4 slots of 512 tokens, chunks of 8 steps
FAMILY_SCHED = {"slots": 4, "block_size": 16, "slot_tokens": 512,
                "decode_chunk": 8}


def _tile_channels(graph):
    """Tile-kernel nodes of a captured graph by channel count C, read from
    the instances' mangled names (rns_tile_kernel<TMR, C, AM, ENC>)."""
    import re
    from repro_torch.kernels import _build

    out = {}
    for name, n in _build.graph_kernels(graph).items():
        m = re.search(r"rns_tile_kernelILi\d+ELi(\d+)E", name)
        if m:
            out[int(m.group(1))] = out.get(int(m.group(1)), 0) + n
    return out


def _decode_channels(cfg):
    """{C: launches} of one decode step of a config with every attention
    and MLP linear on the fused kernel: one launch a linear, C from each
    linear's K."""
    from repro_torch.core.rns import basis_for_int8_matmul

    d, F, qd = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim
    out = {}
    for k in (d, d, d, qd, d, d, F):          # wq wk wv wo gate up down
        c = len(basis_for_int8_matmul(k).moduli)
        out[c] = out.get(c, 0) + cfg.num_layers
    return out


def _ring(eng, lanes, smax):
    """The write cursor of the scan cache's first ring layer: the padded
    positions its slots hold, and the slot last written."""
    from repro_torch.models.transformer import _cache_at

    st = eng._scan[(lanes, smax, False)]
    for col in st.cache.values():
        for b in range(eng.cfg.n_blocks):
            c = _cache_at(col, b)
            if "pos" in c:
                pos = c["pos"].cpu()
                last = int(pos.max())
                return {"window": pos.shape[0], "last_pos": last,
                        "last_slot": int(pos.argmax()),
                        "first_pos": int(pos.min()),
                        "wrapped": last >= pos.shape[0]}
    return None


def _family_serve(label, cfg, params, dev, lanes, smax, prompts, new,
                  invariance):
    """One model through `serve.Engine`: launches of the host loop (init
    encodes included) against the expected count; the scan's captured
    step (warm-up and capture counted alike, its graph's port-kernel
    nodes equal to that count, one replay a token); greedy scan == host;
    each prompt alone == batched (``invariance``); prefill and decode
    timed, host and scan in turns; last-token prefill logits."""
    import torch
    from repro_torch.kernels import _build, tune
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, smax=smax, lanes=lanes, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = eng.generate(prompts, max_new_tokens=new, engine="host")
    torch.cuda.synchronize()
    launches, want = read_launches(), expected_launches(cfg, new)
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    for p, o in zip(prompts, out):
        if o[:len(p)] != p or len(o) != len(p) + new or \
                not all(0 <= t < cfg.vocab_size for t in o[len(p):]):
            raise AssertionError(f"{label}: malformed generate output")
    steps, step = [], eng._step

    def counted_step(st):
        reset_launches()
        step(st)
        steps.append(read_launches())

    eng._step = counted_step
    misses = tune.stats["capture_misses"]
    scan = eng.generate(prompts, max_new_tokens=new, engine="scan")
    torch.cuda.synchronize()
    del eng._step
    one = _step_launches(cfg)
    graph = eng._scan[(lanes, smax, False)].graph
    nodes = _graph_launches(graph)
    if eng.scan_captures != 1 or eng.scan_replays != new - 1 or \
            steps != [one, one] or nodes != _by_kernel(one) or \
            tune.stats["capture_misses"] != misses:
        raise AssertionError(
            f"{label} scan: {eng.scan_captures} captures, "
            f"{eng.scan_replays} replays, step launches {steps}, graph "
            f"nodes {nodes}, expected {one} a step; "
            f"{tune.stats['capture_misses'] - misses} capture misses")
    if scan != out:
        raise AssertionError(f"{label}: greedy scan tokens differ from the "
                             "host loop's")
    channels = _tile_channels(graph)
    step_kernels = sum(_build.graph_kernels(graph).values())
    if cfg.linear_spec.is_rns and channels != _decode_channels(cfg):
        raise AssertionError(f"{label}: tile nodes by C {channels}, "
                             f"expected {_decode_channels(cfg)}")
    ring = _ring(eng, lanes, smax)
    if ring is not None and not (
            ring["wrapped"] and ring["last_pos"] - ring["first_pos"]
            == ring["window"] - 1 and ring["last_slot"]
            == ring["last_pos"] % ring["window"]):
        raise AssertionError(f"{label}: ring {ring}")
    if invariance:
        for i, p in enumerate(prompts):
            if eng.generate([p], max_new_tokens=new)[0] != out[i]:
                raise AssertionError(f"{label}: prompt {i} alone differs "
                                     "from its batched tokens")

    def once(n, engine="scan"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.generate(prompts, max_new_tokens=n, engine=engine)
        torch.cuda.synchronize()
        return time.perf_counter() - t, res

    once(1)                          # the prefill shape's first use
    sweeps = tune.stats["sweeps"]
    # in turns: the prefill alone (a 1-token generate), the host loop over
    # FAMILY_HOST_TOKENS tokens, the scan over all of them
    host_n = min(FAMILY_HOST_TOKENS, new)
    plan = [("pre", 1, "scan"), ("host", host_n, "host"),
            ("scan", new, "scan")]
    times = {what: [] for what, _, _ in plan}
    for r in range(2):
        for what, n, engine in (plan if r == 0 else plan[::-1]):
            t, res = once(n, engine)
            if res != [o[:len(p) + n] for p, o in zip(prompts, out)]:
                raise AssertionError(f"{label}: {engine} generate is not "
                                     "deterministic")
            times[what].append(t)
    if tune.stats["sweeps"] != sweeps:
        raise AssertionError(f"{label}: the tuner swept inside timed "
                             "generates")
    pre = statistics.median(times["pre"])
    dec = {"host": 1e3 * (statistics.median(times["host"]) - pre)
           / (host_n - 1),
           "scan": 1e3 * (statistics.median(times["scan"]) - pre)
           / (new - 1)}
    batch, _ = eng._pack(prompts)
    with torch.inference_mode():
        logits, _, _ = T.prefill(cfg, eng.params, batch, smax)
    logits = logits[:len(prompts)].float().cpu()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: prefill logits not finite")

    def prefill_ms(exact):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            T.prefill(cfg, eng.params, batch, smax, exact=exact)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    # the served prefill (plain linears summed in float64) against the
    # library GEMM's, in turns, the first use of the GEMM's shapes untimed
    prefill_ms(False)
    by_exact = {True: [], False: []}
    for order in ((True, False), (False, True)):
        for exact in order:
            by_exact[exact].append(prefill_ms(exact))
    per_step = {k: v for k, v in one.items() if v}
    del eng
    return {"label": label, "arch": cfg.name, "layers": cfg.num_layers,
            "prompt_lens": [len(p) for p in prompts], "lanes": lanes,
            "smax": smax, "new_tokens": new, "bucket": batch["tokens"]
            .shape[1], "init_s": init_s, "prefill_ms": 1e3 * pre,
            "prefill_ms_exact": statistics.median(by_exact[True]),
            "prefill_ms_library": statistics.median(by_exact[False]),
            "decode_ms_per_step": dec["host"],
            "decode_ms_per_step_scan": dec["scan"],
            "tokens_per_s": len(prompts) * 1e3 / dec["host"],
            "tokens_per_s_scan": len(prompts) * 1e3 / dec["scan"],
            "launches": launches, "launches_per_step": per_step,
            "step_kernels": step_kernels,
            "tile_nodes_by_C": channels, "ring": ring,
            "batch_invariant": bool(invariance), "scan_equals_host": True,
            "logits": logits}


def phase_family_kernels(cfg, dev, lanes, lens):
    """The fused family run's kernels at its own shapes, bit for bit
    against their plain versions: `rns_fused_matmul` on encoded weights at
    every (K, N) of the config's attention and MLP linears (K = d_model
    and d_ff: hymba's C = 5 and C = 6) and every M the run launches (the
    decode lanes; the prefill rows of the batch and of each prompt alone),
    as the tuner picks and at each tile height pinned; `rns_forward` at
    each linear weight's encode (one block's (K, N) int8).  Returns the
    rows."""
    import torch
    from repro_torch.core.quant import quant_scale
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.core.rns_tensor import encode
    from repro_torch.kernels import ref, rns_forward, rns_fused_matmul
    from repro_torch.serve.engine import bucket_plen

    d, F = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = sorted({(d, qd), (d, kvd), (qd, d), (d, F), (F, d)})
    ms = sorted({lanes} | {lanes * bucket_plen(cfg, n) for n in lens})
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for k, n in shapes:
        w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
        wt = encode(w)
        for m in ms:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            x[0, :2] = torch.tensor([40.0, -40.0])
            sx = quant_scale(x)

            def run():
                return rns_fused_matmul(x, wt.residues, wt.basis,
                                        scale_row=sx, scale_col=wt.scale)
            got = run()
            want = ref.rns_fused_matmul_ref(x, wt.residues, wt.basis,
                                            scale_row=sx, scale_col=wt.scale)
            eq = {"tuned": torch.equal(got, want),
                  **{f"tm{h}": v for h, v in
                     _both_heights(run, want).items()}}
            torch.cuda.synchronize()
            rows.append({"kernel": "rns_fused_matmul", "M": m, "K": k,
                         "N": n, "C": len(wt.basis.moduli), "equal": eq,
                         "max_abs_err": (got - want).abs().max().item()})
            del x, got, want
        q = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev)
        q.view(-1)[:4] = torch.tensor([-128, -127, 0, 127], dtype=torch.int8)
        mods = basis_for_int8_matmul(k).moduli
        got, want = rns_forward(q, mods, dtype=torch.int8), \
            ref.rns_forward_ref(q, mods, torch.int8)
        same = torch.equal(got, want)
        rows.append({"kernel": "rns_forward", "K": k, "N": n,
                     "C": len(mods), "equal": {"kernel": same},
                     "max_abs_err": 0 if same else
                     (got.int() - want.int()).abs().max().item()})
        del w, wt, q, got, want
    for r in rows:
        print(f"  families: {r['kernel']} "
              + (f"M={r['M']:5d} " if "M" in r else "")
              + f"K={r['K']:5d} N={r['N']:5d} C={r['C']} equal {r['equal']}"
              f" max|err| {r['max_abs_err']}")
    if not all(all(r["equal"].values()) for r in rows):
        raise AssertionError(f"{cfg.name}: a kernel at the family run's "
                             "shapes disagrees with its plain version")
    return rows


def _family_sched(cfg, params, dev, prompts, news):
    """`SlotScheduler` over ``prompts`` with staggered arrivals: each
    request's tokens equal the scheduler's own engine run alone."""
    import torch
    from repro_torch.serve import Request, SlotScheduler

    sched = SlotScheduler(cfg, params, device=dev, **FAMILY_SCHED)
    solo = [sched.engine.generate([p], max_new_tokens=m)[0]
            for p, m in zip(prompts, news)]
    reqs = [Request(p, m, arrival=4 * i)
            for i, (p, m) in enumerate(zip(prompts, news))]
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if got != solo:
        raise AssertionError(f"{cfg.name}: scheduled tokens differ from "
                             "the solo engine's")
    st = sched.stats
    return {"requests": len(reqs), "new_tokens": st["new_tokens"],
            "chunks": st["chunks"], "replays": sched.chunk_replays,
            "captures": sched.chunk_captures, "wall_s": wall,
            "pool_bytes": st["pool_bytes"]}


def phase_families(dev, runs=FAMILY_RUNS, lanes=8, get_config=None):
    """Every row of ``runs`` served at its widths; hymba's two runs share
    their weights, and the fused run's prefill logits stay within the
    reference's int8 quantization check (relative error below 0.35) of
    the bf16 run's; mamba2 is also served by `SlotScheduler`.  Returns
    one record a run."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    if get_config is None:
        from repro_torch.configs.base import get_config
    out, params, shared = [], None, None
    for label, arch, layers, over, smax, lens, new in runs:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, **over)
        if shared != arch:
            params = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            params = T.make_params(cfg, torch.Generator(device=dev)
                                   .manual_seed(0), device=dev)
            shared = arch
        else:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        weights = sum(t.numel() * t.element_size()
                      for _, t in T.cache_leaves(params))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
        t0 = time.perf_counter()
        rec = _family_serve(label, cfg, params, dev, lanes, smax, prompts,
                            new, invariance=not cfg.moe)
        rec["weight_bytes"] = weights
        rec["cut"] = (f"{layers} of {get_config(arch).num_layers} layers"
                      if layers is not None else None)
        if over:
            base = next(r for r in out if r["arch"] == cfg.name)
            rel = float((rec["logits"] - base["logits"]).abs().max()
                        / (base["logits"].abs().max() + 1e-9))
            rec["rel_err_vs_bf16"] = rel
            if not rel < 0.35:
                raise AssertionError(f"{label}: prefill logits {rel:.3f} "
                                     "from the bf16 run's (bound 0.35)")
        if cfg.ssm and not cfg.hybrid:
            rec["sched"] = _family_sched(cfg, params, dev, prompts,
                                         [new // 2, new, new // 4, new])
        torch.cuda.synchronize()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["seconds"] = time.perf_counter() - t0
        out.append(rec)
    params = None
    torch.cuda.empty_cache()
    for rec in out:
        del rec["logits"]
    return out


def phase_zoo_check(dev, names=ZOO, get_smoke_config=None):
    """Each zoo smoke twin on the card against the same model on the CPU:
    a left-padded prefill and four decode steps fed the CPU's greedy
    tokens (embeds for the embeddings frontend); returns {name: (max
    |diff|, bound)}."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    if get_smoke_config is None:
        from repro_torch.configs.base import get_smoke_config
    res = {}
    for name in names:
        cfg = get_smoke_config(name)
        params = T.make_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
        rng = np.random.default_rng(1)
        pad = torch.tensor([0, 5, 11], dtype=torch.int32)
        if cfg.frontend == "embeddings":
            e = torch.from_numpy(rng.standard_normal(
                (3, 20, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
            pre, steps = {"embeds": e[:, :16]}, [
                {"embeds": e[:, t:t + 1]} for t in range(16, 20)]
        else:
            pre = {"tokens": torch.from_numpy(
                rng.integers(1, cfg.vocab_size, (3, 16)))}
            steps = None
        logits = {}
        for key, d in (("cpu", "cpu"), ("card", dev)):
            p = _to(params, d)
            seen = []
            with torch.inference_mode():
                lg, cache, S = T.prefill(cfg, p, {**_to(pre, d),
                                                  "pad": pad.to(d)}, 24)
                seen.append(lg.float().cpu())
                for t in range(4):
                    if steps is not None:
                        b = _to(steps[t], d)
                    else:
                        cur = (seen if key == "cpu"
                               else logits["cpu"])[t].argmax(-1)
                        b = {"tokens": cur[:, None].to(d)}
                    pos = S + t
                    lg, cache = T.decode_step(
                        cfg, p, cache, b, pos,
                        positions=(pos - pad).to(d))
                    seen.append(lg.float().cpu())
            logits[key] = seen
        cpu, card = logits["cpu"], logits["card"]
        err = max((a - b).abs().max().item() for a, b in zip(cpu, card))
        bound = ZOO_RTOL * max(a.abs().max().item() for a in cpu)
        if not (all(torch.isfinite(b).all() for b in card) and err <= bound):
            raise AssertionError(f"{name} smoke: card vs CPU logits differ "
                                 f"by {err} > {bound}")
        res[name] = (err, bound)
    return res


def phase_check(smoke_cfg, dev):
    """Smoke model on the card (kernels) vs the CPU (plain versions), each
    through an Engine on its device (which encodes as the config says)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    params = T.make_params(smoke_cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, smoke_cfg.vocab_size, (3, 16)))
    pad = torch.tensor([0, 5, 11], dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        eng = Engine(smoke_cfg, params, smax=24, device=d)
        with torch.inference_mode():
            lg, _, _ = T.prefill(smoke_cfg, eng.params,
                                 {"tokens": toks.to(d), "pad": pad.to(d)},
                                 24)
        out[str(d)] = lg.float().cpu()
    err = (out["cpu"] - out[str(dev)]).abs().max().item()
    return err, bool(torch.isfinite(out[str(dev)]).all())


def phase_chain(d, F, ms, dev):
    """rns_chain_linear on the staged kernels ("pallas") against the fused
    kernel ("pallas_fused") at the full-width MLP shapes, bit for bit; the
    staged run's launches are counted."""
    import torch
    from repro_torch.core.quant import quantize_int8
    from repro_torch.core.rns import basis_for_chain
    from repro_torch.core.rns_linear import rns_chain_linear
    from repro_torch.core.rns_tensor import encode, encode_activation
    from repro_torch.models.layers import silu

    g = torch.Generator(device=dev).manual_seed(2)
    basis = basis_for_chain(F)
    wg, wu = (encode(torch.randn(d, F, generator=g, device=dev) / d ** 0.5,
                     basis) for _ in range(2))
    wd = encode(torch.randn(F, d, generator=g, device=dev) / F ** 0.5, basis)
    res = {"equal": True, "launches": None, "shapes": []}
    for m in ms:
        x = torch.randn(m, d, generator=g, device=dev)
        outs = []
        for backend in ("pallas", "pallas_fused"):
            if backend == "pallas" and res["launches"] is None:
                reset_launches()
            xa = encode_activation(x, basis)
            gf = rns_chain_linear(xa, wg, backend=backend)
            up = rns_chain_linear(xa, wu, emit="residues", backend=backend)
            gq, sg = quantize_int8(silu(gf), dim=-1)
            outs.append(rns_chain_linear(up, wd, gate=gq, gate_scale=sg,
                                         backend=backend))
            torch.cuda.synchronize()
            if backend == "pallas" and res["launches"] is None:
                res["launches"] = read_launches()
        same = torch.equal(outs[0], outs[1])
        res["equal"] &= same
        res["shapes"].append({"M": m, "K": d, "F": F, "equal": same})
    want = dict.fromkeys(COUNTED, 0)
    want.update(rns_forward=3, rns_matmul=3, rns_reverse=3, rns_modmul=1)
    if res["launches"] != want:
        raise AssertionError(f"staged chain launches {res['launches']}, "
                             f"expected {want}")
    return res


# ------------------------------------------------------------------ train --
# The training path of rns-smollm-135m-fused at full width: the CLI's code
# path (`launch.train.build`) through `TrainLoop`, AdamW, seed 0.
TRAIN_ARGS = ["--arch", ARCH, "--steps", "30", "--batch", "8", "--seq",
              "256", "--lr", "1e-3", "--warmup", "5", "--seed", "0",
              "--ckpt-every", "30"]
# The CPU tests' bounds of a train step's loss and gradients against the
# reference (tests/test_torch_train.py), here card vs CPU.
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL = 3e-3, 0.05


def _train_dir(name):
    path = os.path.join(ROOT, "build", "chip_smoke", "train", name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def _tree_bytes(tree):
    from repro_torch.train.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def phase_train_kernels(layer_shapes, M, dev, smi):
    """`rns_fused_matmul` in its live raw-int8 form at the training shapes
    (M = batch·seq rows, bf16 activations), bit for bit against the plain
    version, timed over cold weight copies against its bound and one bf16
    `torch.matmul` of the shape."""
    import torch
    from repro_torch.core.quant import quant_scale, quantize_int8
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.kernels import ref, rns_fused_matmul

    g = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for k, n in sorted({(k, n) for _, k, n, _ in layer_shapes}):
        x = torch.randn(M, k, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
        wq, sw = quantize_int8(w, dim=0)
        sx = quant_scale(x)
        basis = basis_for_int8_matmul(k)
        C = len(basis.moduli)
        got = rns_fused_matmul(x, wq, basis, scale_row=sx, scale_col=sw)
        want = ref.rns_fused_matmul_ref(x, wq, basis, scale_row=sx,
                                        scale_col=sw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = 0.0 if same else (got - want).abs().max().item()
        pool = _copies(lambda: torch.randint(-127, 128, (k, n),
                                             dtype=torch.int8, device=dev),
                       k * n)

        def launch(i):
            rns_fused_matmul(x, pool[i], basis, scale_row=sx, scale_col=sw)

        ms = device_ms(launch, len(pool))
        plain = time_ms(lambda i: ref.rns_fused_matmul_ref(
            x, wq, basis, scale_row=sx, scale_col=sw), reps=5, warmup=1)
        lib = device_ms(*_bf16_matmul((M, k), k, n, g, dev))
        nbytes = 2 * M * k + 4 * M + k * n + 4 * n + 4 * M * n
        b, by = bound_ms(nbytes, 2 * C * M * k * n)
        rows.append({"kernel": "rns_fused_matmul", "M": M, "K": k, "N": n,
                     "weights": "live", "C": C, "equal": same,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b, "bound_by": by})
        print(f"train: rns_fused_matmul live M={M} K={k} N={n} C={C} "
              f"equal={same} {1e3 * ms:.1f} us, plain {plain:.3f} ms, bf16 "
              f"torch.matmul {1e3 * lib:.1f} us, bound {1e3 * b:.2f} us "
              f"({by}) | on {smi}")
        del pool
    by_shape = {(r["K"], r["N"]): r for r in rows}
    layer = {key: sum(by_shape[(k, n)][key] for _, k, n, _ in layer_shapes)
             for key in ("ms", "library_ms", "bound_ms")}
    print(f"train: one layer's {len(layer_shapes)} tile launches at M={M}: "
          f"{1e3 * layer['ms']:.1f} us, bf16 torch.matmul "
          f"{1e3 * layer['library_ms']:.1f} us, bound "
          f"{1e3 * layer['bound_ms']:.1f} us; a step under remat full "
          f"launches each twice | on {smi}")
    return rows


def _traced_step(step, params, state, batch, n):
    """One profiled train step: wall and device busy time, the longest
    kernels and the tile kernel's share of busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = step(params, state, batch, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    del out
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    top = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in kernels), reverse=True)[:8]
    tile = sum(e.self_device_time_total for e in kernels
               if "rns_tile_kernel" in e.key)
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (1e6 * wall),
            "tile_share_of_busy": tile / busy if busy else 0.0,
            "top_device": [{"us": u, "name": k[:80], "count": c}
                           for u, k, c in top if u > 0]}


def _grads_on(cfg, params, batch):
    from repro_torch.train.trainstep import _value_and_grad
    from repro_torch.train.tree import leaves

    loss, _, grads = _value_and_grad(cfg, params, batch)
    return loss, leaves(grads)


def _layer_grads(cfg, params, batch):
    """(loss, gradients) of one step, each stacked block leaf split into
    its layers' slices."""
    from repro_torch.train.trainstep import _value_and_grad
    from repro_torch.train.tree import leaves

    loss, _, grads = _value_and_grad(cfg, params, batch)
    out = []
    for k in sorted(grads):
        for t in leaves({k: grads[k]}):
            out.extend(t.unbind(0) if k == "blocks" else [t])
    return loss, out


def phase_train_grads(cfg, params, batch, smi):
    """One full-width train step's loss and gradients through the kernel
    (remat none): every layer's slice of every gradient leaf finite and
    not all zero, and within the CPU tests' bounds of the same step with
    each fused launch replaced by its plain version,
    `ref.rns_fused_matmul_ref`, on the same card."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rns_fused as rf

    cfg = dataclasses.replace(cfg, remat_policy="none")
    reset_launches()
    loss_k, g_k = _layer_grads(cfg, params, batch)
    launched = read_launches()["rns_fused_matmul"]
    kernel = rf.rns_fused_matmul

    def plain(x, w, basis, *, scale_row, scale_col):
        return ref.rns_fused_matmul_ref(x, w, basis, scale_row=scale_row,
                                        scale_col=scale_col)

    rf.rns_fused_matmul = plain
    try:
        reset_launches()
        loss_p, g_p = _layer_grads(cfg, params, batch)
        plain_launched = read_launches()["rns_fused_matmul"]
    finally:
        rf.rns_fused_matmul = kernel
    torch.cuda.synchronize()
    bad = [i for i, g in enumerate(g_k)
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    loss_err = abs(float(loss_k) - float(loss_p))
    errs = [(a.float() - b.float()).abs().max().item()
            / max(b.float().abs().max().item(), 1e-30)
            for a, b in zip(g_k, g_p)]
    equal = sum(torch.equal(a, b) for a, b in zip(g_k, g_p))
    print(f"train: full-width step's gradients, kernel vs plain version: "
          f"{len(g_k)} leaf slices (a layer each), {equal} bit-equal, max rel err "
          f"{max(errs):.3g}, loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
          f"(|err| {loss_err:.3g}); {launched} fused launches vs "
          f"{plain_launched} | on {smi}")
    if bad or launched != 7 * cfg.num_layers or plain_launched:
        raise AssertionError(f"full-width gradients: slices {bad} not finite "
                             f"or all zero; launches {launched} kernel, "
                             f"{plain_launched} plain")
    if not (loss_err <= TRAIN_LOSS_ATOL and max(errs) <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"full-width step kernel vs plain version: loss "
                             f"{loss_err}, gradient {max(errs)}")
    return {"leaves": len(g_k), "bit_equal_leaves": equal,
            "grad_rel_err": max(errs), "loss_err": loss_err,
            "loss": float(loss_k)}


def phase_train_embed(dev, smi, cases=((2048, 2000), (32768, 20000))):
    """The embedding lookup's deterministic backward (`layers.embed_rows`:
    a one-hot float64 matmul a block of distinct ids, work of order
    distinct ids × tokens × width) on the card at smollm-135m's table,
    ``tokens`` ids of which ``distinct`` differ, against one `index_add_`
    (atomics) of the same rows; equal within a bf16 rounding."""
    import torch
    from repro_torch.models.layers import embed_rows

    g = torch.Generator(device=dev).manual_seed(5)
    table = (torch.randn(49152, 576, generator=g, device=dev) / 24).to(
        torch.bfloat16).requires_grad_()
    rows = []
    for tokens, distinct in cases:
        pick = torch.randperm(49152, generator=g, device=dev)[:distinct]
        ids = torch.cat([pick, pick[torch.randint(
            0, distinct, (tokens - distinct,), generator=g, device=dev)]])
        ids = ids[torch.randperm(tokens, generator=g, device=dev)]
        y = embed_rows(table, ids)
        gy = torch.randn(y.shape, generator=g, device=dev).to(torch.bfloat16)

        def backward(i):
            return torch.autograd.grad(y, table, gy, retain_graph=True)[0]

        def library(i):
            return torch.zeros(table.shape, dtype=torch.float32,
                               device=dev).index_add_(0, ids, gy.float())

        ms = time_ms(backward, reps=5, warmup=1)
        lib = time_ms(library, reps=5, warmup=1)
        got, want = backward(0).float(), library(0)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not err <= 2 ** -8 * scale:
            raise AssertionError(f"embedding backward at {tokens} tokens: "
                                 f"{err} off index_add_ ({scale})")
        n = int(torch.unique(ids).numel())
        rows.append({"tokens": tokens, "distinct": n, "ms": ms,
                     "library_ms": lib, "max_abs_err": err})
        print(f"train: embedding backward (one-hot float64) {tokens} tokens, "
              f"{n} distinct ids, width 576: {ms:.3f} ms, index_add_ "
              f"{lib:.3f} ms, |diff| {err:.3g} | on {smi}")
        del y, gy
    return rows


def phase_train_smoke(dev):
    """One train step's loss and gradients of three smoke twins on the card
    and on the CPU (plain versions), within the CPU tests' bounds; fused
    and staged bit-equal on the card."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import tree_map

    out = {}
    for arch in (ARCH, STAGED, "smollm-135m"):
        cfg = get_smoke_config(arch)
        cpu = T.make_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        b = batch_for_step(0, 0, 4, 64, cfg.vocab_size)
        cb = {k: torch.from_numpy(v) for k, v in b.items()}
        loss_c, g_c = _grads_on(cfg, cpu, cb)
        loss_d, g_d = _grads_on(cfg, tree_map(lambda t: t.to(dev), cpu),
                                {k: v.to(dev) for k, v in cb.items()})
        loss_err = abs(float(loss_d) - float(loss_c))
        grad_err = max((d.cpu().float() - c.float()).abs().max().item()
                       / max(c.float().abs().max().item(), 1e-30)
                       for d, c in zip(g_d, g_c))
        if not (loss_err <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"{arch} smoke train step card vs CPU: loss "
                                 f"{loss_err}, gradient {grad_err}")
        out[arch] = {"loss_err": loss_err, "grad_rel_err": grad_err,
                     "loss": loss_d, "grads": g_d}
    fused, staged = out[ARCH], out[STAGED]
    if not (torch.equal(fused["loss"], staged["loss"]) and all(
            torch.equal(a, b) for a, b in zip(fused["grads"],
                                              staged["grads"]))):
        raise AssertionError("smoke train step: fused and staged differ on "
                             "the card")
    return {a: {"loss_err": v["loss_err"], "grad_rel_err": v["grad_rel_err"]}
            for a, v in out.items()}


def phase_train_ste(dev):
    """gx through an encoded weight on the card bit-equal to gx through
    x @ ŵ, ŵ from the plain reverse; the output's node is the estimator's."""
    import torch
    from repro_torch.core.conversion_plan import ConversionPlan
    from repro_torch.core.rns_linear import rns_dense
    from repro_torch.core.rns_tensor import encode

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(2048, 576, generator=g, device=dev)
    w = torch.randn(576, 1536, generator=g, device=dev) / 24
    c = torch.randn(2048, 1536, generator=g, device=dev)
    wt = encode(w)
    xe = x.clone().requires_grad_()
    y = rns_dense(xe, wt, "pallas_fused")
    node = type(y.grad_fn).__name__
    (y * c).sum().backward()
    w_hat = ConversionPlan.for_basis(wt.basis).reverse_plain(wt.residues) \
        * wt.scale
    xr = x.clone().requires_grad_()
    ((xr @ w_hat) * c).sum().backward()
    torch.cuda.synchronize()
    if node != "_EncodedSTEBackward" or not torch.equal(xe.grad, xr.grad):
        raise AssertionError(f"encoded STE on the card: node {node}, gx "
                             f"equal {torch.equal(xe.grad, xr.grad)}")
    return {"node": node, "equal": True}


def phase_train(layer_shapes, dev, smi, turns=3):
    """The `train` phase (see the module docstring)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import tune
    from repro_torch.launch import train as cli
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.train.tree import leaves

    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = round(time.perf_counter() - t0 - sum(parts.values()), 1)

    args = cli.parser().parse_args(TRAIN_ARGS + ["--workdir",
                                                 _train_dir("fused")])
    M = args.batch * args.seq
    sweeps = tune.stats["sweeps"]
    rows = phase_train_kernels(layer_shapes, M, dev, smi)
    torch.cuda.empty_cache()
    part("kernel rows")
    cfg, loop = cli.build(args)
    batch_fn = loop.batch_fn
    opt = cli.make_optimizer(cfg, total_steps=args.steps, base_lr=args.lr,
                             warmup=args.warmup)
    # warm-up (untimed) and the launch gates: one step under each policy
    per_step = {}
    for pol in ("full", "none"):
        s = make_train_step(dataclasses.replace(cfg, remat_policy=pol), opt)
        reset_launches()
        out = s(loop.params, loop.opt_state, batch_fn(0), 0)
        torch.cuda.synchronize()
        per_step[pol] = read_launches()
        del out
    want = {"full": 14 * cfg.num_layers, "none": 7 * cfg.num_layers}
    for pol, got in per_step.items():
        others = {k: v for k, v in got.items()
                  if k != "rns_fused_matmul" and v}
        if got["rns_fused_matmul"] != want[pol] or others:
            raise AssertionError(f"train step under remat {pol}: launches "
                                 f"{got}, want {want[pol]} fused and no "
                                 "other port kernel")
    swept = tune.stats["sweeps"] - sweeps
    part("launch gates")
    grads = phase_train_grads(cfg, loop.params, batch_fn(0), smi)
    torch.cuda.empty_cache()
    part("gradients")

    # the 30-step run through the CLI's loop; the state after its first 4
    # steps is kept for the resume gate
    step, after4 = loop.train_step, {}

    def kept(params, state, batch, n):
        out = step(params, state, batch, n)
        if n == 3:
            after4["state"] = [t.clone() for t in leaves(out[:2])]
        return out

    loop.train_step = kept
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    res = loop.run(args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    run_peak = torch.cuda.max_memory_allocated() - base + _tree_bytes(
        loop.params) + _tree_bytes(loop.opt_state)
    losses = res["losses"]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    summary = cli.summary(cfg, args, res)
    if len(losses) != args.steps or not last < first - 0.3:
        raise AssertionError(f"training did not lower the loss by 0.3: "
                             f"{first:.4f} -> {last:.4f} over {len(losses)} "
                             "steps")
    if launches["rns_fused_matmul"] != args.steps * want["full"]:
        raise AssertionError(f"30-step run launches {launches}")
    part("30 steps")

    # bf16 smollm-135m on the same data, a step of each in turns; a step's
    # peak memory is its transient peak over what was allocated before it
    # plus its own parameters and optimizer state
    bcfg = get_config("smollm-135m")
    bparams = T.make_params(bcfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    bopt = cli.make_optimizer(bcfg, total_steps=args.steps, base_lr=args.lr,
                              warmup=args.warmup)
    runs = {"fused": (step, loop.params, loop.opt_state, batch_fn),
            "bf16": (make_train_step(bcfg, bopt), bparams,
                     bopt.init(bparams),
                     cli.make_batch_fn(bcfg, args.seed, args.batch, args.seq,
                                       dev))}
    times = {k: [] for k in runs}
    peaks = dict.fromkeys(runs, 0)
    runs["bf16"][0](*runs["bf16"][1:3], runs["bf16"][3](0), 0)   # warm-up
    for r in range(2 * turns):
        for k in (("fused", "bf16") if r % 2 == 0 else ("bf16", "fused")):
            s, p, st, b = runs[k]
            batch = b(args.steps + r)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = s(p, st, batch, args.steps + r)
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t))
            peaks[k] = max(peaks[k], torch.cuda.max_memory_allocated()
                           - base + _tree_bytes((p, st)))
            del out
    ms = {k: statistics.median(v) for k, v in times.items()}
    trace = _traced_step(step, loop.params, loop.opt_state, batch_fn(1), 1)
    del runs, bparams
    torch.cuda.empty_cache()
    part("turns + trace")

    # resume at full width: 2 steps, a checkpoint, a new loop that resumes
    # and 2 more steps == the run's first 4 steps (parameters and both
    # moments bit for bit)
    def fresh(every):
        a = cli.parser().parse_args(TRAIN_ARGS + [
            "--workdir", os.path.join(ROOT, "build", "chip_smoke", "train",
                                      "resume"), "--ckpt-every", str(every)])
        return cli.build(a)[1]

    _train_dir("resume")
    fresh(2).run(2)
    resumed = fresh(2)
    start = resumed.start_step
    resumed.run(4)
    same = start == 2 and all(
        torch.equal(a, b) for a, b in zip(
            leaves((resumed.params, resumed.opt_state)), after4["state"]))
    if not same:
        raise AssertionError(f"resumed run (from step {start}) differs from "
                             "the straight run")
    del resumed, after4["state"]
    torch.cuda.empty_cache()
    part("resume")

    smoke = phase_train_smoke(dev)
    ste = phase_train_ste(dev)
    embed = phase_train_embed(dev, smi)
    part("smoke + ste + embed")

    # train -> serve: the trained weights and the same weights restored from
    # the run's checkpoint give the same greedy tokens (scan engine)
    last_ckpt = ckpt.latest_step(loop.ckpt_dir)
    (restored, _), _ = ckpt.restore(loop.ckpt_dir, last_ckpt,
                                    (loop.params, loop.opt_state))
    prompts = [[int(t) for t in batch_fn(99)["tokens"][i, :n]]
               for i, n in enumerate((5, 17, 38, 60))]
    toks = []
    for p in (loop.params, restored):
        eng = Engine(cfg, p, smax=128, lanes=8, device=dev)
        toks.append(eng.generate(prompts, max_new_tokens=8, engine="scan"))
        del eng
    if last_ckpt != args.steps - 1 or toks[0] != toks[1]:
        raise AssertionError(f"served tokens of the trained and the restored "
                             f"weights differ (checkpoint {last_ckpt})")
    part("serve")
    return {"rows": rows, "summary": summary, "losses": losses,
            "first5": first, "last5": last, "launches": launches,
            "per_step": per_step, "sweeps": swept, "wall_s": wall,
            "ms_per_step": ms, "step_times_ms": times,
            "tokens_per_s": {k: M / (v / 1e3) for k, v in ms.items()},
            "peak_bytes": peaks, "run_peak_bytes": run_peak, "trace": trace,
            "resume_equal": same, "grads": grads, "smoke": smoke,
            "ste": ste, "embed_backward": embed,
            "serve_tokens": toks[0], "checkpoint_step": last_ckpt,
            "seconds": parts}


# --------------------------------------------------------------- analysis --
ANALYSIS_SMAX = 128              # the serve phase's cache length
TRAIN_SHAPE = (8, 256)           # the train phase's (batch, seq)
MEMORY_RTOL = 0.25               # meta peak estimate vs the card's peak


def _summarized(fn):
    """(fn's result, the residency pass's `TraceSummary` of it, flops
    counted)."""
    from repro_torch.analysis.residency import TraceMode

    with TraceMode(flops=True) as mode:
        out = fn()
    return out, mode.summary


def _counted(summ):
    """(float flops, int8 ops) a trace counts: the aten ops' flops outside
    the kernels plus flash attention's, and the integer kernels' ops."""
    from repro_torch.launch.dryrun import FLOAT_KERNELS

    flops = sum(summ.flops.values()) + sum(
        summ.kernel_ops.get(k, 0.0) for k in FLOAT_KERNELS)
    return flops, sum(v for k, v in summ.kernel_ops.items()
                      if k not in FLOAT_KERNELS)


def _analytic(cfg, shape):
    from repro_torch.launch.costs import analytic_cost

    return analytic_cost(cfg, shape, n_pods=1, data=1, model=1)


MESH_ARCHS = ("rns-smollm-135m-pallas", "rns-smollm-135m-fused")
MESH_JOBS = 2                          # worker processes of the mesh cells


def _dryrun_start():
    """Start the dry runs in worker processes, each in a session of its
    own: every registered config × SHAPES on one card (``build/chip_smoke/
    dryrun.jsonl``), and the reference's two archs (`MESH_ARCHS`) × SHAPES
    on the 16×16 and 2×16×16 meshes as DTensor programs over a fake
    process group (``dryrun_mesh.jsonl``; each + ".log").  Their meta ops
    cost host time only: they run beside the kernel build and the
    device-timed kernel rows, `_dryrun_wait` ends them before the first
    host-timed phase, and an exit of this script stops them
    (`_dryrun_stop`)."""
    import atexit

    out = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    jobs = max(1, min(8, (os.cpu_count() or 2) - 2) - MESH_JOBS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    dry = {"t0": time.perf_counter()}
    for key, args, n in (
            ("one", ["--all"], jobs),
            ("mesh", ["--arch", ",".join(MESH_ARCHS), "--both-meshes"],
             MESH_JOBS)):
        path = os.path.join(out, "dryrun.jsonl" if key == "one"
                            else "dryrun_mesh.jsonl")
        if os.path.exists(path):
            os.remove(path)
        with open(path + ".log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--jobs", str(n), "--out", path], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
        atexit.register(_dryrun_stop, proc)
        dry[key] = {"proc": proc, "jobs": n, "path": path}
    return dry


def _dryrun_stop(proc):
    """Kill a dry run and its workers (its whole session) if it runs."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _dryrun_wait(dry):
    """Wait for both dry runs (at most 900 s from their start; then they
    are killed): each one's exit code and wall seconds go into ``dry``."""
    for key in ("one", "mesh"):
        run = dry[key]
        left = max(1.0, 900 - (time.perf_counter() - dry["t0"]))
        try:
            run["rc"] = run["proc"].wait(timeout=left)
        except subprocess.TimeoutExpired:
            run["rc"] = "killed after 900 s"
        finally:
            _dryrun_stop(run["proc"])
        run["seconds"] = time.perf_counter() - dry["t0"]


def _served_residency(arch, dev, lanes, smi):
    """One eager prefill and one eager decode step of a served config at
    full width, each under the residency pass: kernel calls by wrapper ==
    `residency.expected_*`, no host sync in the step, no remainder outside
    a kernel on the resident path; the counted work beside the analytic
    model's."""
    import numpy as np
    import torch
    from repro_torch.analysis import residency as R
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    cfg = get_config(arch)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 17, 38, 60)]
    eng = Engine(cfg, params, smax=ANALYSIS_SMAX, lanes=lanes, device=dev)
    batch, plen = eng._pack(prompts)
    tok = torch.ones((batch["tokens"].shape[0], 1), dtype=torch.int32,
                     device=dev)
    with torch.inference_mode():
        (_, cache, _), pre = _summarized(
            lambda: T.prefill(cfg, eng.params, batch, eng.smax))
        _, dec = _summarized(lambda: T.decode_step(
            cfg, eng.params, cache, {"tokens": tok}, plen,
            positions=plen - batch["pad"]))
    torch.cuda.synchronize()
    want = {"decode": R.kernel_calls(R.expected_step(cfg)),
            "prefill": R.kernel_calls(R.expected_prefill(cfg))}
    got = {"decode": dict(dec.kernel_calls), "prefill": dict(pre.kernel_calls)}
    if got != want:
        raise AssertionError(f"{arch}: kernel calls {got}, expected {want}")
    sync = R.check_no_callbacks(dec, subject=f"{arch} decode")
    if not sync.ok:
        raise AssertionError(str(sync.findings))
    stray = {k: v.count_outside(R.MODULAR_OPS)
             for k, v in (("decode", dec), ("prefill", pre))}
    if cfg.linear_spec.domain == "residue":
        for k, v in (("decode", dec), ("prefill", pre)):
            rep = R.check_resident(v, subject=f"{arch} {k}")
            if not rep.ok:
                raise AssertionError(str(rep.findings))
    B = batch["tokens"].shape[0]
    shapes = {"decode": ShapeConfig("decode", ANALYSIS_SMAX, B, "decode"),
              "prefill": ShapeConfig("prefill", plen, B, "prefill")}
    work = {}
    for k, summ in (("decode", dec), ("prefill", pre)):
        an = _analytic(cfg, shapes[k])
        flops, int8 = _counted(summ)
        work[k] = {"counted_flops": flops, "counted_int8_ops": int8,
                   "analytic_flops": an.flops,
                   "analytic_int8_ops": an.flops_int8,
                   "ops_outside": sum(summ.outside.values()),
                   "ops_inside": sum(summ.inside.values())}
    print(f"residency: {arch} {cfg.num_layers} layers, {B} lanes, one eager "
          f"step on the card under the dispatch trace | kernel calls: "
          f"decode {got['decode']}, prefill {got['prefill']} (== "
          f"residency.expected_*) | host syncs in the decode step "
          f"{dict(dec.syncs)} | remainder/fmod outside kernels: decode "
          f"{stray['decode']}, prefill {stray['prefill']} | aten ops "
          f"outside/inside kernels: decode {work['decode']['ops_outside']}/"
          f"{work['decode']['ops_inside']}")
    for k in ("prefill", "decode"):
        w = work[k]
        print(f"costs: {arch} {k} ({shapes[k].global_batch} x "
              f"{shapes[k].seq_len}): counted float flops "
              f"{w['counted_flops']:.4e}, int8 ops "
              f"{w['counted_int8_ops']:.4e} | analytic flops "
              f"{w['analytic_flops']:.4e}, int8 ops "
              f"{w['analytic_int8_ops']:.4e}")
    del eng, params, cache
    torch.cuda.empty_cache()
    return {"kernel_calls": got, "syncs": dict(dec.syncs),
            "stray_modular": stray, "work": work,
            "shapes": {k: [v.global_batch, v.seq_len] for k, v in
                       shapes.items()}}


def _train_residency(dev):
    """One full-width train step of `ARCH` (B 8 × S 256, remat full): its
    kernel calls under the residency pass (forward and the recompute in
    the backward) == `residency.expected_train_step`, and its peak device
    memory beside the dry run's meta estimate of the same step."""
    import torch
    from repro_torch.analysis import residency as R
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import train as cli
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import transformer as T
    from repro_torch.train.trainstep import make_train_step

    cfg = get_config(ARCH)
    B, S = TRAIN_SHAPE
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = cli.make_optimizer(cfg, total_steps=30, base_lr=1e-3, warmup=5)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = cli.make_batch_fn(cfg, 0, B, S, dev)(0)
    step(params, state, batch, 0)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(params, state, batch, 0)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base
            + _tree_bytes((params, state, batch)))
    del out
    out, summ = _summarized(lambda: step(params, state, batch, 0))
    torch.cuda.synchronize()
    del out
    want = R.kernel_calls(R.expected_train_step(cfg))
    if dict(summ.kernel_calls) != want:
        raise AssertionError(f"train step kernel calls "
                             f"{dict(summ.kernel_calls)}, expected {want}")
    rec = run_cell(cfg, ShapeConfig(f"train_b{B}_s{S}", S, B, "train"))
    if rec["status"] != "ok" or rec["kernel_calls"] != want:
        raise AssertionError(f"meta train cell: {rec.get('error')} "
                             f"{rec.get('kernel_calls')}")
    est = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    flops, int8 = _counted(summ)
    an = _analytic(cfg, ShapeConfig("train", S, B, "train"))
    del params, state, batch
    torch.cuda.empty_cache()
    return {"kernel_calls": dict(summ.kernel_calls), "syncs": dict(summ.syncs),
            "peak_bytes": peak, "meta_estimate_bytes": est,
            "meta_argument_bytes": rec["memory"]["argument_bytes"],
            "meta_temp_bytes": rec["memory"]["temp_bytes"],
            "rel_err": abs(est - peak) / peak,
            "counted_flops": flops, "counted_int8_ops": int8,
            "analytic_flops": an.flops, "analytic_int8_ops": an.flops_int8}


def _roofline(cfg, shape, measured_ms):
    """The analytic bound of one step on the H100 constants beside its
    measured time: model flops, bound ms and its dominant term, measured
    ms, bound / measured."""
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as T

    n, na = T.count_params(cfg), T.active_params(cfg)
    rec = {"n_devices": 1, "analytic": _analytic(cfg, shape).as_dict(),
           "model_flops": RL.model_flops_for(cfg, shape, n, na)}
    a = RL.analyze(rec)
    return {"model_flops": rec["model_flops"], "bound_ms": 1e3 * a.bound_s,
            "dominant": a.dominant, "compute_ms": 1e3 * a.compute_s,
            "memory_ms": 1e3 * a.memory_s, "measured_ms": measured_ms,
            "fraction": 1e3 * a.bound_s / measured_ms,
            "model_flops_fraction": rec["model_flops"] / (
                RL.PEAK_FLOPS * measured_ms / 1e3)}


def phase_analysis(dev, smi, serves, train, lanes, dry):
    """The `analysis` phase (see the module docstring); ``dry`` is the dry
    run `_dryrun_start` started and `_dryrun_wait` ended."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config

    t0 = time.perf_counter()
    path, jobs, rc = dry["one"]["path"], dry["one"]["jobs"], dry["one"]["rc"]
    served = {arch: _served_residency(arch, dev, lanes, smi)
              for arch in (ARCH, RESIDENT, STAGED)}
    tr = _train_residency(dev)
    print(f"residency: {ARCH} train step (B {TRAIN_SHAPE[0]} x S "
          f"{TRAIN_SHAPE[1]}, remat full, AdamW) under the dispatch "
          f"trace: kernel calls {tr['kernel_calls']} (== residency."
          f"expected_train_step: forward + recompute) | counted float "
          f"flops {tr['counted_flops']:.4e}, int8 ops "
          f"{tr['counted_int8_ops']:.4e} | analytic flops "
          f"{tr['analytic_flops']:.4e}, int8 ops "
          f"{tr['analytic_int8_ops']:.4e}")
    print(f"dryrun: {ARCH} train step at B {TRAIN_SHAPE[0]} x S "
          f"{TRAIN_SHAPE[1]}: meta estimate (arguments "
          f"{tr['meta_argument_bytes'] / 1e9:.3f} GB + peak live "
          f"{tr['meta_temp_bytes'] / 1e9:.3f} GB) "
          f"{tr['meta_estimate_bytes'] / 1e9:.3f} GB vs the card's peak "
          f"{tr['peak_bytes'] / 1e9:.3f} GB (max_memory_allocated over "
          f"the step + its arguments): {100 * tr['rel_err']:.1f}% off "
          f"(<= {100 * MEMORY_RTOL:.0f}%) | on {smi}")
    if tr["rel_err"] > MEMORY_RTOL:
        raise AssertionError(f"meta memory estimate "
                             f"{tr['meta_estimate_bytes']} vs peak "
                             f"{tr['peak_bytes']}")
    roof = {}
    for arch in (ARCH, RESIDENT, STAGED):
        cfg, sv = get_config(arch), serves[arch]
        B, plen = served[arch]["shapes"]["prefill"]
        roof[f"{arch} prefill"] = _roofline(
            cfg, ShapeConfig("prefill", plen, B, "prefill"),
            sv["prefill_ms"])
        roof[f"{arch} decode (scan)"] = _roofline(
            cfg, ShapeConfig("decode", ANALYSIS_SMAX, B, "decode"),
            sv["decode_ms_per_token_scan"])
    B, S = TRAIN_SHAPE
    roof[f"{ARCH} train step"] = _roofline(
        get_config(ARCH), ShapeConfig("train", S, B, "train"),
        train["ms_per_step"]["fused"])
    for k, r in roof.items():
        print(f"roofline: {k}: model flops {r['model_flops']:.4e} | "
              f"analytic bound {r['bound_ms']:.4f} ms ({r['dominant']}; "
              f"compute {r['compute_ms']:.4f}, memory "
              f"{r['memory_ms']:.4f}) on H100 constants | measured "
              f"{r['measured_ms']:.3f} ms | bound/measured "
              f"{r['fraction']:.4f}, model flops at the bf16 peak / "
              f"measured {r['model_flops_fraction']:.5f} | on {smi}")
    card_s = time.perf_counter() - t0
    if rc != 0:
        with open(path + ".log") as fh:
            raise AssertionError(f"the dry run exited {rc}: "
                                 f"{fh.read()[-2000:]}")
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skip", "error")}
    counts["fits"] = sum(bool(r.get("fits")) for r in recs)
    errors = [f"{r['arch']} x {r['shape']}: {r.get('op')}" for r in recs
              if r["status"] == "error"]
    from repro_torch.configs.base import SHAPES, list_archs
    cells = len(list_archs()) * len(SHAPES)
    print(f"dryrun: {len(recs)} cells (every registered config x SHAPES "
          f"on meta, {jobs} worker processes): ok {counts['ok']}, skip "
          f"{counts['skip']}, error {counts['error']}, fits one 80 GB card "
          f"{counts['fits']}" + (f" | errors: {errors}" if errors else "")
          + f" | {dry['one']['seconds']:.1f} s from its start (beside the build "
          f"and the kernel rows), the phase's card work {card_s:.1f} s")
    if len(recs) != cells or counts["ok"] + counts["skip"] + \
            counts["error"] != cells:
        raise AssertionError(f"the dry run wrote {len(recs)} records for "
                             f"{cells} cells")
    mesh = _dryrun_mesh(dry["mesh"])
    torch.cuda.synchronize()
    return {"served": served, "train": tr, "roofline": roof,
            "dryrun": counts, "dryrun_errors": errors, "dryrun_mesh": mesh,
            "seconds": time.perf_counter() - t0}


def _dryrun_mesh(run):
    """The `dryrun-mesh:` line: the mesh cells' counts and seconds, each
    ``ok`` cell's parameter counts and MODEL_FLOPS held equal to the
    reference's committed cells (`experiments/dryrun.jsonl`, 16×16) and
    its collective bytes beside GSPMD's; fails unless every cell is ``ok``
    or ``skip`` as the reference's are (12 ok, 4 skip)."""
    from repro_torch.configs.base import SHAPES

    if run["rc"] != 0:
        with open(run["path"] + ".log") as fh:
            raise AssertionError(f"the mesh dry run exited {run['rc']}: "
                                 f"{fh.read()[-2000:]}")
    with open(run["path"]) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    with open(os.path.join(ROOT, "experiments", "dryrun.jsonl")) as fh:
        gspmd = {(r["arch"], r["shape"]): r for r in map(json.loads, fh)
                 if r.get("mesh") == "16x16"}
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skip", "error")}
    errors = [f"{r['arch']} x {r['shape']} x {r['mesh']}: {r.get('op')}"
              for r in recs if r["status"] == "error"]
    same, wire = True, []
    for r in recs:
        ref_rec = gspmd.get((r["arch"], r["shape"]))
        if r["status"] != "ok" or ref_rec is None:
            continue
        same &= all(r[k] == ref_rec[k] for k in ("n_params", "n_active",
                                                  "model_flops"))
        if r["mesh"] == "16x16":
            ours = sum(v for k, v in r["collectives"].items()
                       if not k.endswith("_output_bytes"))
            theirs = sum(v for k, v in ref_rec["collectives"].items()
                         if not k.endswith("_output_bytes"))
            wire.append(f"{r['arch'].rsplit('-', 1)[-1]} {r['shape']} "
                        f"{ours / 1e9:.4g} GB vs GSPMD {theirs / 1e9:.4g}")
    cells = len(MESH_ARCHS) * len(SHAPES) * 2
    print(f"dryrun-mesh: {len(recs)} cells ({', '.join(MESH_ARCHS)} x "
          f"SHAPES x 16x16, 2x16x16; DTensor on meta over a fake process "
          f"group, {run['jobs']} worker processes): ok {counts['ok']}, skip "
          f"{counts['skip']}, error {counts['error']}"
          + (f" | errors: {errors}" if errors else "")
          + f" | n_params, n_active, model_flops == experiments/dryrun.jsonl:"
          f" {same} | wire per device at 16x16: " + "; ".join(wire)
          + f" | {run['seconds']:.1f} s from its start, cells "
          f"{sum(r.get('seconds', 0.0) for r in recs):.1f} s in all")
    if (len(recs), counts["ok"], counts["skip"]) != (cells, 12, 4) \
            or not same:
        raise AssertionError(f"mesh dry run: {counts}, {len(recs)} records "
                             f"for {cells} cells, reference counts {same}")
    return dict(counts, seconds=run["seconds"], errors=errors)

# ------------------------------------------------------------- phase dist --
SHARDED = "rns-smollm-135m-sharded"
RESIDENT_SHARDED = "rns-smollm-135m-resident-sharded"
# 4 ragged prompts, bucket 16: a prefill's launches are M = 128 rows (the
# launch cases hold M = 512), so its all-reduces stay small
DIST_PROMPT_LENS = [3, 5, 9, 14]
DIST_NEW_TOKENS = 8                   # the unsharded references' tokens
DIST_SCAN_TOKENS = 2                  # the uncaptured scan run's tokens
DIST_TIMEOUT_S = 240                  # each rank's own deadline
# (group size, layout of its launch cases, its engine runs: (arch,
# layout, greedy tokens of its host generate)); the 5-rank group also
# traces the wire, the 2-rank group reduces the compressed gradients.
# The 5-rank channel run's decode step is 210 all-reduces of ~10 ms on
# one card (PERF.md §5): 3 decode steps hold its tokens and launch count
DIST_GROUPS = ((5, "channel", ((SHARDED, "channel", 4),
                               (RESIDENT_SHARDED, "auto", 8))),
               (2, "column", ((SHARDED, "column", 8),)))


def _dist_cases(cfg):
    """(label, K, N, basis, form) of each distinct full-width linear of
    `-fused` (quantize launches in ``basis_for_int8_matmul(K)``) and of the
    resident chain (residue-in; ``up`` exits in the domain, ``down`` is
    gated; the MLP's in ``basis_for_chain(d_ff)``)."""
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul

    d, f = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    per_k, chain = basis_for_int8_matmul, basis_for_chain(f)
    return [("q/wo", d, qd, per_k(d), "quantize"),
            ("k/v", d, kvd, per_k(d), "quantize"),
            ("gate/up", d, f, per_k(d), "quantize"),
            ("down", f, d, per_k(f), "quantize"),
            ("res qkv", d, qd + 2 * kvd, per_k(d), "residues:float"),
            ("res up", d, f, chain, "residues:residues"),
            ("res down", f, d, chain, "gated")]


def _dist_operands(case, M, dev):
    """Seeded operands of one launch case at M rows: (x, encoded weight,
    the launch's keyword arguments, basis)."""
    import torch
    from repro_torch.core.quant import quant_scale
    from repro_torch.core.rns_tensor import encode, encode_activation

    _, K, N, basis, form = case
    g = torch.Generator(device=dev).manual_seed(7 * K + 13 * N + M)
    x = torch.randn(M, K, generator=g, device=dev)
    wt = encode(torch.randn(K, N, generator=g, device=dev) / math.sqrt(K),
                basis)
    kw = {"scale_col": wt.scale, "gate": None, "emit": "float"}
    if form == "quantize":
        x = x.to(torch.bfloat16)
        kw["scale_row"] = quant_scale(x, dim=-1)
    else:
        x = encode_activation(x, basis)
        kw["scale_row"] = x.scale
        if form == "gated":
            kw["gate"] = torch.randint(-128, 128, (M, K), generator=g,
                                       device=dev, dtype=torch.int8)
            kw["scale_row"] = x.scale * 0.5
        if form == "residues:residues":
            kw["emit"] = "residues"
    return x, wt, kw, basis


def _dist_kernel(case, M, ctx, dev):
    """This rank's part of one sharded case as the sharded engine runs it
    (`rns_shard.rank_launch`): its layout, its kernel (the channel slice's
    `rns_fused_crt_partial`, the column slice's `rns_fused_matmul`, or the
    whole launch when it replicates) and the collective step on the
    kernel's output, as thunks, and the kernel's (bytes, ops)."""
    from repro_torch.core.rns_tensor import RNSTensor
    from repro_torch.dist import rns_shard as rs

    x, wt, kw, basis = _dist_operands(case, M, dev)
    part = rs.rank_launch(x, wt, ctx=ctx, **kw)
    C, (K, N), n = len(basis.moduli), wt.shape, ctx.nshards
    res_in = isinstance(x, RNSTensor)
    # the A operand's bytes (a channel's residues, or the float block),
    # a weight channel's, an output element's
    xbytes = (x.residues if res_in else x).element_size() * M * K
    wbytes = wt.residues.element_size() * K
    out_b = C if kw["emit"] == "residues" else 4
    if part.layout == "channel":
        cl = C // n
        nbytes = xbytes * (cl if res_in else 1) + wbytes * cl * N \
            + 4 * rs.crt_tables(basis)[2] * M * N
        ops = 2.0 * M * K * N * cl
    else:
        nl = N // n if part.layout == "column" else N
        nbytes = xbytes * (C if res_in else 1) + wbytes * C * nl \
            + out_b * M * nl
        ops = 2.0 * M * K * nl * C
    return part.layout, (lambda i=0: part.kernel()), part.finish, nbytes, \
        ops


def _full_basis(case, M, dev):
    """The one-process launch of a case on the full basis, as a thunk."""
    from repro_torch.kernels import rns_fused_matmul

    x, wt, kw, _ = _dist_operands(case, M, dev)
    return lambda i=0: rns_fused_matmul(x, wt, **kw)


def _bits(out):
    """Raw bytes of a launch's output (residues and scale of an RNSTensor)."""
    import torch

    if hasattr(out, "residues"):
        return _bits(out.residues) + _bits(out.scale)
    return out.contiguous().view(-1).view(torch.uint8).cpu().numpy() \
        .tobytes()


def _dist_launches(ctx, dev, cfg):
    """Every launch case at M = 8 and 512 on this rank: bit-equality of the
    sharded launch with the full-basis one, this rank's kernel and the
    full-basis launch in device µs (graph-timed, one rank at a time), the
    collective step's wall µs (every rank together: the all-reduce, and
    the channel layout's CRT finish or the column gather's scatter)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.rns_shard import crt_tables, sharded_fused_matmul

    rows = []
    for case in _dist_cases(cfg):
        for M in (8, 512):
            x, wt, kw, _ = _dist_operands(case, M, dev)
            want = _full_basis(case, M, dev)()
            got = sharded_fused_matmul(x, wt, ctx=ctx, **kw)
            lay, launch, finish, nbytes, ops = _dist_kernel(case, M, ctx,
                                                            dev)
            full = _full_basis(case, M, dev)
            us = full_us = None
            for r in range(ctx.nshards):
                dist.barrier(group=ctx.group)
                if r == ctx.rank:
                    us = 1e3 * device_ms(launch, 10)
                    full_us = 1e3 * device_ms(full, 10)
                    torch.cuda.synchronize()
                dist.barrier(group=ctx.group)
            coll = []
            if lay != "replicate":
                out = launch()
                for i in range(10):
                    # the channel step sums into the kernel's output
                    arg = out.clone() if lay == "channel" else out
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    finish(arg)
                    torch.cuda.synchronize()
                    if i >= 3:
                        coll.append(1e6 * (time.perf_counter() - t0))
            label, K, N, basis, form = case
            rows.append({
                "label": label, "K": K, "N": N, "M": M, "form": form,
                "C": len(wt.moduli), "L1": crt_tables(basis)[2],
                "layout": lay,
                "equal": _bits(got) == _bits(want), "us": us,
                "full_us": full_us,
                "bound_us": 1e3 * bound_ms(nbytes, ops)[0],
                "collective_us": (statistics.median(coll) if coll
                                  else None)})
    return rows


def _dist_int8(ctx, dev, cfg):
    """`rns_int_matmul` on its fused route with raw int8 x (M = 8, one
    smollm gate/up shape, K 576 × N 1536) under this rank's context, live
    and encoded weights, each scale form: every call bit-equal to the
    unsharded launch made on this rank with no context, the layout each
    resolved to, and the raw-int8 launches it made."""
    import torch
    from repro_torch.core.rns_linear import rns_int_matmul
    from repro_torch.core.rns_tensor import RNSTensor
    from repro_torch.dist import context
    from repro_torch.dist.rns_shard import rank_launch
    from repro_torch.kernels import rns_fused_crt_partial, rns_fused_matmul

    M, K, N = 8, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    scales = {"none": None,
              "1n": torch.rand(1, N, generator=g, device=dev) + 0.01,
              "m1": torch.rand(M, 1, generator=g, device=dev) + 0.01,
              "mn": torch.rand(M, N, generator=g, device=dev) + 0.01}
    cases = []
    for wname, wq in (("live", w), ("encoded", RNSTensor.from_int8(w))):
        for sname, sc in scales.items():
            want = rns_int_matmul(x, wq, scale=sc)
            raw = (rns_fused_matmul.raw_launches,
                   rns_fused_crt_partial.raw_launches)
            with context.use(ctx):
                got = rns_int_matmul(x, wq, scale=sc)
            cases.append({
                "weights": wname, "scale": sname,
                "equal": _bits(got) == _bits(want),
                "raw_fused": rns_fused_matmul.raw_launches - raw[0],
                "raw_crt": rns_fused_crt_partial.raw_launches - raw[1]})
    torch.cuda.synchronize()
    return {"M": M, "K": K, "N": N,
            "layout": rank_launch(x, w, ctx=ctx).layout, "cases": cases}


def _dist_engine(arch, layout, tokens, ctx, mesh, dev, ref, wire=False):
    """One sharded Engine run of a full-width config: one prefill (its
    logits against the unsharded ``ref``'s, its launches), then with
    ``wire`` one decode step from its cache under the residency pass
    (`_dist_wire`); the host generate of ``tokens`` tokens (its launches,
    tokens against the first of ``ref``'s) and the uncaptured scan's
    first tokens; a decode step's launches as `dist.engine.
    decode_launches` reads them off the placed weights.  Counts are set
    to 0 just before each counted call."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.dist.engine import decode_launches
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    cfg = get_config(arch)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in DIST_PROMPT_LENS]
    t0 = time.perf_counter()
    eng = Engine(cfg, params, smax=128, lanes=8, device=dev, mesh=mesh,
                 dist_layout=layout)
    batch, _ = eng._pack(prompts)
    reset_launches()
    with torch.inference_mode(), eng._ctx():
        logits, cache, pos0 = T.prefill(cfg, eng.params, batch, eng.smax)
    torch.cuda.synchronize()
    prefill = read_launches()
    out = {"arch": arch, "layout": layout, "nshards": ctx.nshards,
           "logits_equal": _bits(logits) == _bits(ref["logits"])}
    if wire:
        out["wire"] = _dist_wire(eng, ctx, batch, logits, cache, pos0)
    del cache
    reset_launches()
    t1 = time.perf_counter()
    host = eng.generate(prompts, tokens, engine="host")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    gen = read_launches()
    # the uncaptured scan: the first tokens of the host run's
    scan = eng.generate(prompts, DIST_SCAN_TOKENS, engine="scan")

    def cut(outs, n):
        return [o[:len(q) + n] for o, q in zip(outs, prompts)]

    out.update({
        "tokens": tokens,
        "tokens_equal": host == cut(ref["tokens"], tokens)
        and scan == cut(host, DIST_SCAN_TOKENS),
        "captured": eng.captured, "scan_replays": eng.scan_replays,
        "prefill_launches": prefill, "generate_launches": gen,
        "step_launches": {k: (gen[k] - prefill[k]) // (tokens - 1)
                          for k in gen},
        "step_expected": decode_launches(cfg, eng.params),
        "host_s": host_s, "seconds": time.perf_counter() - t0})
    return out


def _dist_wire(eng, ctx, batch, logits, cache, pos0):
    """One sharded decode step of a sharded engine, from its prefill's
    cache, under the residency pass: its collectives by name and operand,
    `check_reduced_wire`, and their ring wire bytes beside the cost
    model's."""
    import torch
    from repro_torch.analysis import check_reduced_wire
    from repro_torch.analysis.residency import TraceMode
    from repro_torch.dist import comms
    from repro_torch.dist.engine import launch_bases
    from repro_torch.dist.rns_shard import crt_tables
    from repro_torch.launch import costs
    from repro_torch.models import transformer as T

    cfg = eng.cfg
    with torch.inference_mode(), eng._ctx():
        cur = torch.argmax(logits, -1)
        with TraceMode() as mode:
            T.decode_step(cfg, eng.params, cache, {"tokens": cur[:, None]},
                          pos0, positions=pos0 - batch["pad"])
        torch.cuda.synchronize()
    summ = mode.summary
    bases = launch_bases(cfg)
    rep = check_reduced_wire(summ, {len(b.moduli) for b in bases},
                             nlimbs={crt_tables(b)[2] for b in bases},
                             subject=f"{cfg.name} decode")
    kinds = sorted({f"{name} {dtype} x{len(shape)}d"
                    for name, ops in summ.collectives
                    for shape, dtype in ops})
    return {"collectives": len(summ.collectives), "kinds": kinds,
            "clean": rep.ok, "findings": [str(f) for f in rep.findings],
            "only_reduced": all(dtype in ("int32", "float32")
                                for _, ops in summ.collectives
                                for _, dtype in ops),
            "kernel_calls": dict(summ.kernel_calls),
            "wire_bytes": comms.collective_wire_bytes(summ, ctx.nshards),
            "model_bytes": costs.comms_bytes_decode(
                cfg, batch["tokens"].shape[0], ndev=ctx.nshards,
                layout=ctx.layout)}


def _dist_compression(ctx, dev, cfg):
    """`compressed_mean_all_reduce` of a gradient tree of the fused model's
    parameter shapes (rank r's drawn from seed 1000 + r), against the same
    formula over every rank's tree computed in this one process."""
    import torch
    from repro_torch.launch.inputs import abstract_params
    from repro_torch.train.compression import (compressed_mean_all_reduce,
                                               dequantize, quantize)

    shapes = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            shapes.append(tuple(node.shape))

    walk(abstract_params(cfg, encoded=False))

    def grads(r):
        g = torch.Generator(device=dev).manual_seed(1000 + r)
        return [torch.randn(s, generator=g, device=dev) * (1.0 + r)
                for s in shapes]

    mine = grads(ctx.rank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_mean_all_reduce(mine, ctx.group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    every = [grads(r) for r in range(ctx.nshards)]
    equal = True
    for i, out in enumerate(got):
        amax = max(torch.amax(torch.abs(g[i])) for g in every)
        qs = [quantize(g[i], amax) for g in every]
        total = sum(q for q, _ in qs[1:]) + qs[0][0]
        want = dequantize(total, qs[0][1], ctx.nshards, out.dtype)
        equal &= _bits(out) == _bits(want)
    return {"leaves": len(shapes), "elements": sum(math.prod(s)
                                                   for s in shapes),
            "equal": equal, "wall_s": wall}


def _dist_rank(rank, n, tmp, layout, runs, device):
    """One rank of a phase-14 group (a spawned process on ``device``,
    cuda:0 on the card): the
    launch cases, the engine runs, and the wire trace (5 ranks) or the
    compressed all-reduce (2 ranks); writes its results as JSON."""
    import datetime
    import traceback

    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        from repro_torch.configs.base import get_config
        from repro_torch.dist.context import DistContext
        from repro_torch.dist.engine import make_context
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(model=n)
        cfg = get_config(SHARDED)
        out = {"rank": rank, "launch": _dist_launches(
            DistContext(mesh=mesh, layout=layout), dev, cfg)}
        out["int8"] = _dist_int8(DistContext(mesh=mesh, layout=layout), dev,
                                 cfg)
        out["engine"] = []
        for arch, lay, tokens in runs:
            ref = torch.load(os.path.join(tmp, f"ref_{arch}.pt"))
            ctx = make_context(get_config(arch), mesh, layout=lay)
            run = _dist_engine(arch, lay, tokens, ctx, mesh, dev, ref,
                               wire=arch == SHARDED and lay == "channel")
            if "wire" in run:
                out["wire"] = run.pop("wire")
            out["engine"].append(run)
            torch.cuda.empty_cache()
        if n == 2:
            out["compression"] = _dist_compression(
                DistContext(mesh=mesh), dev, cfg)
        from repro_torch.dist import comms
        out["transport"] = comms.transport(mesh.group("model"), dev)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _spawn_ranks(n, tmp, layout, runs, device):
    """Start the n ranks of one group and join each with a deadline; any
    rank's failure or lateness fails the phase (the rest are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, n, tmp, layout, runs, device))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S + 60
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = {r: open(os.path.join(tmp, f"rank{r}.err")).read()[-3000:]
            for r in range(n)
            if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
    if late or errs or any(p.exitcode for p in procs):
        raise AssertionError(f"dist: {n}-rank group failed: late ranks "
                             f"{late}, exit codes "
                             f"{[p.exitcode for p in procs]}, errors {errs}")
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def phase_dist(dev, smi):
    """The `dist` phase (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.dist.context import DistContext
    from repro_torch.kernels import tune
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, bucket_plen

    t0 = time.perf_counter()
    cfg = get_config(SHARDED)
    # resolve every rank-0 slice launch once here, alone on the card, so
    # the tuner's sweeps run before the ranks and their rows are table
    # hits there
    sweeps = tune.stats["sweeps"]
    prefill_m = 8 * bucket_plen(cfg, max(DIST_PROMPT_LENS))
    for n, layout, _ in DIST_GROUPS:
        fake = DistContext(mesh=Mesh({"data": 1, "model": n}), layout=layout)
        for case in _dist_cases(cfg):
            for M in (8, prefill_m, 512):
                _dist_kernel(case, M, fake, dev)[1]()
                _full_basis(case, M, dev)()
    torch.cuda.synchronize()
    swept = tune.stats["sweeps"] - sweeps
    # the unsharded references, one per config, on the seed-0 weights
    tmp_root = os.path.join(ROOT, "build", "chip_smoke", "dist")
    shutil.rmtree(tmp_root, ignore_errors=True)
    refs = {}
    for arch in (SHARDED, RESIDENT_SHARDED):
        acfg = get_config(arch)
        params = T.make_params(acfg,
                               torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, acfg.vocab_size, n).tolist()
                   for n in DIST_PROMPT_LENS]
        eng = Engine(acfg, params, smax=128, lanes=8, device=dev)
        refs[arch] = {"tokens": eng.generate(prompts, DIST_NEW_TOKENS,
                                             engine="host"),
                      "logits": eng.prefill_logits(prompts).cpu()}
        del eng, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    groups = {}
    for n, layout, runs in DIST_GROUPS:
        tmp = os.path.join(tmp_root, f"group{n}")
        os.makedirs(tmp)
        for arch, ref in refs.items():
            torch.save(ref, os.path.join(tmp, f"ref_{arch}.pt"))
        t1 = time.perf_counter()
        groups[n] = (_spawn_ranks(n, tmp, layout, runs, str(dev)),
                     time.perf_counter() - t1)
    return {"groups": groups, "sweeps": swept, "ref_s": ref_s,
            "seconds": time.perf_counter() - t0}


def print_dist(res, smi):
    """The `dist:` lines, and the phase's gates: every rank bit-equal, the
    decode step's launches, the wire, the compressed all-reduce."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist import comms

    groups = res["groups"]
    bad = []
    for n, (ranks, secs) in groups.items():
        transport = ranks[0]["transport"]
        for i, row in enumerate(ranks[0]["launch"]):
            rows = [r["launch"][i] for r in ranks]
            equal = all(r["equal"] for r in rows)
            if not equal:
                bad.append(f"launch {row['label']} M={row['M']} on {n}")
            us = [r["us"] for r in rows]
            C, M, N = row["C"], row["M"], row["N"]
            emit = "residues" if row["form"] == "residues:residues" else \
                "float"
            wire = (comms.channel_bytes(M, N, row["L1"], n, emit=emit)
                    if row["layout"] == "channel" else
                    comms.column_bytes(C, M, N, n, emit=emit, itemsize=1)
                    if row["layout"] == "column" else 0.0)
            coll = [r["collective_us"] for r in rows]
            print(f"dist: launch {row['label']} (K {row['K']}, N "
                  f"{row['N']}, C {C}, {row['form']}) M={M} on {n} ranks, "
                  f"{row['layout']}: every rank bit-equal to the full-basis "
                  f"rns_fused_matmul {equal} | rank kernel device us "
                  f"[{', '.join(f'{u:.1f}' for u in us)}] (median "
                  f"{statistics.median(us):.1f}) vs full-basis launch "
                  f"{statistics.median(r['full_us'] for r in rows):.1f} us, "
                  f"bound {row['bound_us']:.2f} us"
                  + (f" | collective step (all-reduce and epilogue) wall "
                     f"us (median of ranks) "
                     f"{statistics.median(coll):.0f}, {wire:.0f} wire bytes "
                     f"a rank (comms model), over {transport}"
                     if row["collective_us"] is not None else
                     " | replicated, no collective")
                  + f" | on {smi}")
        i8 = [r["int8"] for r in ranks]
        ok8 = all(c["equal"] for r in i8 for c in r["cases"]) and all(
            r["layout"] == i8[0]["layout"] for r in i8)
        want_kernel = "raw_crt" if i8[0]["layout"] == "channel" else \
            "raw_fused"
        ok8 &= all(c[want_kernel] == 1 for r in i8 for c in r["cases"])
        if not ok8:
            bad.append(f"rns_int_matmul on {n}")
        print(f"dist: rns_int_matmul raw int8 (M {i8[0]['M']}, K "
              f"{i8[0]['K']}, N {i8[0]['N']}; live and encoded weights; "
              f"scales none, (1, N), (M, 1), (M, N)) on {n} ranks, "
              f"{i8[0]['layout']}: every rank bit-equal to the unsharded "
              f"launch, one raw-int8 "
              f"{'rns_fused_crt_partial' if want_kernel == 'raw_crt' else 'rns_fused_matmul'}"
              f" a call: {ok8} | raw-int8 launches over the ranks "
              f"{sum(c[want_kernel] for r in i8 for c in r['cases'])} "
              f"| on {smi}")
        for j, run in enumerate(ranks[0]["engine"]):
            runs = [r["engine"][j] for r in ranks]
            ok = all(r["tokens_equal"] and r["logits_equal"]
                     and r["captured"] is False for r in runs)
            step = runs[0]["step_launches"]
            if not ok:
                bad.append(f"engine {run['arch']} {run['layout']} on {n}")
            want = run["step_expected"]
            if any({k: r["step_launches"][k] for k in r["step_expected"]}
                   != r["step_expected"] for r in runs):
                bad.append(f"decode step launches {step} on {n} ranks, "
                           f"expected {want}")
            layers = get_config(SHARDED).num_layers
            if run["arch"] == SHARDED and run["layout"] == "channel" and \
                    want != {"rns_fused_crt_partial": 7 * layers,
                             "rns_fused_matmul": 0}:
                bad.append(f"channel decode step {want}: expected 210 "
                           "rns_fused_crt_partial and no rns_fused_matmul")
            print(f"dist: engine {run['arch']} dist_layout="
                  f"{run['layout']} on {n} ranks (processes on one card, "
                  f"gloo), 4 ragged prompts in 8 lanes, {run['tokens']} "
                  f"greedy tokens: tokens (host, and the uncaptured scan's "
                  f"first {DIST_SCAN_TOKENS}, captured="
                  f"{runs[0]['captured']}) and prefill logits "
                  f"bit-equal to the unsharded Engine on every rank {ok} | "
                  f"launches a decode step a rank "
                  f"{ {k: v for k, v in step.items() if v} } (expected "
                  f"{want}), a prefill "
                  f"{ {k: v for k, v in runs[0]['prefill_launches'].items() if v} }"
                  f" | host generate {runs[0]['host_s']:.2f} s, run "
                  f"{runs[0]['seconds']:.1f} s | on {smi}")
        if "wire" in ranks[0]:
            ws = [r["wire"] for r in ranks]
            ok = all(w["clean"] and w["only_reduced"] for w in ws)
            if not ok:
                bad.append(f"wire on {n}: {[w['findings'] for w in ws]}")
            w = ws[0]
            print(f"dist: wire {SHARDED} channel, one decode step (8 lanes) "
                  f"under the residency pass on {n} ranks: {w['collectives']}"
                  f" collectives ({', '.join(w['kinds'])}), only limb planes "
                  f"and floats {w['only_reduced']}, check_reduced_wire clean "
                  f"{all(x['clean'] for x in ws)} | kernel calls "
                  f"{w['kernel_calls']} | comms.collective_wire_bytes of the "
                  f"trace {w['wire_bytes']:.0f} B a rank, "
                  f"costs.comms_bytes_decode {w['model_bytes']:.0f} B")
        if "compression" in ranks[0]:
            cs = [r["compression"] for r in ranks]
            if not all(c["equal"] for c in cs):
                bad.append("compression")
            print(f"dist: compression compressed_mean_all_reduce on {n} "
                  f"ranks over {cs[0]['leaves']} gradient leaves of "
                  f"{ARCH}'s parameter shapes ({cs[0]['elements']} "
                  f"elements): bit-equal to the formula on one process "
                  f"{all(c['equal'] for c in cs)} | "
                  f"{max(c['wall_s'] for c in cs):.2f} s over {transport} "
                  f"| on {smi}")
        print(f"dist: {n}-rank group {secs:.1f} s")
    print(f"dist: phase {res['seconds']:.1f} s (tuner sweeps before the "
          f"ranks {res['sweeps']}, unsharded references "
          f"{res['ref_s']:.1f} s)")
    if bad:
        raise AssertionError(f"dist: {bad}")


def _to(node, dev):
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    return node.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", help="write the full record here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is checked on a GPU",
              file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.kernels import tune
    from repro_torch.kernels.rns_fused import TM_WG

    # the tuner reads and writes a copy of the committed H100 table, never
    # the tree or the user's cache
    table = os.path.join(ROOT, "build", "chip_smoke", "tune_torch.json")
    os.makedirs(os.path.dirname(table), exist_ok=True)
    shutil.copy(tune.COMMITTED_TABLE, table)
    os.environ["RNS_TORCH_TUNE_CACHE"] = table

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    d, f, qd, kvd = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim, \
        cfg.num_kv_heads * cfg.head_dim
    L = cfg.num_layers
    # (leaf, K, N, stacked layers) of every encoded linear, in layer order
    layer_shapes = [("wq", d, qd, L), ("wk", d, kvd, L), ("wv", d, kvd, L),
                    ("wo", qd, d, L), ("w_gate", d, f, L), ("w_up", d, f, L),
                    ("w_down", f, d, L)]
    lanes, bucket = 8, 64

    t_start = time.perf_counter()
    marks = {}

    def mark(phase):
        marks[phase] = round(time.perf_counter() - t_start - sum(
            marks.values()), 1)

    dry = _dryrun_start()
    dev_info = phase_device(layer_shapes, lanes, lanes * bucket)
    mark("device")
    dev = torch.device("cuda")
    print("phase kernels:")
    rows, fused_ok, fwd_ok, max_err = phase_kernels(
        layer_shapes, lanes, lanes * bucket, dev)
    # one decode step of one layer: the 7 encoded launches at M = lanes
    fused = _sum([next(r for r in rows if r["kernel"] == "rns_fused_matmul"
                       and r["weights"] == "encoded" and r["M"] == lanes
                       and (r["K"], r["N"]) == (k, n))
                  for _, k, n, _ in layer_shapes])
    fwd = _sum([r for r in rows if r["kernel"] == "rns_forward"])
    staged_shapes = [(name, k, n) for name, k, n, _ in layer_shapes]
    rows2, ok2 = phase_kernels_slice2(staged_shapes, (d, f, qd + 2 * kvd),
                                      lanes, lanes * bucket, dev)

    def pick(kernel, labels):
        return _sum([next(r for r in rows2 if r["kernel"] == kernel
                          and r["label"].startswith(lab + " ")
                          and r.get("M", lanes) == lanes)
                     for lab in labels])

    # per kernel: the launches of one decode step of one layer on its path
    resid = pick("rns_fused_matmul:residue_in", ["qkv", "gate", "up", "down"])
    names = [name for name, _, _ in staged_shapes]
    matmul = pick("rns_matmul", names)
    reverse = pick("rns_reverse", names)
    # the staged chain's launch: int8 operands into int8 residues
    modmul = pick("rns_modmul", [f"M={lanes} F={f} out=int8"])
    edges = phase_edges(dev)
    print(f"edge: rns_forward {edges['rns_forward']} cases, rns_reverse "
          f"{edges['rns_reverse']} cases (every (C, L) instance, with and "
          f"without a scale): all bit-equal to the plain versions")
    convert = convert_sums(rows, rows2, names, (lanes, lanes * bucket))
    print("convert: one layer's conversions (us; bound; torch.remainder): "
          + " | ".join(
              f"{k} {1e3 * v['ms']:.2f}; {1e3 * v['bound_ms']:.2f}"
              + ("" if v["library_ms"] is None
                 else f"; {1e3 * v['library_ms']:.2f}")
              for k, v in convert.items()) + f" | on {dev_info['smi']}")
    mm_rows = [r for r in rows2 if r["kernel"] == "rns_modmul"
               and r["N"] == f]
    print("modmul: the staged chain's gate multiply (7, M·1536) int8, over "
          "operand pairs that outgrow the L2 (us; bound; torch.remainder): "
          + " | ".join(f"M={r['M']} out={r['out']} {1e3 * r['ms']:.2f}; "
                       f"{1e3 * r['bound_ms']:.2f}; "
                       f"{1e3 * r['library_ms']:.2f}" for r in mm_rows)
          + f" | on {dev_info['smi']}")
    print("phase kernels slice 3:")
    qkv_n = qd + 2 * kvd
    rows3, ok3 = phase_kernels_slice3(layer_shapes, (d, f, qkv_n), lanes,
                                      lanes * bucket, dev)
    # per kernel, the launches of its entry path (phase_entries)
    flash_rows = {r["leaf"]: r for r in rows3
                  if r["kernel"] == "flash_attention"
                  and r["dtype"] == "bfloat16"}
    flash = _sum([flash_rows["prefill-pad"], flash_rows["decode-2048"]])
    fold = _sum([r for r in rows3 if r["kernel"] == "fold"
                 and r["C"] == 5 and r["bound"] == 1536 * 46 * 46])
    crt = _sum([r for r in rows3 if r["kernel"] == "rns_fused_crt_partial"
                and r["M"] == lanes and r["slices"] == r["C"]])
    print(f'kernels: ["rns_fused_matmul", "rns_forward", '
          f'"rns_fused_matmul:residue_in", "rns_matmul", "rns_reverse", '
          f'"rns_modmul", "flash_attention", "fold", '
          f'"rns_fused_crt_partial"] pass=[{str(fused_ok).lower()}, '
          f'{str(fwd_ok).lower()}, {str(ok2).lower()}, '
          f'{str(ok3).lower()}] median_ms='
          f'[{fused["ms"]:.4f}, {fwd["ms"]:.4f}, {resid["ms"]:.4f}, '
          f'{matmul["ms"]:.4f}, {reverse["ms"]:.4f}, {modmul["ms"]:.4f}, '
          f'{flash["ms"]:.4f}, {fold["ms"]:.4f}, {crt["ms"]:.4f}] '
          f'(one layer at decode on its path; rns_forward: the 7 encodes '
          f'at init; flash: bf16 prefill + decode at 2048; fold: '
          f'(5, 512x1536); crt: one layer as one-channel slices)')
    if not (fused_ok and fwd_ok and ok2 and ok3):
        raise AssertionError("a kernel disagrees with its plain version")
    dec, pre = flash_rows["decode-2048"], flash_rows["prefill-pad"]
    fold_row = next(r for r in rows3 if r["kernel"] == "fold"
                    and r["C"] == 5 and r["bound"] == 1536 * 46 * 46)
    print(f"flash: bf16 decode-2048 ({dec['route']}) "
          f"{1e3 * dec['ms']:.1f} us, sdpa {1e3 * dec['library_ms']:.1f} "
          f"us, bound {1e3 * dec['bound_ms']:.2f} us | bf16 prefill-pad "
          f"({pre['route']}) {1e3 * pre['ms']:.1f} us, fma pinned in turns "
          f"{1e3 * pre['ms_fma']:.1f} us, sdpa "
          f"{1e3 * pre['library_ms']:.1f} us, bound "
          f"{1e3 * pre['bound_ms']:.2f} us | fold (5, 512x1536) "
          f"{1e3 * fold_row['ms']:.1f} us, torch.remainder "
          f"{1e3 * fold_row['library_ms']:.1f} us, bound "
          f"{1e3 * fold_row['bound_ms']:.2f} us | on {dev_info['smi']}")
    heads = {c[0] for c in FLASH_HEADS}
    print("flash heads: " + " | ".join(
        f"{r['leaf']} {r['dtype']} ({r['route']}) {1e3 * r['ms']:.1f} us"
        + ("" if r["library_ms"] is None
           else f", sdpa {1e3 * r['library_ms']:.1f} us"
           + (f" ({r['sdpa_backend']})" if "sdpa_backend" in r else ""))
        + f", bound {1e3 * r['bound_ms']:.2f} us ({r['bound_by']})"
        for r in rows3 if r["kernel"] == "flash_attention"
        and r["leaf"] in heads) + f" | on {dev_info['smi']}")

    smi = dev_info["smi"]
    decode = per_layer(rows, rows2, layer_shapes, lanes)
    decode["crt"] = dict(crt, launches=sum(
        r["slices"] for r in rows3 if r["kernel"] == "rns_fused_crt_partial"
        and r["M"] == lanes and r["slices"] == r["C"]))
    for path, agg in decode.items():
        what = ("one-channel rns_fused_crt_partial slices" if path == "crt"
                else "tile launches")
        yard = ("rns_fused_matmul on the full basis" if path == "crt"
                else "bf16 torch.matmul")
        print(f"decode: {path} one layer's {agg['launches']} {what} at "
              f"M={lanes}: {1e3 * agg['ms']:.1f} us, {yard} "
              f"{1e3 * agg['library_ms']:.1f} us, bound "
              f"{1e3 * agg['bound_ms']:.2f} us | on {smi}")
    prefill = per_layer(rows, rows2, layer_shapes, lanes * bucket)
    for path, agg in prefill.items():
        tm64 = ("" if "ms_tm64" not in agg else
                f"all 64-row (wgmma) {1e3 * agg['ms_tm64']:.1f} us, ")
        print(f"prefill: {path} one layer's tile launches at M="
              f"{lanes * bucket}: as launched {1e3 * agg['ms']:.1f} us, "
              f"{tm64}all 32-row {1e3 * agg['ms_tm32']:.1f} us, all 16-row "
              f"{1e3 * agg['ms_tm16']:.1f} us, bf16 torch.matmul "
              f"{1e3 * agg['library_ms']:.1f} us, bound "
              f"{1e3 * agg['bound_ms']:.1f} us | on {smi}")
    mark("kernels")
    print("phase tune:")
    tuned = phase_tune(dev, lanes, bucket, dev_info["smi"])
    hits = ", ".join(f"{a} {c['hits']}/{c['warmed']}"
                     for a, c in tuned["configs"].items())
    print(f"tune: {hits} warmed decode shapes hit the committed table, "
          f"init swept none; "
          f"greedy tokens and prefill logits bit-equal, tuned and static "
          f"choices in turns; {len(tuned['shapes'])} distinct shapes, "
          f"{sum(r['tuned'] != r['static'] for r in tuned['shapes'])} tuned "
          f"away from the static rule | on {dev_info['smi']}")
    verify = phase_verify(dev)
    print(f"verify: Engine(verify='static') accepts {verify['accepted']} at "
          f"full width; verify='dynamic' refused ({verify['refused']}); "
          f"check_pipeline refuses the undersized chain basis with "
          f"AnalysisError: " + "; ".join(verify["findings"]))
    mark("tune+verify")
    _dryrun_wait(dry)
    mark("dryrun wait")
    print("phase serve:")
    misses = tune.stats["capture_misses"]
    serves = {}
    for arch in (ARCH, RESIDENT, STAGED):
        serve = phase_serve(get_config(arch), dev, lanes)
        serves[arch] = serve
        print(f"serve: {arch} {serve['layers']} layers, "
              f"{len(serve['prompt_lens'])} prompts (lens "
              f"{serve['prompt_lens']}, lanes {lanes}), "
              f"{serve['new_tokens']} greedy tokens | prefill "
              f"{serve['prefill_ms']:.1f} ms (all tile launches on 16 rows: "
              f"{serve['prefill_ms_tm16']:.1f} ms) | decode in turns: host "
              f"{serve['decode_ms_per_token']:.2f} ms/token, scan "
              f"{serve['decode_ms_per_token_scan']:.2f} ms/token | "
              f"{serve['decode_tokens_per_s']:.1f} / "
              f"{serve['decode_tokens_per_s_scan']:.1f} tokens/s | launches "
              f"{serve['launches']} (tile by rows "
              f"{serve['tile_launches_by_rows']}) | captured step "
              f"{serve['captured_step_launches']} | scan == host, "
              f"batch-invariant | on {smi}")
        for tr in (serve["trace"], serve["trace_scan"]):
            print(f"trace: {arch} {tr['engine']} generate({tr['tokens']} "
                  f"tokens) {tr['wall_ms']:.1f} ms wall, device busy "
                  f"{tr['device_busy_ms']:.2f} ms "
                  f"({100 * tr['device_busy_share']:.1f}%), "
                  f"{tr['replays']} replays; top: "
                  + "; ".join(f"{t['name']} {t['us']:.0f} us x{t['count']}"
                              for t in tr["top_device"][:4])
                  + " | port kernels: " + "; ".join(
                      f"{k} {v['us']:.0f} us x{v['count']} "
                      f"({100 * v['us'] / (1e3 * tr['device_busy_ms']):.1f}%"
                      f" of busy)" for k, v in tr["port_kernels"].items()))

    mark("serve")
    print("phase sched:")
    scheds = {}
    for arch in (ARCH, RESIDENT):
        sc = phase_sched(get_config(arch), dev)
        scheds[arch] = sc
        st, tr, bs = sc["stats"], sc["trace"], sc["burst_stats"]
        print(f"sched: {arch} {sc['layers']} layers, slots "
              f"{sc['slots']} x {sc['slot_tokens']} tokens, block "
              f"{sc['block_size']}, {sc['n_blocks']} blocks, chunk "
              f"{sc['decode_chunk']}, greedy | synthetic Poisson trace: "
              f"{st['requests']} requests, {st['new_tokens']} new tokens, "
              f"{st['chunks']} chunks, {st['steps']} steps, wall "
              f"{sc['wall_s']:.3f} s, {sc['tokens_per_s']:.1f} new "
              f"tokens/s, latency p50/p99 {st['latency_steps_p50']}/"
              f"{st['latency_steps_p99']} steps, admissions "
              f"{100 * sc['admit_share']['trace']:.1f}% of wall | pool "
              f"{st['pool_bytes']} bytes vs static "
              f"{sc['static_cache_bytes']}, peak {st['peak_blocks']} "
              f"blocks, prefix hits {st['prefix_hits']} | the same "
              f"requests as a burst at step 0, in turns: scheduler "
              f"{sc['burst_wall_s']:.3f} s ({bs['chunks']} chunks, "
              f"admissions {100 * sc['admit_share']['burst']:.1f}% of "
              f"wall), static Engine.generate (scan, one batch, "
              f"{sc['static_new_tokens']} new tokens each) "
              f"{sc['static_wall_s']:.3f} s, requested tokens/s "
              f"{sc['burst_tokens_per_s']:.1f} / "
              f"{sc['static_tokens_per_s']:.1f} | traced burst of "
              f"{tr['requests']} x 9 tokens ({tr['admissions']} "
              f"admissions, {tr['replays']} replays) busy "
              f"{tr['device_busy_ms']:.2f} ms of {tr['wall_ms']:.1f} "
              f"({100 * tr['device_busy_share']:.1f}%) | captured step "
              f"{sc['captured_step_launches']} | solo == scheduled for "
              f"requests {sc['solo_checked']} | on {smi}")

    if tune.stats["capture_misses"] != misses:
        raise AssertionError(f"{tune.stats['capture_misses'] - misses} tuner "
                             "misses inside graph captures over the serve "
                             "and sched phases")
    print(f"tune: serve and sched phases: 0 misses inside graph captures, "
          f"no sweep inside a timed call; {tune.stats['sweeps']} sweeps in "
          f"all (prefill shapes, each on its first untimed use, and the "
          f"kernel rows' shapes)")
    mark("sched")
    chain = phase_chain(d, f, (lanes, lanes * bucket), dev)
    print(f"chain: rns_chain_linear staged == fused bit for bit at "
          f"{[(c['M'], c['K'], c['F']) for c in chain['shapes']]}: "
          f"{chain['equal']} | staged launches {chain['launches']}")
    if not chain["equal"]:
        raise AssertionError("staged chain differs from the fused chain")

    entries = phase_entries(layer_shapes, (d, f, qkv_n), lanes, dev)
    print(f"entry: flash_attention prefill + decode (B {lanes}, 9 heads, "
          f"2048 keys), fold (5, 512x1536), one layer of channel-slice "
          f"launches composed == rns_fused_matmul: {entries['ok']} | "
          f"launches {entries['launches']}, flash by route "
          f"{entries['flash_routes']}")
    if not entries["ok"]:
        raise AssertionError("an entry point's output is wrong")

    int8 = phase_int8(layer_shapes, lanes, lanes * bucket, dev)
    print_int8(int8, layer_shapes, lanes, lanes * bucket, smi)
    mark("chain+entry+int8")
    twit = phase_twit(dev, dev_info["smi"])
    mark("twit")
    checks = {}
    for arch in (ARCH, RESIDENT, STAGED):
        err, finite = phase_check(get_smoke_config(arch), dev)
        checks[arch] = err
        print(f"check: {arch} smoke logits card vs CPU max |diff| "
              f"{err:.5f} <= {LOGIT_ATOL[arch]}")
        if not (finite and err <= LOGIT_ATOL[arch]):
            raise AssertionError(f"{arch} smoke logits card vs CPU differ "
                                 f"by {err}")

    mark("check")
    print("phase families:")
    misses = tune.stats["capture_misses"]
    families = phase_families(dev)
    for r in families:
        ring = r["ring"]
        sched = r.get("sched")
        print(f"families: {r['label']} {r['layers']} layers"
              + (f" (depth cut to {r['cut']})" if r["cut"] else "")
              + f", weights {r['weight_bytes'] / 1e9:.2f} GB, peak device "
              f"memory {r['peak_bytes'] / 1e9:.2f} GB | {len(r['prompt_lens'])}"
              f" prompts (lens {r['prompt_lens']}, bucket {r['bucket']}, "
              f"lanes {r['lanes']}, smax {r['smax']}), {r['new_tokens']} "
              f"greedy tokens | prefill {r['prefill_ms']:.1f} ms (alone in "
              f"turns: float64 linears {r['prefill_ms_exact']:.1f} ms, "
              f"library GEMM {r['prefill_ms_library']:.1f} ms) | decode "
              f"in turns: host {r['decode_ms_per_step']:.2f} ms/step, scan "
              f"{r['decode_ms_per_step_scan']:.2f} ms/step | "
              f"{r['tokens_per_s']:.1f} / {r['tokens_per_s_scan']:.1f} "
              f"tokens/s | port launches a step {r['launches_per_step']}, "
              f"tile nodes by C {r['tile_nodes_by_C']}, all kernels of the "
              f"captured step {r['step_kernels']}"
              + (f" | ring of {ring['window']}: positions "
                 f"{ring['first_pos']}..{ring['last_pos']}, write cursor at "
                 f"slot {ring['last_slot']}, wrapped" if ring else "")
              + (f" | int8 logits vs bf16 rel err "
                 f"{r['rel_err_vs_bf16']:.4f} < 0.35"
                 if "rel_err_vs_bf16" in r else "")
              + (f" | SlotScheduler {sched['requests']} requests, "
                 f"{sched['new_tokens']} tokens, {sched['chunks']} chunks, "
                 f"{sched['wall_s']:.3f} s, == solo" if sched else "")
              + " | scan == host"
              + (", batch-invariant" if r["batch_invariant"] else
                 " (MoE: capacity depends on the batch, no invariance)")
              + f" | {r['seconds']:.1f} s | on {smi}")
    if tune.stats["capture_misses"] != misses:
        raise AssertionError("tuner misses inside graph captures in the "
                             "families phase")
    label, arch, _, over, _, lens, _ = next(r for r in FAMILY_RUNS if r[3])
    fam_rows = phase_family_kernels(
        dataclasses.replace(get_config(arch), **over), dev, lanes, lens)
    fam_cases = [r for r in fam_rows if r["kernel"] == "rns_fused_matmul"]
    print(f"families: {label}'s kernels at its shapes: rns_fused_matmul "
          f"{len(fam_cases)} (M, K, N) cases x (tuned, tm32, tm16), "
          f"rns_forward {len(fam_rows) - len(fam_cases)} encodes, C "
          f"{sorted({r['C'] for r in fam_rows})}: all bit-equal to the "
          f"plain versions")
    zoo = phase_zoo_check(dev)
    print("families: smoke twins card vs CPU max |logit diff| (bound): "
          + ", ".join(f"{n} {e:.4f} ({b:.3f})" for n, (e, b) in zoo.items()))
    mark("families")
    print("phase train:")
    train = phase_train(layer_shapes, dev, smi)
    tr, ms, pk = train["trace"], train["ms_per_step"], train["peak_bytes"]
    print(f"train: {ARCH} {L} layers through the CLI's TrainLoop "
          f"({' '.join(TRAIN_ARGS[2:])}): mean loss of the first 5 steps "
          f"{train['first5']:.4f} -> last 5 {train['last5']:.4f} (drop > 0.3)"
          f" | {json.dumps(train['summary'])} | launches a step: remat full "
          f"{train['per_step']['full']['rns_fused_matmul']}, none "
          f"{train['per_step']['none']['rns_fused_matmul']} "
          f"rns_fused_matmul, no other port kernel; the run "
          f"{train['launches']['rns_fused_matmul']} | tuner sweeps "
          f"{train['sweeps']} (the kernel rows, before any timed step) | "
          f"run {train['wall_s']:.1f} s, peak device memory "
          f"{train['run_peak_bytes'] / 1e9:.2f} GB (with the copy of the "
          f"4-step state the resume gate keeps) | on {smi}")
    print(f"train: a step of the same data in turns: fused QAT "
          f"{ms['fused']:.1f} ms, {train['tokens_per_s']['fused']:.0f} "
          f"tokens/s, peak {pk['fused'] / 1e9:.2f} GB | bf16 smollm-135m "
          f"{ms['bf16']:.1f} ms, {train['tokens_per_s']['bf16']:.0f} "
          f"tokens/s, peak {pk['bf16'] / 1e9:.2f} GB | traced fused step "
          f"{tr['wall_ms']:.1f} ms wall, device busy "
          f"{tr['device_busy_ms']:.1f} ms "
          f"({100 * tr['device_busy_share']:.1f}%), tile kernel "
          f"{100 * tr['tile_share_of_busy']:.1f}% of busy; top: "
          + "; ".join(f"{t['name']} {t['us']:.0f} us x{t['count']}"
                      for t in tr["top_device"][:5]) + f" | on {smi}")
    print(f"train: resume at full width (2 steps, checkpoint, a new "
          f"TrainLoop, 2 steps) == the run's first 4 steps, params and both "
          f"moments bit-equal | smoke train step card vs CPU (loss, largest "
          f"gradient error / leaf max): " + ", ".join(
              f"{a} {v['loss_err']:.2e} {v['grad_rel_err']:.2e}"
              for a, v in train["smoke"].items())
          + f" (<= {TRAIN_LOSS_ATOL}, {TRAIN_GRAD_RTOL}); fused == staged "
          f"bit for bit on the card | encoded STE gx == x @ w_hat bit for "
          f"bit | served 8 scan tokens: trained == restored from checkpoint "
          f"step {train['checkpoint_step']} | seconds by part "
          f"{train['seconds']} | on {smi}")
    mark("train")
    print("phase analysis:")
    analysis = phase_analysis(dev, smi, serves, train, lanes, dry)
    mark("analysis")
    print("phase dist:")
    dist_res = phase_dist(dev, smi)
    print_dist(dist_res, smi)
    mark("dist")
    print(f"time: seconds by phase {marks}, "
          f"{time.perf_counter() - t_start:.0f} s in all")

    def by_path(key):
        out = {arch: sv["launches"][key] for arch, sv in serves.items()
               if sv["launches"][key]}
        out.update({f"sched:{arch}": sc["launches"][key]
                    for arch, sc in scheds.items() if sc["launches"][key]})
        if chain["launches"][key]:
            out["rns_chain_linear:pallas"] = chain["launches"][key]
        out.update({f"families:{r['label']}": r["launches"][key]
                    for r in families if r["launches"][key]})
        if train["launches"][key]:
            out[f"train:{ARCH}"] = train["launches"][key]
        return out

    runs = {**serves, **{f"sched:{a}": sc for a, sc in scheds.items()},
            **{f"families:{r['label']}": r for r in families},
            f"train:{ARCH}": train}
    quantize = {a: n - runs[a]["launches"]["residue_in"]
                for a, n in by_path("rns_fused_matmul").items()}
    # the sharded engine runs, summed over each group's ranks (prefill
    # logits and the host generate; the scan run is not counted)
    def dist_launches(run, name):
        pre, gen = run["prefill_launches"], run["generate_launches"]
        if name == "rns_fused_matmul":          # the quantize launches
            return (pre[name] + gen[name] - pre["residue_in"]
                    - gen["residue_in"])
        return pre[name] + gen[name]

    dist_paths = {k: {} for k in ("rns_fused_crt_partial",
                                  "rns_fused_matmul", "residue_in")}
    for n, (ranks, _) in dist_res["groups"].items():
        for j, run in enumerate(ranks[0]["engine"]):
            key = f"dist:{run['arch']}/{run['layout']}/{n} ranks"
            for name, paths in dist_paths.items():
                got = sum(dist_launches(r["engine"][j], name) for r in ranks)
                if got:
                    paths[key] = got
    quantize.update(dist_paths["rns_fused_matmul"])
    # the raw-int8 launches of the int8 phase and of phase 14's calls
    raw_paths = {"rns_fused_matmul:raw_int8": {
        "int8:rns_int_matmul": int8["launches"]["raw_int8"]},
        "rns_fused_crt_partial:raw_int8": {
        "int8:channel_sliced_matmul": int8["launches"]["crt_raw_int8"]}}
    for n, (ranks, _) in dist_res["groups"].items():
        for name, key in (("rns_fused_matmul:raw_int8", "raw_fused"),
                          ("rns_fused_crt_partial:raw_int8", "raw_crt")):
            got = sum(c[key] for r in ranks for c in r["int8"]["cases"])
            if got:
                raw_paths[name][f"dist:rns_int_matmul/"
                                f"{ranks[0]['int8']['layout']}/{n} ranks"] \
                    = got
    src = "src/repro_torch/csrc/"

    def entry(name, source, replaces, launches, agg, rows_of):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows_of),
                "ms": agg["ms"], "plain_ms": agg["plain_ms"],
                "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
                "library_ms": agg["library_ms"]}

    def rows_of(kernel, table):
        return [r for r in table if r["kernel"] == kernel]

    kernels = [
        entry("rns_fused_matmul", src + "rns_common.cuh",
              "src/repro/kernels/rns_fused.py:352", quantize, fused,
              [{"max_abs_err": max_err}]
              + rows_of("rns_fused_matmul", fam_rows)
              + rows_of("rns_fused_matmul", train["rows"])),
        entry("rns_forward", src + "rns_kernels.cu",
              "src/repro/kernels/rns_convert.py:54", by_path("rns_forward"),
              fwd, rows_of("rns_forward", rows) + rows_of("rns_forward",
                                                          rows2)
              + rows_of("rns_forward", fam_rows)),
        entry("rns_fused_matmul:residue_in", src + "rns_common.cuh",
              "src/repro/kernels/rns_fused.py:352",
              {**by_path("residue_in"), **dist_paths["residue_in"]},
              resid, rows_of("rns_fused_matmul:residue_in", rows2)),
        entry("rns_matmul", src + "rns_common.cuh",
              "src/repro/kernels/rns_matmul.py:84", by_path("rns_matmul"),
              matmul, rows_of("rns_matmul", rows2)),
        entry("rns_reverse", src + "rns_kernels.cu",
              "src/repro/kernels/rns_convert.py:164",
              by_path("rns_reverse"), reverse, rows_of("rns_reverse", rows2)),
        entry("rns_modmul", src + "rns_kernels.cu",
              "src/repro/kernels/rns_modmul.py:29", by_path("rns_modmul"),
              modmul, rows_of("rns_modmul", rows2)),
        entry("flash_attention", src + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:115",
              {"entry:flash_attention":
               entries["launches"]["flash_attention"]}, flash,
              rows_of("flash_attention", rows3))
        | {"launches_by_route": entries["flash_routes"],
           "sources": [src + f for f in ("flash_split.cu", "flash_mma.cu",
                                         "flash_attention.cu")]},
        entry("fold", src + "rns_kernels.cu", "src/repro/kernels/fold.py:29",
              {"entry:fold": entries["launches"]["fold"]}, fold,
              rows_of("fold", rows3)),
        entry("rns_fused_crt_partial", src + "rns_common.cuh",
              "src/repro/kernels/rns_fused.py:569",
              {"entry:rns_fused_crt_partial":
               entries["launches"]["rns_fused_crt_partial"],
               **dist_paths["rns_fused_crt_partial"]}, crt,
              rows_of("rns_fused_crt_partial", rows3)),
        entry("rns_fused_matmul:raw_int8", src + "rns_common.cuh",
              "src/repro/kernels/rns_fused.py:352",
              raw_paths["rns_fused_matmul:raw_int8"],
              int8_per_layer(int8["rows"], layer_shapes, lanes,
                             "rns_fused_matmul:raw_int8", "encoded"),
              rows_of("rns_fused_matmul:raw_int8", int8["rows"]))
        | {"sources": [src + f for f in RAW_TILE_SOURCES]},
        entry("rns_fused_crt_partial:raw_int8", src + "rns_common.cuh",
              "src/repro/kernels/rns_fused.py:569",
              raw_paths["rns_fused_crt_partial:raw_int8"],
              int8_per_layer(int8["rows"], layer_shapes, lanes,
                             "rns_fused_crt_partial:raw_int8", "encoded"),
              rows_of("rns_fused_crt_partial:raw_int8", int8["rows"]))
        | {"sources": [src + f for f in RAW_TILE_SOURCES]},
    ]
    # the 64-row wgmma + TMA instances of the raw int8 A mode: launched
    # wherever the tuner picks them on the int8 entry's run and the staged
    # serve (its prefill's broadcast rns_matmul); timed pinned, per layer
    # at M = lanes x bucket (encoded, in turns with the 32-row instance)
    wg_paths = {"int8:rns_int_matmul": int8["launches"]["tile_wg"]}
    for arch, sv in serves.items():
        got = sv["tile_launches_by_rows"].get(TM_WG, 0)
        if got:
            wg_paths[arch] = got
    wg_agg = int8_per_layer(int8["rows"], layer_shapes, lanes * bucket,
                            "rns_fused_matmul:raw_int8", "encoded")
    kernels.append(
        entry("rns_tile_wg:raw_int8", src + "rns_tile_wg.cuh",
              "src/repro/kernels/rns_fused.py:352", wg_paths,
              dict(wg_agg, ms=wg_agg["ms_tm64"]),
              [r for r in int8["rows"] + rows2 if "ms_tm64" in r])
        | {"sources": [src + f for f in WG_TILE_SOURCES],
           "ms_tm32": wg_agg["ms_tm32"]})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on its "
                                 "path")
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as fh:
            json.dump({"device": dev_info, "rows": rows + rows2 + rows3,
                       "serve": serves, "sched": scheds, "chain": chain,
                       "entries": entries, "int8": int8,
                       "prefill_per_layer": prefill,
                       "convert_per_layer": convert, "edges": edges,
                       "decode_per_layer": decode,
                       "check_logit_err": checks, "kernels": kernels,
                       "tune": tuned, "verify": verify, "twit": twit,
                       "tune_stats": dict(tune.stats),
                       "families": families, "zoo_check": zoo,
                       "family_kernels": fam_rows, "train": train,
                       "analysis": analysis, "dist": dist_res,
                       "phase_seconds": marks},
                      fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
