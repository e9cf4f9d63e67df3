#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]   # from a checkout, one card

Phases, each of which must pass:
  1. device  — the card's name and power limit (nvidia-smi), the kernel
     library built from `src/repro_torch/csrc` (build seconds printed);
  2. kernels — each CUDA kernel against its plain PyTorch version, bit for
     bit, at every launch shape of the serving path, with median times
     (CUDA events, cold L2), the plain version's time, a one-call PyTorch
     yardstick and the least time the card could take (bytes over HBM rate
     or int8 ops over the int8 peak, whichever is larger);
  3. serve   — the full 30-layer `rns-smollm-135m-fused` (published widths,
     seeded random weights) served through `serve.Engine`: launch counts of
     the main path, batch invariance with pinned lanes, prefill and decode
     times;
  4. check   — finite logits of the served batch, and the smoke config's
     logits on the card against the same model on the CPU (plain versions).
Lines: per-shape kernel rows, a `kernels:` summary, a `serve:` summary, the
nvidia-smi line, the kernels JSON line and, last, the device JSON line.
``--record PATH`` also writes every row, the serve numbers and the trace as
JSON.  Exits non-zero without a CUDA device or without the port's sources
beside it.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 1,979 TOP/s dense int8.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
COLD_L2_BYTES = 120 << 20          # > 2x the 50 MB L2: weights read cold
ARCH = "rns-smollm-135m-fused"
# Tolerance of the smoke model's logits, card vs CPU: the same bound the CPU
# tests hold the port to against the JAX reference (tests/test_torch_model).
LOGIT_ATOL = 0.03


def bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
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


def device_ms(fn, n, reps=7):
    """Device time of one ``fn(i)``: ``n`` calls (i = 0..n-1) captured in a
    CUDA graph, the graph replayed ``reps`` times, median replay / n.  The
    host's launch overhead is out of the measurement."""
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
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[reps // 2]


def phase_device():
    import torch
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    spills = [ln.strip() for ln in log.splitlines()
              if "spill" in ln and " 0 bytes spill" not in ln]
    print(f"device: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"build: {build_s:.1f} s -> {os.path.relpath(so, ROOT)} "
          f"({len(regs)} kernels; spills: {spills or 'none'})")
    return {"name": name, "smi": smi, "build_s": build_s,
            "ptxas": regs, "spills": spills}


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
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same = torch.equal(got, want)
        ok &= same
        max_err = max(max_err, err)
        wbytes = arg.numel()
        pool = _copies(lambda: torch.randint(0, 37, tuple(arg.shape),
                                             dtype=torch.int8, device=dev),
                       wbytes)
        def launch(i):
            rns_fused_matmul(x, pool[i], basis, scale_row=sx, scale_col=scol)
        ms = device_ms(launch, len(pool))
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
                     "bound_ms": b, "bound_by": by})
        print(f"  rns_fused_matmul M={m:4d} K={k:4d} N={n:4d} "
              f"{rows[-1]['weights']:7s} equal={same} ms={ms:.4f} "
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
        ms = device_ms(lambda i: rns_forward(q, mods, dtype=torch.int8), 5)
        call = time_ms(lambda i: rns_forward(q, mods, dtype=torch.int8),
                       reps=10)
        plain = time_ms(lambda i: ref.rns_forward_ref(q, mods, torch.int8),
                        reps=5, warmup=1)
        mcol = torch.tensor(mods, dtype=torch.int8,
                            device=dev).reshape(-1, 1, 1, 1)
        lib = device_ms(lambda i: torch.remainder(q[None], mcol), 5)
        b, by = bound_ms(q.numel() * (1 + len(mods)), 0)
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
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                       else "operations")
    return out


def phase_serve(cfg, dev, lanes, n_prompts=4, new_tokens=32, smax=128):
    import numpy as np
    import torch
    from repro_torch.kernels import rns_forward, rns_fused_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    lens = [5, 17, 38, 60][:n_prompts]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]

    # the main path: encode at init, then one batched generate
    rns_fused_matmul.launches = 0
    rns_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, smax=smax, lanes=lanes, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = eng.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    launches = {"rns_fused_matmul": rns_fused_matmul.launches,
                "rns_forward": rns_forward.launches}
    per_step = 7 * cfg.num_layers
    want = {"rns_fused_matmul": per_step * new_tokens, "rns_forward": 7}
    if launches != want:
        raise AssertionError(f"main-path launches {launches}, expected "
                             f"{want} ({per_step} per prefill/decode step)")
    for p, o in zip(prompts, out):
        gen = o[len(p):]
        if o[:len(p)] != p or len(gen) != new_tokens or \
                not all(0 <= t < cfg.vocab_size for t in gen):
            raise AssertionError("malformed generate output")

    # batch invariance: each prompt alone (same lanes) == its batched run
    for i, p in enumerate(prompts):
        solo = eng.generate([p], max_new_tokens=new_tokens)[0]
        if solo != out[i]:
            raise AssertionError(f"prompt {i} alone differs from its "
                                 f"batched tokens")

    # timing: prefill = generate(1 token); decode = the rest, per step
    def wall(n):
        ts, res = [], None
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = eng.generate(prompts, max_new_tokens=n)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return sorted(ts)[1], res

    pre_s, _ = wall(1)
    full_s, again = wall(new_tokens)
    if again != out:
        raise AssertionError("greedy generate is not deterministic")
    dec_ms = 1e3 * (full_s - pre_s) / (new_tokens - 1)

    # one traced generate (prefill + 3 decode steps): device busy share
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.generate(prompts, max_new_tokens=4)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t

    # kernel rows only: an aten op's row repeats its kernels' device time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in kernels), reverse=True)[:8]
    trace = {"wall_ms": 1e3 * traced_s, "device_busy_ms": busy_us / 1e3,
             "device_busy_share": busy_us / (1e6 * traced_s),
             "top_device": [{"us": u, "name": k[:80], "count": c}
                            for u, k, c in top if u > 0]}

    # finite logits at the served shape
    batch, _ = eng._pack(prompts)
    with torch.inference_mode():
        logits, _, _ = T.prefill(cfg, eng.params, batch, smax)
    if not (logits.shape == (lanes, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite / wrong shape")
    return {"launches": launches, "launches_per_step": per_step,
            "init_s": init_s, "prefill_ms": 1e3 * pre_s,
            "decode_ms_per_token": dec_ms,
            "decode_tokens_per_s": n_prompts * 1e3 / dec_ms,
            "prompt_lens": lens, "lanes": lanes, "new_tokens": new_tokens,
            "smax": smax, "batch_invariant": True, "trace": trace}


def phase_check(smoke_cfg, dev):
    """Smoke model on the card (kernels) vs the CPU (plain versions)."""
    import numpy as np
    import torch
    from repro_torch.core.rns_tensor import encode_params
    from repro_torch.models import transformer as T

    params = T.make_params(smoke_cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, smoke_cfg.vocab_size, (3, 16)))
    pad = torch.tensor([0, 5, 11], dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        p = encode_params(_to(params, d))
        with torch.inference_mode():
            lg, _, _ = T.prefill(smoke_cfg, p, {"tokens": toks.to(d),
                                                "pad": pad.to(d)}, 24)
        out[str(d)] = lg.float().cpu()
    err = (out["cpu"] - out[str(dev)]).abs().max().item()
    if not (torch.isfinite(out[str(dev)]).all() and err <= LOGIT_ATOL):
        raise AssertionError(f"smoke logits card vs CPU differ by {err}")
    return err


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

    dev_info = phase_device()
    print("phase kernels:")
    rows, fused_ok, fwd_ok, max_err = phase_kernels(
        layer_shapes, lanes, lanes * bucket, torch.device("cuda"))
    # one decode step of one layer: the 7 encoded launches at M = lanes
    fused = _sum([next(r for r in rows if r["kernel"] == "rns_fused_matmul"
                       and r["weights"] == "encoded" and r["M"] == lanes
                       and (r["K"], r["N"]) == (k, n))
                  for _, k, n, _ in layer_shapes])
    fwd = _sum([r for r in rows if r["kernel"] == "rns_forward"])
    print(f'kernels: ["rns_fused_matmul", "rns_forward"] '
          f'pass=[{str(fused_ok).lower()}, {str(fwd_ok).lower()}] '
          f'median_ms=[{fused["ms"]:.4f}, {fwd["ms"]:.4f}] '
          f'(the 7 launches of one layer at decode; the 7 encodes at init)')
    if not (fused_ok and fwd_ok):
        raise AssertionError("a kernel disagrees with its plain version")

    print("phase serve:")
    serve = phase_serve(cfg, torch.device("cuda"), lanes)
    smi = dev_info["smi"]
    print(f"serve: {ARCH} {L} layers, {len(serve['prompt_lens'])} prompts "
          f"(lens {serve['prompt_lens']}, lanes {lanes}), "
          f"{serve['new_tokens']} greedy tokens | prefill "
          f"{serve['prefill_ms']:.1f} ms | decode "
          f"{serve['decode_ms_per_token']:.2f} ms/token | "
          f"{serve['decode_tokens_per_s']:.1f} tokens/s | launches "
          f"{serve['launches']} | batch-invariant | on {smi}")
    tr = serve["trace"]
    print(f"trace: generate(4 tokens) {tr['wall_ms']:.1f} ms wall, device "
          f"busy {tr['device_busy_ms']:.2f} ms "
          f"({100 * tr['device_busy_share']:.1f}%); top: "
          + "; ".join(f"{t['name']} {t['us']:.0f} us x{t['count']}"
                      for t in tr["top_device"][:4]))
    check_err = phase_check(get_smoke_config(ARCH), torch.device("cuda"))
    print(f"check: smoke logits card vs CPU max |diff| {check_err:.5f} "
          f"<= {LOGIT_ATOL}")

    kernels = [
        {"name": "rns_fused_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/rns_kernels.cu",
         "replaces": "src/repro/kernels/rns_fused.py:352",
         "launches": serve["launches"]["rns_fused_matmul"],
         "max_abs_err": max_err, "ms": fused["ms"],
         "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": fused["library_ms"]},
        {"name": "rns_forward", "route": "cuda",
         "source": "src/repro_torch/csrc/rns_kernels.cu",
         "replaces": "src/repro/kernels/rns_convert.py:54",
         "launches": serve["launches"]["rns_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in rows
                            if r["kernel"] == "rns_forward"),
         "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
         "library_ms": fwd["library_ms"]},
    ]
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as fh:
            json.dump({"device": dev_info, "rows": rows, "serve": serve,
                       "check_logit_err": check_err, "kernels": kernels},
                      fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
