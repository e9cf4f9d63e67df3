#!/usr/bin/env python3
"""Time the conversion and residue-multiply kernels of one or more checkouts
of the port on one NVIDIA GPU, in turns.

    python3 convert_bench.py [--tree DIR ...] [--rounds N] [--only KERNEL]
                             [--record PATH]

Each ``--tree`` is the root of a checkout (default: this one); list the
"before" first.  Every tree's kernel library is built first, all at once,
then each round runs one worker process per tree, in turns (A B B A ...).
A worker imports `repro_torch` from its tree's `src/` and times every row
by CUDA-graph replay over copies of the operands that together outgrow the
50 MB L2 (> 120 MiB a cycle), as `chip_smoke.py` times the kernels:

  rns_forward  the 7 Engine-init weight encodes (30 stacked layers); the
               staged path's 7 weight conversions of every step; per
               step of one layer at M = 8 (decode) and M = 512
               (prefill): the resident path's 2 activation encodes, the
               staged chain's gate and requantized-up encodes;
  rns_reverse  per step of one layer at M = 8 and 512: the staged path's
               7 reverses and the staged chain's gate/up and down;
  rns_modmul   the staged chain's gate multiply (7, M·1536) of int8
               residues at M = 8 and 512, into int32 (the reference's
               contract) and, where the tree's wrapper takes
               ``out_dtype``, into the chain's int8 residues.

Where the tree's `rns_convert` can pin its grid (`_pin_launch`), the
decode rows are also timed at each block size (64, 128, 256 threads) and
the prefill and init rows at each cap of threads an SM (512, 1024,
2048).
Prints each row's median over the rounds for every tree, the per-layer
sums and their bounds (bytes once over 3.35 TB/s), beside the card's
name and power limit.  Exits non-zero without a CUDA device.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
COLD_L2_BYTES = 120 << 20
D, F, QD, KVD, LAYERS = 576, 1536, 576, 192, 30     # smollm-135m widths
LINEARS = [("wq", D, QD), ("wk", D, KVD), ("wv", D, KVD), ("wo", QD, D),
           ("w_gate", D, F), ("w_up", D, F), ("w_down", F, D)]
DECODE_M, PREFILL_M = 8, 512
STEP = "every step"   # the M of rows that do not depend on it
# per-layer sums: (name, kernel, row label prefixes, M or None for init)
SUMS = [("init: 7 weight encodes", "rns_forward", ["init-"], None),
        ("staged, every step: 7 weight conversions", "rns_forward",
         ["weight-"], STEP)]
for _m in (DECODE_M, PREFILL_M):
    SUMS += [
        (f"resident M={_m}: 2 activation encodes", "rns_forward",
         ["act-qkv", "act-mlp"], _m),
        (f"staged M={_m}: 7 reverses", "rns_reverse",
         [n for n, _, _ in LINEARS], _m)]


def _rows(dev):
    """(kernel, label, M, make operand, call, bytes moved) of every row."""
    import torch
    from repro_torch.core.conversion_plan import ConversionPlan
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
    import inspect

    from repro_torch.kernels import rns_forward, rns_modmul, rns_reverse

    g = torch.Generator(device=dev).manual_seed(0)

    def ints(shape, lo, hi, dtype):
        return lambda: torch.randint(lo, hi, shape, generator=g, device=dev,
                                     dtype=dtype)

    def fwd(kernel, label, m, basis, shape, dtype):
        mods = basis.moduli
        n = math.prod(shape)
        isz = 1 if dtype == torch.int8 else 4
        return (kernel, label, m, ints(shape, -128, 128, dtype),
                lambda x: rns_forward(x, mods, dtype=torch.int8),
                n * (isz + len(mods)))

    def rev(label, m, basis, n):
        conv = ConversionPlan.for_basis(basis)
        mods = basis.moduli

        def make():
            return torch.stack([torch.randint(0, mm, (m * n,), generator=g,
                                              device=dev, dtype=torch.int32)
                                for mm in mods])
        return ("rns_reverse", label, m, make,
                lambda r: rns_reverse(r, conv), 4 * (len(mods) + 1) * m * n)

    def modmul(m, basis, otype):
        mods = basis.moduli
        C = len(mods)

        def make():
            return tuple(torch.stack([
                torch.randint(0, mm, (m, F), generator=g, device=dev)
                for mm in mods]).to(torch.int8) for _ in range(2))
        kw = {} if otype is None else {"out_dtype": otype}
        osize = 1 if otype == torch.int8 else 4
        return ("rns_modmul", f"modmul M={m} F={F} out="
                f"{'int8' if otype == torch.int8 else 'int32'}", m, make,
                lambda ab: rns_modmul(*ab, mods, **kw),
                (2 + osize) * C * m * F)

    rows = [fwd("rns_forward", f"init-{name} {LAYERS}x{k}x{n}", None,
                basis_for_int8_matmul(k), (LAYERS, k, n), torch.int8)
            for name, k, n in LINEARS]
    rows += [fwd("rns_forward", f"weight-{name} {k}x{n}", STEP,
                 basis_for_int8_matmul(k), (k, n), torch.int8)
             for name, k, n in LINEARS]
    chain = basis_for_chain(F)
    for m in (DECODE_M, PREFILL_M):
        rows += [fwd("rns_forward", f"act-qkv {m}x{D}", m,
                     basis_for_int8_matmul(D), (m, D), torch.int8),
                 fwd("rns_forward", f"act-mlp {m}x{D}", m, chain, (m, D),
                     torch.int8),
                 fwd("rns_forward", f"gate {m}x{F}", m, chain, (m, F),
                     torch.int8),
                 fwd("rns_forward", f"requant-up {m}x{F}", m, chain, (m, F),
                     torch.int32)]
        rows += [rev(f"{name} M={m} N={n}", m, basis_for_int8_matmul(k), n)
                 for name, k, n in LINEARS]
        rows += [rev(f"chain-gate/up M={m} N={F}", m, chain, F),
                 rev(f"chain-down M={m} N={D}", m, chain, D)]
        rows.append(modmul(m, chain, None))
        if "out_dtype" in inspect.signature(rns_modmul).parameters:
            rows.append(modmul(m, chain, torch.int8))
    return rows


def _device_ms(fn, pool, reps=7):
    """Median device time of one call: every operand of the pool once per
    CUDA-graph replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in pool[:3]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in pool:
            fn(x)
    times = []
    for _ in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / len(pool))
    del graph
    return statistics.median(times[1:])


def worker(tree, only=None):
    import torch

    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build, rns_convert

    _build.library()
    pin = getattr(rns_convert, "_pin_launch", None)
    out = {}
    for kernel, label, m, make, call, nbytes in _rows(torch.device("cuda")):
        if only and kernel != only:
            continue
        pool = [make() for _ in range(max(1, min(
            256, math.ceil(COLD_L2_BYTES / nbytes))))]
        row = {"kernel": kernel, "M": m, "bytes": nbytes,
               "ms": _device_ms(call, pool)}
        if pin is not None and m in (DECODE_M, STEP):
            for t in (64, 128, 256):
                with pin(threads=t):
                    row[f"ms_t{t}"] = _device_ms(call, pool)
        if pin is not None and m in (PREFILL_M, None):
            for per_sm in (512, 1024, 2048):
                with pin(per_sm=per_sm):
                    row[f"ms_sm{per_sm}"] = _device_ms(call, pool)
        out[label] = row
        del pool
        torch.cuda.empty_cache()
    print("ROWS " + json.dumps(out))


def _run_worker(tree, only=None):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--worker", tree]
                          + (["--only", only] if only else []),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"worker for {tree} failed:\n{proc.stderr}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("ROWS "))
    return json.loads(line[5:])


def _build_all(trees):
    code = ("import sys; sys.path.insert(0, sys.argv[1] + '/src'); "
            "from repro_torch.kernels import _build; _build.build()")
    procs = [subprocess.Popen([sys.executable, "-c", code, t],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for t in trees]
    for t, p in zip(trees, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"build of {t} failed:\n{err}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append",
                    help="root of a checkout (repeat; default: this one)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--record", help="write every row as JSON here")
    ap.add_argument("--only", help="time only the rows of this kernel")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("convert_bench: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        worker(os.path.abspath(args.worker), args.only)
        return 0
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build_all(trees)
    runs = {t: [] for t in trees}
    for r in range(args.rounds):
        for t in (trees if r % 2 == 0 else trees[::-1]):
            runs[t].append(_run_worker(t, args.only))
    result = {}
    for t in trees:
        rows = {}
        for label, row in runs[t][0].items():
            rows[label] = dict(row)
            for k in row:
                if k.startswith("ms"):
                    rows[label][k] = statistics.median(
                        run[label][k] for run in runs[t])
        result[t] = rows
    names = {t: "this tree" if t == ROOT else os.path.relpath(t, ROOT)
             for t in trees}
    print(f"convert_bench: {len(trees)} trees x {args.rounds} rounds in "
          f"turns | on {smi}")
    labels = list(dict.fromkeys(lab for t in trees for lab in result[t]))
    for label in labels:
        row = next(result[t][label] for t in trees if label in result[t])
        b = 1e6 * row["bytes"] / HBM_BYTES_PER_S
        times = " | ".join(
            f"{names[t]} " + ("none" if label not in result[t] else
                              f"{1e3 * result[t][label]['ms']:.2f}"
                              + "".join(f" {k[3:]}={1e3 * v:.2f}"
                                        for k, v in result[t][label].items()
                                        if k.startswith("ms_")))
            for t in trees)
        print(f"  {row['kernel']} {label}: {times} us, bound {b:.2f} us")
    sums = {}
    for name, kernel, prefixes, m in SUMS:
        if args.only and kernel != args.only:
            continue
        sums[name] = {}
        for t in trees:
            rs = [r for lab, r in result[t].items() if r["kernel"] == kernel
                  and r["M"] == m and any(lab.startswith(p)
                                          for p in prefixes)]
            sums[name][names[t]] = {
                "rows": len(rs), "us": 1e3 * sum(r["ms"] for r in rs),
                "bound_us": 1e6 * sum(r["bytes"] for r in rs)
                / HBM_BYTES_PER_S}
        print(f"sum: {name}: " + " | ".join(
            f"{n} {v['us']:.2f} us ({v['rows']} rows)"
            for n, v in sums[name].items())
            + f", bound {next(iter(sums[name].values()))['bound_us']:.2f} us"
            f" | on {smi}")
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as fh:
            json.dump({"smi": smi, "trees": names, "rows": {
                names[t]: result[t] for t in trees}, "sums": sums}, fh,
                indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
