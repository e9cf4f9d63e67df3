#!/usr/bin/env python3
"""Time the served float-epilogue forms of the tile kernel in one or more
checkouts of the port on one NVIDIA GPU, in turns.

    python3 tile_bench.py [--tree DIR ...] [--rounds N] [--record PATH]

Each ``--tree`` is the root of a checkout (default: this one); list the
"before" first.  Every tree's kernel library is built first, all at once,
then each round runs one worker process per tree, in turns (A B B A ...).
A worker imports `repro_torch` from its tree's `src/` and times, by
CUDA-graph replay over weight copies that together outgrow the 50 MB L2
(`convert_bench._device_ms`, as `chip_smoke.py` times the kernels), one
smollm-135m layer's 7 `rns_fused_matmul` launches in each of the two
forms the served models run with a float epilogue, at M = 8 (decode) and
M = 512 (prefill):

  quantize   bf16 x quantized in the prologue, an encoded weight, the
             (M, 1) row and (1, N) column scales;
  residue-in an activation `RNSTensor`, an encoded weight, its carried
             row scale and the column scale.

Every tree resolves its blocks by the tuner's static rule
(`tune.static_rule()`), so that every tree launches the same tiles and a
difference is the kernel's.  Prints each row's median over the rounds
for every tree and the per-layer sums, beside the card's name and power
limit.  Exits non-zero without a CUDA device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import convert_bench as cb

ROOT = os.path.dirname(os.path.abspath(__file__))
FORMS = ("quantize", "residue-in")


def _rows(dev):
    """(form, label, M, weight pool, call) of every row."""
    import torch
    from repro_torch.core.quant import quant_scale
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.core.rns_tensor import (RNSTensor, encode,
                                             encode_activation)
    from repro_torch.kernels import rns_fused_matmul

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for m in (cb.DECODE_M, cb.PREFILL_M):
        for name, k, n in cb.LINEARS:
            basis = basis_for_int8_matmul(k)
            C = len(basis.moduli)
            w = encode(torch.randn(k, n, generator=g, device=dev) / k ** 0.5,
                       basis)
            pool = [torch.randint(0, 37, (C, k, n), generator=g, device=dev,
                                  dtype=torch.int8)
                    for _ in range(max(1, min(256, -(-cb.COLD_L2_BYTES
                                                     // (C * k * n)))))]
            x = torch.randn(m, k, generator=g, device=dev)
            xq, sx = x.to(torch.bfloat16), quant_scale(x.to(torch.bfloat16))
            xa = encode_activation(x, basis)

            def quantize(r, xq=xq, sx=sx, w=w, basis=basis):
                return rns_fused_matmul(xq, r, basis, scale_row=sx,
                                        scale_col=w.scale)

            def residue_in(r, xa=xa, w=w):
                return rns_fused_matmul(xa, RNSTensor(r, w.scale, w.basis),
                                        scale_row=xa.scale,
                                        scale_col=w.scale)
            rows += [("quantize", f"quantize {name} M={m}", m, pool,
                      quantize),
                     ("residue-in", f"residue-in {name} M={m}", m, pool,
                      residue_in)]
    return rows


def worker(tree):
    import torch

    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build, tune

    _build.library()
    out = {}
    with tune.static_rule():
        for form, label, m, pool, call in _rows(torch.device("cuda")):
            out[label] = {"form": form, "M": m,
                          "ms": cb._device_ms(call, pool)}
    print("ROWS " + json.dumps(out))


def _run_worker(tree):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--worker", tree], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"worker for {tree} failed:\n{proc.stderr}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("ROWS "))
    return json.loads(line[5:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append",
                    help="root of a checkout (repeat; default: this one)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--record", help="write every row as JSON here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tile_bench: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        worker(os.path.abspath(args.worker))
        return 0
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cb._build_all(trees)
    runs = {t: [] for t in trees}
    for r in range(args.rounds):
        for t in (trees if r % 2 == 0 else trees[::-1]):
            runs[t].append(_run_worker(t))
    names = {t: "this tree" if t == ROOT else os.path.relpath(t, ROOT)
             for t in trees}
    result = {t: {label: dict(row, ms=statistics.median(
        run[label]["ms"] for run in runs[t]))
        for label, row in runs[t][0].items()} for t in trees}
    print(f"tile_bench: {len(trees)} trees x {args.rounds} rounds in turns, "
          f"static blocks | on {smi}")
    for label in result[trees[0]]:
        print(f"  {label}: " + " | ".join(
            f"{names[t]} {1e3 * result[t][label]['ms']:.2f}" for t in trees)
            + " us")
    sums = {}
    for form in FORMS:
        for m in (cb.DECODE_M, cb.PREFILL_M):
            key = f"{form} M={m}: one layer's 7 launches"
            sums[key] = {names[t]: 1e3 * sum(
                r["ms"] for r in result[t].values()
                if r["form"] == form and r["M"] == m) for t in trees}
            print(f"sum: {key}: " + " | ".join(
                f"{n} {us:.2f} us" for n, us in sums[key].items())
                + f" | on {smi}")
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as fh:
            json.dump({"smi": smi, "trees": names, "rows": {
                names[t]: result[t] for t in trees}, "sums": sums,
                "runs": {names[t]: runs[t] for t in trees}}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
