#!/usr/bin/env python3
"""Where the 64-row wgmma + TMA tile's time goes, on one GPU, by leaving
one phase out at a time.

    python3 wg_phases.py          # from a checkout, one card

Builds the encoded-weight 64-row instances (`csrc/rns_tile_wg_raw.cu`)
alone into one small library per variant under `build/wg_phases/`, each
from a copy of `csrc/rns_tile_wg.cuh` with one phase removed: the
epilogue (`noepi`), the producer's weight reads (`noload`: the rows it
stores are made up), the producer's whole weight stage (`noproducer`:
no reads, no transposes, no stores), the wgmma (`nomma`); `full` is the
tile as it is.  A one-function C shim exposes each library's launcher.
Each variant then runs in its own process: one smollm-135m layer's seven
raw-int8 `rns_fused_matmul` launches at M = 512 with encoded weights
(C = 5), pinned to the 64-row tile, timed by CUDA-graph replay (median
of 5 replays of 5 layers, twice), and one N = 1536 launch alone.  A
variant's output is wrong by design; only its time is read.  The package
is not changed.  Exits non-zero without a CUDA device or if a phase's
text is no longer in the header once.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "wg_phases"
# variant -> (text in csrc/rns_tile_wg.cuh, its replacement)
VARIANTS = {
    "full": [],
    "noepi": [(f"    wg_epilogue<C, EMIT, WG_THREADS>({args}",
               f"    if (a.M < 0) wg_epilogue<C, EMIT, WG_THREADS>({args}")
              for args in ("reinterpret_cast", "xch, ")],
    "noload": [("if (gn < a.N) v = __ldg(reinterpret_cast<const uint4*>"
                "(src));", "if (gn < a.N) v = make_uint4(k0, gk, 0u, 0u);")],
    "noproducer": [("      wg_produce_w<C, ENCODED>(a, plan, bstage",
                    "      if (a.M < 0) wg_produce_w<C, ENCODED>(a, plan, "
                    "bstage")],
    "nomma": [("          wgmma_s8_n32(acc[c], da + 2 * kk,",
               "          if (a.M < 0) wgmma_s8_n32(acc[c], da + 2 * kk,")],
}
SHIM = """#include "rns_common.cuh"
extern "C" int wg_tile_launch(int amode, const TileArgs* a,
                              const FusedPlan* plan, void* stream) {
  if (a->tm != rns::TM_WG || amode != rns::A_SHARED || !a->encoded) {
    return -1;
  }
  return rns_launch_tile_wg_raw(*a, *plan, static_cast<cudaStream_t>(stream));
}
"""
LAYER = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536),
         (576, 1536), (1536, 576)]


def build() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    header = (CSRC / "rns_tile_wg.cuh").read_text()
    dirs = []
    for name, edits in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        h = header
        for old, new in edits:
            if h.count(old) != 1:
                raise SystemExit(f"wg_phases: {name}: the header no longer "
                                 f"has one {old.strip()[:60]!r}")
            h = h.replace(old, new)
        (d / "rns_tile_wg.cuh").write_text(h)
        (d / "tile.cu").write_text((CSRC / "rns_tile_wg_raw.cu").read_text())
        (d / "shim.cu").write_text(SHIM)
        dirs.append(d)

    def one(d):
        objs = []
        for src in ("tile.cu", "shim.cu"):
            obj = d / (src + ".o")
            r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-I",
                                str(CSRC), "-c", "-o", str(obj),
                                str(d / src)], capture_output=True, text=True)
            if r.returncode:
                return f"{d.name}: {r.stderr[-2000:]}"
            objs.append(str(obj))
        r = subprocess.run([nvcc, "-shared", "-o", str(d / "lib.so"), *objs],
                           capture_output=True, text=True)
        return f"{d.name}: {r.stderr[-2000:]}" if r.returncode else ""

    with ThreadPoolExecutor(len(dirs)) as pool:
        errors = [e for e in pool.map(one, dirs) if e]
    if errors:
        raise SystemExit("wg_phases: build failed\n" + "\n".join(errors))


def run(name: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.core.rns_tensor import RNSTensor
    from repro_torch.kernels import _build, rns_fused as rf, rns_fused_matmul

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    lib.wg_tile_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.wg_tile_launch.restype = ctypes.c_int

    class Library:
        rns_tile_launch = staticmethod(lib.wg_tile_launch)

    _build.library = lambda: Library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    xs = {K: torch.randint(-128, 128, (512, K), generator=g, device=dev,
                           dtype=torch.int8) for K in (576, 1536)}
    ws = [RNSTensor(residues=torch.randint(0, 37, (5, K, N), generator=g,
                                           device=dev, dtype=torch.int8),
                    scale=None, basis=basis_for_int8_matmul(K), bound=128)
          for K, N in LAYER]

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / n * 1e3)
        return sorted(times)[2]

    def layer():
        for (K, _), w in zip(LAYER, ws):
            rns_fused_matmul(xs[K], w)

    with rf._pin_tile_rows(rf.TM_WG):
        return {"layer_us": [timed(layer, 5) for _ in range(2)],
                "n1536_us": timed(lambda: rns_fused_matmul(xs[576], ws[4]),
                                  20)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--variant":
        print(json.dumps(run(sys.argv[2])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("wg_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    build()
    print(f"wg_phases: built {len(VARIANTS)} variants in "
          f"{time.perf_counter() - t0:.1f} s | on {smi}")
    out = {}
    for name in VARIANTS:
        r = subprocess.run([sys.executable, __file__, "--variant", name],
                           capture_output=True, text=True, timeout=300)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
        v = out[name]
        print(f"wg_phases: {name}: one layer's 7 launches at M=512 "
              f"{' / '.join(f'{t:.1f}' for t in v['layer_us'])} us, the "
              f"N=1536 launch {v['n1536_us']:.1f} us")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
