#!/usr/bin/env python3
"""Where a 16-row tile launch spends its time, phase by phase, on one GPU.

    python3 tile_phases.py          # from a checkout, one card

Copies `src/repro_torch` to `build/tile_phases/` and adds timer stamps to
that copy of the 16-row tile kernel (`csrc/rns_common.cuh`, `dp4a_tile`):
thread 0 of every block writes %globaltimer and clock64() at the kernel's
start, after the prologue (first weights landed, step 0 converted), after
the K loop, after the split-K gather, after the mbarrier wait (the other
ranks' sums are in), after the epilogue and after the closing cluster
barrier, each behind a __syncthreads() where a phase ends at a barrier of
the block.  The copy is built and the decode launches of one smollm layer
run on it (M = 8 lanes), with a one-channel CRT slice, the gated down
projection and a prefill launch pinned to the 16-row tile.  For each:
the device time per launch (CUDA-graph replay, weights read cold, as
`chip_smoke.py` measures it), and the median over blocks of each phase's
SM cycles on the second of two launches.  The stamps add barriers, so
the phases sum to somewhat more than an unstamped launch takes.  The
package itself is not changed.  Exits non-zero without a CUDA device or
if a stamp no longer finds its place in the kernel source.
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(ROOT, "build", "tile_phases")
PHASES = ["prologue", "loop", "gather", "copies in", "epilogue",
          "cluster exit"]

# (anchor in csrc/rns_common.cuh, text put after it); slots 0-7
STAMPS = [
    ("  int w16;               // N % 16 == 0 and w 16-byte aligned: "
     "cp.async rows\n", "  unsigned long long* stamps;\n"),
    ("  Dp4aW<C, ENCODED> wreg;\n", "  stamp(a, 0, false);\n"),
    ("  __syncthreads();\n  for (int s = 0; s < steps; ++s) {\n", None),
    ("    __syncthreads();   // buffer s+1 complete; buffer s free\n  }\n",
     "  stamp(a, 2, false);\n"),
    ("  __syncthreads();  // the gather is complete\n",
     "  stamp(a, 3, false);\n"),
    ("  mbar_wait(mbar, 0);   // every other rank's sums of this rank's "
     "elements\n", "  stamp(a, 4);\n"),
]
STAMP_FN = """
__device__ __forceinline__ void stamp(const TileArgs& a, int slot,
                                      bool sync = true) {
  if (sync) __syncthreads();
  if (threadIdx.x == 0 && a.stamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
    if (b < 4096) {
      a.stamps[b * 16 + slot] = t;
      a.stamps[b * 16 + 8 + slot] = clock64();
    }
  }
}

template <int C, int AM, bool ENCODED>
__device__ __forceinline__ void dp4a_tile("""


def _patch(path, pairs):
    with open(path) as fh:
        text = fh.read()
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"tile_phases: {os.path.basename(path)} no "
                             f"longer has one {old.strip()[:60]!r}")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)


def make_copy():
    """The stamped copy of the package under build/tile_phases/src."""
    shutil.rmtree(COPY, ignore_errors=True)
    src = os.path.join(COPY, "src", "repro_torch")
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"), src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cuh = os.path.join(src, "csrc", "rns_common.cuh")
    pairs = [(old, old + new) for old, new in STAMPS if new]
    loop = STAMPS[2][0]
    pairs += [
        (loop, loop.replace("  for (int s", "  stamp(a, 1, false);\n"
                            "  for (int s")),
        ("\ntemplate <int C, int AM, bool ENCODED>\n"
         "__device__ __forceinline__ void dp4a_tile(", STAMP_FN),
        ("        tile_epilogue<C>(acc[i], m0 + r, n0 + tn, a, plan);\n"
         "      }\n    }\n    return;",
         "        tile_epilogue<C>(acc[i], m0 + r, n0 + tn, a, plan);\n"
         "      }\n    }\n    stamp(a, 5);\n    return;"),
        ("  cluster_wait();   // every block has received its slices\n}",
         "  stamp(a, 5);\n  cluster_wait();   // every block has received "
         "its slices\n  stamp(a, 6, false);\n}"),
    ]
    _patch(cuh, pairs)
    kern = os.path.join(src, "kernels")
    _patch(os.path.join(kern, "_build.py"), [
        ('("w16", ctypes.c_int)]',
         '("w16", ctypes.c_int),\n                ("stamps", ctypes.c_void_p)]'),
        ('parents[3] / "build" / "torch_ext"', 'parents[3] / "torch_ext"')])
    _patch(os.path.join(kern, "rns_fused.py"), [
        ("tile_launches = {TM: 0, TM_MMA: 0}\n",
         "tile_launches = {TM: 0, TM_MMA: 0}\nSTAMPS = None  # phase buffer\n"),
        ("    args.encoded, args.emit, args.tm = int(w.ndim == 3), emit, tm\n",
         "    args.encoded, args.emit, args.tm = int(w.ndim == 3), emit, tm\n"
         "    if STAMPS is not None:\n"
         "        args.stamps = STAMPS.data_ptr()\n")])
    return os.path.join(COPY, "src")


def phases(torch, rf, launch, nblocks):
    """Median SM cycles of each phase over the blocks of the second of
    two launches, and the span of that launch in microseconds."""
    rf.STAMPS = torch.zeros(4096 * 16, dtype=torch.int64, device="cuda")
    for _ in range(2):
        rf.STAMPS.zero_()
        launch(0)
        torch.cuda.synchronize()
    st = rf.STAMPS.view(4096, 16)[:nblocks].cpu().double()
    rf.STAMPS = None
    gt, ck = st[:, :8], st[:, 8:]
    live = gt[:, 0] > 0
    gt, ck = gt[live], ck[live]
    out = {}
    for j, name in enumerate(PHASES):
        a, b = ck[:, j], ck[:, j + 1]
        ok = (a > 0) & (b > 0)
        if name == "epilogue" and not ok.any():   # unsplit: loop -> end
            a, b, ok = ck[:, 2], ck[:, 5], (ck[:, 2] > 0) & (ck[:, 5] > 0)
        if ok.any():
            out[name] = float((b - a)[ok].median())
    end = gt[:, 1:].max(dim=1).values
    out["span_us"] = float((end.max() - gt[:, 0].min()) / 1e3)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, make_copy())
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core.quant import quant_scale
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
    from repro_torch.core.rns_tensor import RNSTensor, encode, \
        encode_activation
    from repro_torch.dist.rns_shard import channel_partials
    from repro_torch.kernels import rns_fused_matmul, rns_matmul
    from repro_torch.kernels import rns_fused as rf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def blocks(M, K, N):
        return -(-N // 64) * -(-M // 16) * rf._split_k(M, K, N, sms)[0]

    def pool(C, K, N):
        return cs._copies(lambda: torch.randint(0, 31, (C, K, N),
                                                dtype=torch.int8,
                                                device=dev), C * K * N)

    cases = []
    for M, K, N in ((8, 576, 192), (8, 576, 1536), (8, 1536, 576)):
        basis = basis_for_int8_matmul(K)
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        sx, scol, ws = quant_scale(x), torch.ones(1, N, device=dev), \
            pool(5, K, N)
        cases.append((f"fused bf16 C=5 M={M} K={K} N={N}", blocks(M, K, N),
                      len(ws), lambda i, x=x, ws=ws, b=basis, sx=sx, sc=scol:
                      rns_fused_matmul(x, ws[i], b, scale_row=sx,
                                       scale_col=sc)))
        a = torch.randint(-128, 128, (1, M, K), generator=g, device=dev,
                          dtype=torch.int8)
        cases.append((f"rns_matmul broadcast C=5 M={M} K={K} N={N}",
                      blocks(M, K, N), len(ws),
                      lambda i, a=a, ws=ws, m=basis.moduli:
                      rns_matmul(a, ws[i], m, signed_a=True)))
    K = N = 576
    wt = encode(torch.randn(K, N, generator=g, device=dev) / 24)
    x = torch.randn(8, K, generator=g, device=dev).to(torch.bfloat16)
    sx, ws = quant_scale(x), pool(5, K, N)
    cases.append(("crt one-channel slices M=8 K=576 N=576 (stamps: the "
                  "last of 5)", blocks(8, K, N), len(ws),
                  lambda i, x=x, ws=ws, sx=sx: channel_partials(
                      x, RNSTensor(ws[i], wt.scale, wt.basis), 5,
                      scale_row=sx)))
    basis = basis_for_chain(1536)
    K, N = 1536, 576
    xa = encode_activation(torch.randn(8, K, generator=g, device=dev), basis)
    gate = torch.randint(-127, 128, (8, K), generator=g, device=dev,
                         dtype=torch.int8)
    scol, ws = torch.ones(1, N, device=dev), pool(7, K, N)
    cases.append(("gated down C=7 M=8 K=1536 N=576", blocks(8, K, N),
                  len(ws), lambda i, ws=ws, sc=scol, b=basis:
                  rns_fused_matmul(xa, RNSTensor(ws[i], sc, b),
                                   scale_row=xa.scale, scale_col=sc,
                                   gate=gate)))
    M, K, N = 512, 576, 576
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    sx, scol, ws = quant_scale(x), torch.ones(1, N, device=dev), \
        pool(5, K, N)
    basis = basis_for_int8_matmul(K)
    cases.append(("fused bf16 C=5 M=512 K=576 N=576 (16-row pinned)",
                  blocks(M, K, N), len(ws),
                  lambda i: rns_fused_matmul(x, ws[i], basis, scale_row=sx,
                                             scale_col=scol)))

    print(f"tile_phases: {torch.cuda.get_device_name(0)} | {smi}")
    for name, nblocks, n, launch in cases:
        with rf._pin_tile_rows(rf.TM):
            us = 1e3 * cs.device_ms(launch, n)
            ph = phases(torch, rf, launch, nblocks)
        parts = ", ".join(f"{k} {ph[k]:.0f}" for k in PHASES if k in ph)
        print(f"{name}: {us:.2f} us a launch (graph replay, cold "
              f"weights); stamped block span {ph['span_us']:.2f} us; "
              f"median SM cycles: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
