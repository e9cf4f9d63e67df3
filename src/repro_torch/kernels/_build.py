"""Build and load the port's CUDA kernels (`csrc/*.cu`, `csrc/*.cuh`).

Each ``.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into an object,
all of them at once in parallel processes, and the objects are linked into
one shared library with a plain C interface, loaded with ctypes.  The
library lands in ``build/torch_ext/`` at the root of the checkout, named by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  The build happens at first use — the first
launch on a CUDA tensor — never at import.  A failed build raises; nothing
falls back.

`graph_kernels` counts the kernel nodes of a captured CUDA graph by
function name through `libcuda` (the `cu*` graph calls), loaded the same way.

`Plan` and `TileArgs` mirror the structs of `csrc/rns_common.cuh` field for
field, `FlashArgs` the one of `csrc/flash_common.cuh`; `plan_struct`
fills a `Plan` from a fold plan and a conversion plan.

`kernel_region` marks each kernel wrapper, the counterpart of a
``pallas_call`` in a jaxpr, for the trace passes of
`repro_torch.analysis`: an observer (`add_observer`) hears each outermost
wrapper call begin and end, and `region_depth` tells a dispatch mode
whether an op runs inside one (the plain version's ops on the CPU; on the
card the ctypes launch is invisible to dispatch).  A wrapper given a
DTensor runs on its local shards by the entry's rule
(`kernels/dtensor_rules.py`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.core import multiword as mw

from . import dtensor_rules

__all__ = ["build", "library", "check", "plan_struct", "set_moduli", "Plan",
           "TileArgs", "FlashArgs", "BUILD_DIR", "SOURCES", "graph_kernels",
           "kernel_region", "region_depth", "add_observer",
           "remove_observer"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
# No --use_fast_math: the float epilogues need IEEE divides and no FMA
# contraction to stay bit-equal to the reference.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAXC, MAXR, MAXL, MAXSUB = 12, 8, 6, 4


class _Depth(threading.local):
    depth = 0


_region = _Depth()
# objects with enter(name, args, kwargs) and exit(name, out), told of each
# outermost region; process-wide, since autograd runs a CUDA backward (and
# the recompute of a checkpointed layer) on its own device thread
_observers: list = []


def region_depth() -> int:
    """How many kernel wrappers the calling thread is inside."""
    return _region.depth


def add_observer(obs) -> None:
    _observers.append(obs)


def remove_observer(obs) -> None:
    _observers.remove(obs)


def kernel_region(name: str):
    """Decorate a kernel wrapper: each call is a region of the calling
    thread, and the outermost one is reported to the observers.  With none
    registered it costs one thread-local increment and touches nothing on
    the device, so a captured CUDA graph holds the same kernels."""
    def wrap(fn):
        @functools.wraps(fn)
        def region(*args, **kwargs):
            depth = _region.depth
            if not depth and dtensor_rules.has_dtensor(args, kwargs):
                return dtensor_rules.run(name, region, args, kwargs)
            _region.depth = depth + 1
            try:
                if depth or not _observers:
                    return fn(*args, **kwargs)
                for obs in tuple(_observers):
                    obs.enter(name, args, kwargs)
                out = fn(*args, **kwargs)
                for obs in tuple(_observers):
                    obs.exit(name, out)
                return out
            finally:
                _region.depth = depth
        return region
    return wrap


class Plan(ctypes.Structure):
    _fields_ = [("C", ctypes.c_int), ("R", ctypes.c_int),
                ("n_sub", ctypes.c_int), ("L", ctypes.c_int),
                ("is_signed", ctypes.c_int),
                ("mods", ctypes.c_int * MAXC),
                ("sched_s", (ctypes.c_int * MAXR) * MAXC),
                ("sched_c", (ctypes.c_int * MAXR) * MAXC),
                ("inv", (ctypes.c_int * MAXC) * MAXC),
                ("M_limbs", ctypes.c_int * MAXL),
                ("half_limbs", ctypes.c_int * MAXL),
                ("L1", ctypes.c_int),
                ("crt_v", ctypes.c_int * MAXC),
                ("crt_mc", (ctypes.c_int * MAXL) * MAXC),
                ("mu", ctypes.c_uint * MAXC),
                ("madd", ctypes.c_int * MAXC)]


class TileArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("srow", ctypes.c_void_p),
                ("gate", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("scol", ctypes.c_void_p), ("creq", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("M", ctypes.c_int), ("K", ctypes.c_int),
                ("N", ctypes.c_int), ("splits", ctypes.c_int),
                ("k_per_split", ctypes.c_int), ("vec", ctypes.c_int),
                ("encoded", ctypes.c_int), ("emit", ctypes.c_int),
                ("tm", ctypes.c_int), ("avec", ctypes.c_int),
                ("w16", ctypes.c_int)]


class FlashArgs(ctypes.Structure):
    _fields_ = [("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("pad", ctypes.c_void_p), ("qpos", ctypes.c_void_p),
                ("kpos", ctypes.c_void_p),
                ("B", ctypes.c_int), ("H", ctypes.c_int),
                ("Sq", ctypes.c_int), ("Sk", ctypes.c_int),
                ("D", ctypes.c_int), ("causal", ctypes.c_int),
                ("has_window", ctypes.c_int), ("window", ctypes.c_int),
                ("has_softcap", ctypes.c_int), ("bf16", ctypes.c_int),
                ("scale", ctypes.c_float), ("softcap", ctypes.c_float),
                ("route", ctypes.c_int), ("splits", ctypes.c_int)]


def set_moduli(st: Plan, mods) -> None:
    """The moduli of a `Plan` with what the kernels' divide-free mods read:
    mu_j = floor(2^32 / m_j) and madd_j, the least multiple of m_j that is
    at least 128 and every modulus (it lifts an int8 value, or a canonical
    residue minus another channel's, to a non-negative operand)."""
    bound = max(128, *mods)
    for j, m in enumerate(mods):
        if not 2 <= m <= 1 << 15:
            raise ValueError(f"modulus {m} is outside the kernels' 2..2^15")
        st.mods[j] = m
        st.mu[j] = (1 << 32) // m
        st.madd[j] = -(-bound // m) * m


def plan_struct(plan, conv) -> Plan:
    """The kernel's plan tables from a `ChannelPlan` (fold ladder; None for
    the reverse kernel, which does not fold) and a `ConversionPlan` (MRC
    inverses, limb constants; None for a kernel that only folds)."""
    ref = plan if plan is not None else conv
    C = len(ref.moduli)
    R = plan.num_rungs if plan is not None else 0
    L = conv.nlimbs if conv is not None else 0
    n_sub = plan.n_sub if plan is not None else 0
    if not 1 <= C <= MAXC or R > MAXR or L > MAXL or n_sub > MAXSUB:
        raise ValueError(f"plan (C={C}, R={R}, L={L}, n_sub={n_sub}) is "
                         "outside the kernels' tables")
    st = Plan()
    st.C, st.R, st.L = C, R, L
    if plan is not None:
        st.n_sub, st.is_signed = plan.n_sub, int(plan.signed)
    set_moduli(st, ref.moduli)
    for j in range(C):
        if plan is not None:
            for r, (s, c) in enumerate(plan.rungs[j]):
                st.sched_s[j][r] = s
                st.sched_c[j][r] = c
        if conv is not None:
            for i in range(C):
                st.inv[j][i] = conv.inv_rows[j][i]
    if conv is not None:
        for l, v in enumerate(mw.to_limbs_const(conv.M, L)):
            st.M_limbs[l] = v
        for l, v in enumerate(mw.to_limbs_const(conv.half, L)):
            st.half_limbs[l] = v
    return st


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def build() -> tuple[Path, str]:
    """Compile the library if needed; returns (path, compiler output)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        digest.update(path.name.encode() + path.read_bytes())
    so = BUILD_DIR / f"librns_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]

    def compile_one(src, obj):
        t0 = time.perf_counter()
        done = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], capture_output=True, text=True)
        return done, time.perf_counter() - t0

    # one thread a source, each waiting on its own nvcc: all compile at
    # once, and each file's wall time is its own
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        runs = list(pool.map(compile_one, SOURCES, objs))
    logs = []
    failed = []
    for src, (done, secs) in zip(SOURCES, runs):
        logs.append(f"== {src.name} ({secs:.1f} s)\n{done.stdout}"
                    f"{done.stderr}")
        if done.returncode != 0:
            failed.append(f"{src.name} ({done.returncode}):\n"
                          f"{done.stderr}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    os.replace(tmp, so)                 # atomic: concurrent builders agree
    return so, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with its C signatures declared."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rns_tile_launch.argtypes = [i, p, p, p]
    lib.rns_forward_launch.argtypes = [p, i, p, i, ll, ll, i, p, i, i, p]
    lib.rns_reverse_launch.argtypes = [p, p, p, p, ll, ll, i, p, i, i, p]
    lib.rns_modmul_launch.argtypes = [p, p, i, p, i, ll, ll, i, i, p, i,
                                      i, p]
    lib.rns_fold_launch.argtypes = [p, p, i, p, i, p]
    lib.flash_attention_launch.argtypes = [p, p]
    lib.rns_tile16_smem.argtypes = [i, i, i]
    for fn in (lib.rns_tile_launch, lib.rns_tile16_smem,
               lib.rns_forward_launch,
               lib.rns_reverse_launch, lib.rns_modmul_launch,
               lib.rns_fold_launch, lib.flash_attention_launch):
        fn.restype = i
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned an error code."""
    if rc == -1:
        raise ValueError(f"{name}: channel count, head size or mode not "
                         "compiled into the kernel library")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


@functools.lru_cache(maxsize=16)
def num_sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of `cuda.h`."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("sharedMemBytes", ctypes.c_uint),
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_KERNEL_NODE = 0                      # CU_GRAPH_NODE_TYPE_KERNEL


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    """`libcuda`, loaded once (process-wide: it names the kernels of this
    library, which links its own runtime, and torch's alike)."""
    drv = ctypes.CDLL("libcuda.so.1")
    p, s = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    drv.cuGraphGetNodes.argtypes = [p, ctypes.POINTER(p), s]
    drv.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    drv.cuGraphKernelNodeGetParams_v2.argtypes = [
        p, ctypes.POINTER(_KernelNodeParams)]
    name = ctypes.POINTER(ctypes.c_char_p)
    drv.cuFuncGetName.argtypes = [name, p]
    drv.cuKernelGetName.argtypes = [name, p]
    for fn in (drv.cuGraphGetNodes, drv.cuGraphNodeGetType,
               drv.cuGraphKernelNodeGetParams_v2, drv.cuFuncGetName,
               drv.cuKernelGetName):
        fn.restype = ctypes.c_int
    return drv


def _drv_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def graph_kernels(graph) -> dict:
    """{kernel function name: nodes} of a captured ``torch.cuda.CUDAGraph``
    made with ``keep_graph=True``: the kernels one replay launches, read
    from the graph itself (no profiler).  Names are as compiled (mangled
    C++ names)."""
    drv = _libcuda()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _drv_check(drv.cuGraphGetNodes(g, None, ctypes.byref(n)),
               "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _drv_check(drv.cuGraphGetNodes(g, nodes, ctypes.byref(n)),
               "cuGraphGetNodes")
    out: dict = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _drv_check(drv.cuGraphNodeGetType(node, ctypes.byref(kind)),
                   "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        prm = _KernelNodeParams()
        _drv_check(drv.cuGraphKernelNodeGetParams_v2(node,
                                                     ctypes.byref(prm)),
                   "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if prm.func:
            _drv_check(drv.cuFuncGetName(ctypes.byref(name), prm.func),
                       "cuFuncGetName")
        else:
            _drv_check(drv.cuKernelGetName(ctypes.byref(name), prm.kern),
                       "cuKernelGetName")
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out
