"""Build and load the port's CUDA kernels (`csrc/rns_kernels.cu`).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ctypes.  The library lands in
``build/torch_ext/`` at the root of the checkout, named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused.  The build happens at first use — the first launch on a CUDA tensor
— never at import.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "library", "check", "BUILD_DIR", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rns_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
# No --use_fast_math: the float epilogue needs IEEE divides and no FMA
# contraction to stay bit-equal to the reference.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"librns_kernels_{digest[:16]}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)                 # atomic: concurrent builders agree
    return so, proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with its C signatures declared."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rns_fused_matmul_launch.argtypes = [p, i, p, p, i, p, p, p, p, i, i,
                                            i, i, i, i, p, p]
    lib.rns_fused_matmul_launch.restype = i
    lib.rns_forward_launch.argtypes = [p, i, p, i, ll, p, i, p]
    lib.rns_forward_launch.restype = i
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned an error code."""
    if rc == -1:
        raise ValueError(f"{name}: channel count not compiled into the "
                         "kernel library")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
