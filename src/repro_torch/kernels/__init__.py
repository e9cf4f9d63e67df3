"""Hand-written CUDA kernels of the port, each with a plain PyTorch version
in `ref.py`:

  rns_fused_matmul — Stage ②–⑤ in one launch (quantize + float-emit
                     variant of the reference megakernel)
  rns_forward      — forward conversion (binary → residue planes)

Each wrapper runs its plain version for CPU tensors, launches the kernel
for CUDA tensors, and counts its launches in ``<wrapper>.launches``.
"""
from . import ref  # noqa: F401
from .rns_convert import rns_forward  # noqa: F401
from .rns_fused import rns_fused_matmul  # noqa: F401

__all__ = ["ref", "rns_forward", "rns_fused_matmul"]
