"""Hand-written CUDA kernels of the port, each with a plain PyTorch version
in `ref.py`:

  rns_fused_matmul      — Stage ②–⑤ in one launch: the quantize or
                          residue-in (optionally gated) prologue, float or
                          in-domain requantize (``emit="residues"``)
                          epilogue
  rns_fused_crt_partial — the same tile kernel on a channel slice of the
                          basis, writing the slice's CRT partial sum as
                          (L1, M, N) 15-bit limb planes
  rns_matmul            — staged per-channel residue matmul into canonical
                          int32 residues (broadcast signed or canonical
                          operand)
  rns_modmul            — elementwise |a·b|_m over residue planes
  rns_forward           — forward conversion (binary → residue planes)
  rns_reverse           — MRC reverse conversion (residue planes → float32)
  fold                  — standalone Stage ④: (C, S) int32 values below a
                          bound → canonical residues
  flash_attention       — blocked online-softmax attention (causal,
                          window, softcap, pad or explicit positions),
                          any head size (above 256 on its wide route)
  tune                  — persisted (tile height, K split) autotuner of
                          the tile kernel behind the first three

Each wrapper runs its plain version for CPU tensors, launches the kernel
for CUDA tensors (counting its launches in ``<wrapper>.launches``), returns
an empty output of the plain version's shape and dtype for meta tensors (a
dry run), runs on the local shards of DTensor arguments by its entry's
sharding rule (`dtensor_rules`, the mesh dry run and the sharded train
step), and is a kernel region (`_build.kernel_region`) of the trace
passes of `repro_torch.analysis`.
"""
from . import ref, tune  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .fold import fold  # noqa: F401
from .rns_convert import rns_forward, rns_reverse  # noqa: F401
from .rns_fused import rns_fused_crt_partial, rns_fused_matmul  # noqa: F401
from .rns_matmul import rns_matmul  # noqa: F401
from .rns_modmul import rns_modmul  # noqa: F401

__all__ = ["ref", "tune", "rns_forward", "rns_reverse", "rns_fused_matmul",
           "rns_fused_crt_partial", "rns_matmul", "rns_modmul", "fold",
           "flash_attention"]
