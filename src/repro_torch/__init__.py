"""PyTorch/CUDA port of the twit-RNS framework for NVIDIA Hopper.

A second package beside the JAX reference (`repro`): the same module layout
and names, PyTorch idiom inside.  It imports torch, numpy and the standard
library only.  The hot path runs hand-written CUDA kernels
(`kernels/rns_fused.py`, `kernels/rns_convert.py`, sources under `csrc/`);
every kernel has a plain PyTorch version in `kernels/ref.py` that a wrapper
takes only for tensors that lie on the CPU.

Entry points default to ``device="cuda"``; the CPU is used only when the
caller asks for it.
"""
