"""repro_torch.dist — sharded serving of the RNS datapath on
`torch.distributed`, port of `repro/dist/`, one process a rank.

The residue channel axis C is embarrassingly parallel, so a fused launch
splits two ways over the mesh's "model" axis:

  channel — split C; each rank runs its own fold ladder and a CRT-partial
            epilogue, and ONE all-reduce of narrow limb planes combines
            them.  Residues never cross between ranks.
  column  — split N; the full basis on every rank, a gather at the exit.

`context` carries the mesh and layout switch the core linear reads;
`comms` is the wire-bytes model that picks a layout per launch and the
collective helper; `rns_shard` the sharded launch (bit-equal to the
one-process launch) and the collective-free channel slices; `engine` the
mesh check and the one-time sharded weight encode `serve.Engine` uses.

Import-light on purpose: `core.rns_linear` imports `repro_torch.dist.
context` on every fused launch, so nothing heavier than the stdlib loads
here.
"""
from .context import DistContext, current, use

__all__ = ["DistContext", "current", "use"]
