"""Wire bytes of the two sharded layouts, and the collective helper, port
of `repro/dist/comms.py`.

Per launch over an ``n``-way "model" axis (ring-collective formulas, the
2(n−1)/n and (n−1)/n factors `launch.costs` uses):

  channel (split C) — ONE all-reduce of the (L1, M, N) int32 CRT limb
                      planes: 2(n−1)/n · L1·M·N·4 bytes.  ``emit=
                      "residues"`` launches replicate under this layout
                      (re-encoding needs every modulus): 0 bytes.
  column  (split N) — a gather of the float (M, N) output, (n−1)/n ·
                      M·N·4 bytes, or of the (C, M, N) residue slab for
                      ``emit="residues"``: (n−1)/n · C·M·N·item.

`choose_layout` picks the cheaper feasible layout of one launch, channel
on a tie.  `collective_wire_bytes` prices what a traced call really ran
(`analysis.residency.TraceSummary.collectives`).

`all_reduce` is the one collective the sharded launches use (the column
gather is a scatter into zeros and a sum).  ``gloo`` takes CUDA tensors for
``all_reduce``, but the helper stages a CUDA operand through host memory
itself, explicitly: one copy out, the host collective, one copy back;
`transport` names what a group does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["channel_bytes", "column_bytes", "choose_layout",
           "collective_wire_bytes", "all_reduce", "transport",
           "ALL_REDUCE"]

_F32 = 4
_INT32 = 4
# the name `analysis.residency.TraceMode` records an all-reduce under
ALL_REDUCE = "all_reduce"


def _ar(nbytes: float, n: int) -> float:
    """Ring all-reduce wire bytes a device for an nbytes buffer."""
    return 2.0 * (n - 1) / n * nbytes if n > 1 else 0.0


def _ag(nbytes: float, n: int) -> float:
    """Ring all-gather wire bytes a device (nbytes = the GATHERED size)."""
    return (n - 1) / n * nbytes if n > 1 else 0.0


def channel_bytes(M: int, N: int, nlimbs: int, ndev: int, *,
                  emit: str = "float") -> float:
    """Wire bytes of ONE channel-sharded launch (the limb all-reduce)."""
    if emit == "residues":
        return 0.0       # replicated launch: residues never cross
    return _ar(float(nlimbs) * M * N * _INT32, ndev)


def column_bytes(C: int, M: int, N: int, ndev: int, *, emit: str = "float",
                 itemsize: int = 4) -> float:
    """Wire bytes of ONE column-sharded launch (the gather at the exit)."""
    if emit == "residues":
        return _ag(float(C) * M * N * itemsize, ndev)
    return _ag(float(M) * N * _F32, ndev)


def choose_layout(*, C: int, M: int, N: int, nlimbs: int, ndev: int,
                  emit: str = "float", itemsize: int = 4) -> str:
    """The feasible layout of least wire bytes for one launch.

    Divisibility decides feasibility (C % n for channels, N % n for
    columns); the smaller wire cost wins, channel on a tie (it also splits
    the weight residues' memory C ways).  Neither feasible → "replicate".
    """
    cand = []
    if C % ndev == 0:
        cand.append((channel_bytes(M, N, nlimbs, ndev, emit=emit), 0,
                     "channel"))
    if N % ndev == 0:
        cand.append((column_bytes(C, M, N, ndev, emit=emit,
                                  itemsize=itemsize), 1, "column"))
    if not cand:
        return "replicate"
    return min(cand)[2]


def collective_wire_bytes(summary, ndev: int) -> float:
    """Ring-model wire bytes of every collective a traced call ran.

    ``summary`` is an `analysis.residency.TraceSummary`, whose
    ``collectives`` hold each collective's name and operands (shape,
    dtype).  An all-reduce operand is full-sized on every device (the
    all-reduce cost); any other collective is priced as a gather of ndev
    operands."""
    total = 0.0
    for name, operands in summary.collectives:
        nbytes = sum(float(np.prod(shape, dtype=np.float64))
                     * np.dtype(dtype).itemsize for shape, dtype in operands)
        if name == ALL_REDUCE:
            total += _ar(nbytes, ndev)
        else:
            total += _ag(nbytes * ndev, ndev)
    return total


def transport(group, device) -> str:
    """How `all_reduce` moves a tensor on ``device`` over ``group``."""
    import torch.distributed as dist

    backend = str(dist.get_backend(group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo, CUDA operands staged through host memory"
    return backend


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (``op`` "sum" or "max") and
    return it.  A CUDA tensor over a ``gloo`` group is copied to host
    memory, reduced there and copied back."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = t.to("cpu")
        dist.all_reduce(host, op=red, group=group)
        t.copy_(host)
        return t
    dist.all_reduce(t, op=red, group=group)
    return t
