"""The distribution context, port of `repro/dist/context.py`.

`serve.Engine` (and tests) activate a :class:`DistContext` around prefill
and decode; the fused branches of `core.rns_linear` read :func:`current`
on every call and route their launches through
`repro_torch.dist.rns_shard.sharded_fused_matmul` while one is active.
Eager torch has no trace, so the context is read at call time, where the
reference reads it at trace time.  A context, not an argument threaded
through the model, so the same model code runs sharded and unsharded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional

__all__ = ["DistContext", "current", "use", "LAYOUTS"]

LAYOUTS = ("auto", "channel", "column")


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The mesh and the layout preference of sharded fused launches.

    ``mesh`` is a `launch.mesh.Mesh` (or anything with ``shape`` by axis
    name and ``axis_names``: the layout rules read only those).
    ``layout="auto"`` lets the `comms` cost model choose per launch;
    "channel" / "column" prefer one partitioning, which a launch whose C
    (or N) the ``axis`` size does not divide gives up for the other, then
    for the plain replicated launch.
    """

    mesh: Any
    layout: str = "auto"
    axis: str = "model"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, "
                             f"got {self.layout!r}")
        if self.axis not in tuple(self.mesh.axis_names):
            raise ValueError(f"mesh has axes {tuple(self.mesh.axis_names)}, "
                             f"no {self.axis!r}")

    @property
    def nshards(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def rank(self) -> int:
        """This process's index along ``axis`` (its shard)."""
        return int(self.mesh.index(self.axis))

    @property
    def group(self):
        """The process group of ``axis`` that this process belongs to."""
        return self.mesh.group(self.axis)


_CURRENT: Optional[DistContext] = None


def current() -> Optional[DistContext]:
    """The active context, or None (the one-process path)."""
    return _CURRENT


@contextlib.contextmanager
def use(ctx: Optional[DistContext]) -> Iterator[Optional[DistContext]]:
    """Activate ``ctx`` for the calls made inside (re-entrant)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev
