"""Meshes over `torch.distributed` process groups, port of
`repro/launch/mesh.py`.

A :class:`Mesh` is a `torch.distributed.device_mesh.DeviceMesh` with the
reference's view of it: ``shape`` by axis name and ``axis_names``, which
is all the sharding rules (`launch/sharding.py`) and the distribution
context (`dist/context.py`) read, plus this process's index and process
group along an axis.  Both constructors take a process group the caller has
already initialised (``torch.distributed.init_process_group``); nothing
here starts one, and importing this module touches no device.

Axis roles, the reference's: ``pod`` — the slowest dimension, data
parallel; ``data`` — data parallel / FSDP; ``model`` — tensor parallel,
the axis sharded launches split.  The production shapes are the
reference's TPU v5e pods (16×16, or 2×16×16 across two pods).

:func:`fake_production_mesh` is the mesh dry run's (`launch/dryrun.py`): it
initialises torch's ``fake`` process group (every rank's collectives
return at once, without data; tensors on the meta device never move), of
256 or 512 ranks with this process as rank 0, yields the production mesh
over it, and destroys the group on exit, an error included.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh", "dp_axes",
           "fake_production_mesh", "DP_AXES", "MODEL_AXIS"]

MODEL_AXIS = "model"
DP_AXES = ("pod", "data")


class Mesh:
    """A device mesh by axis name.  ``shape`` maps each axis to its size;
    ``device_mesh`` is the `DeviceMesh` over the initialised group (None
    for a shape-only mesh, which the rules accept but which has no index
    or group)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.device_mesh = device_mesh

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of ``axis`` holding this process."""
        if self.device_mesh is None:
            raise ValueError("a shape-only mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _build(shape: Tuple[int, ...], axes: Tuple[str, ...],
           device_type: str = "cpu") -> Mesh:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} processes, the group has "
                         f"{world}")
    # the mesh follows the group's backend; a "cpu" mesh never asks for a
    # CUDA backend of its own (gloo moves CUDA operands itself)
    dm = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                    mesh_dim_names=axes)
    return Mesh(dict(zip(axes, shape)), dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: ("data", "model") = (16, 16), or
    ("pod", "data", "model") = (2, 16, 16) with ``multi_pod``; raises
    unless the initialised group has 256 (resp. 512) processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes)


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False,
                         split: Optional[Tuple[int, int]] = None
                         ) -> Iterator[Mesh]:
    """The production mesh over a ``fake`` process group of 256 ranks (512
    with ``multi_pod``) initialised here, this process rank 0; the group
    is destroyed on exit.  ``split`` = (data, model) refactors the same
    pod(s) logically, e.g. (64, 4), as the reference's ``--mesh-split``.
    Raises if a process group is already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake mesh needs its own")
    dd, mm = split or (16, 16)
    shape = (2,) * multi_pod + (int(dd), int(mm))
    axes = ("pod",) * multi_pod + ("data", "model")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield (make_production_mesh(multi_pod=multi_pod) if split is None
               else _build(shape, axes))
    finally:
        dist.destroy_process_group()


def make_host_mesh(model: int = 1, device_type: str = "cpu") -> Mesh:
    """("data", "model") = (world // model, model) over every process of
    the initialised group; raises when ``model`` does not divide the
    world size.  ``device_type`` is the `DeviceMesh`'s: "cpu" (the
    default; the sharded engine's gloo collectives move CUDA operands
    themselves), or "cuda" for DTensors on the card (the sharded train
    step on an NCCL group, one card a rank)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide the {n} "
                         "available processes")
    return _build((n // model, model), ("data", "model"), device_type)


def dp_axes(mesh) -> tuple:
    """The data-parallel axis names of a mesh (all but "model")."""
    return tuple(a for a in tuple(mesh.axis_names) if a != MODEL_AXIS)
