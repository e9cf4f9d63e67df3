"""Atomic checkpoints, port of `repro/train/checkpoint.py`, in the
reference's on-disk layout:

    <dir>/step-<N>/manifest.json   {"step", "treedef", "n_leaves",
                                    "dtypes", "shapes"}
    <dir>/step-<N>/<i>.npy         leaf i, in `jax.tree.flatten`'s order
                                   (a dict's keys sorted, recursively)

so either package reads the other's checkpoints, optimizer moments
included.  bfloat16 leaves are written as 2-byte void records with
"bfloat16" in the manifest's ``dtypes``, which is what numpy writes for
the reference's bfloat16 arrays, and read back through an int16 view
(no ``ml_dtypes``).  The port writes no ``treedef`` (null): restoring
takes the structure from ``like``, in both packages.

  * atomic  — a save writes ``tmp-<N>`` and renames it to ``step-<N>``
              once the manifest is written, so a crash mid-save never
              leaves a partial ``step-<N>``;
  * async   — ``blocking=False`` copies the leaves to host memory at once
              and writes them in a daemon thread (`wait_for_pending`);
  * bounded — ``keep_last`` keeps the newest checkpoints;
  * meshes  — a tree of DTensors (a mesh run) is gathered leaf by leaf
              (``full_tensor``, a collective every rank of the mesh joins)
              and written once, by rank 0, blocking, as whole tensors: the same
              files a one-process run writes.  `restore` always returns
              whole tensors; a mesh run places them again (`train.runtime.
              TrainLoop`'s ``shard_fn``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .tree import leaves, unflatten

__all__ = ["save", "restore", "latest_step", "wait_for_pending"]

_PENDING: List[threading.Thread] = []


def _is_dtensor(x) -> bool:
    return hasattr(x, "full_tensor")


def _host(x: torch.Tensor) -> np.ndarray:
    if _is_dtensor(x):
        x = x.full_tensor()                # every rank joins the gather
    x = x.detach().to("cpu", copy=True)   # a snapshot, not a view
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).removeprefix("torch.")


def save(ckpt_dir: str, step: int, tree: Any, keep_last: int = 3,
         blocking: bool = True) -> str:
    """Save a tree of tensors as checkpoint ``step``; returns its final
    directory.  Every rank of a mesh run calls it; rank 0 writes."""
    flat = leaves(tree)
    host = [_host(x) for x in flat]        # the snapshot, taken now
    if any(_is_dtensor(x) for x in flat):
        # a mesh run: rank 0 writes while the others wait, so the step is
        # on disk for every rank when the call returns
        import torch.distributed as dist
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, host, flat, keep_last)
        dist.barrier()
        return os.path.join(ckpt_dir, f"step-{step}")
    return _write(ckpt_dir, step, host, flat, keep_last, blocking)


def _write(ckpt_dir, step, host, flat, keep_last, blocking=True) -> str:
    """Write the snapshot ``host`` of the leaves ``flat`` as checkpoint
    ``step`` (in a daemon thread unless ``blocking``)."""
    manifest = {"step": int(step), "treedef": None, "n_leaves": len(host),
                "dtypes": [_dtype_name(x) for x in flat],
                "shapes": [list(x.shape) for x in flat]}

    def write():
        tmp = os.path.join(ckpt_dir, f"tmp-{step}")
        final = os.path.join(ckpt_dir, f"step-{step}")
        os.makedirs(tmp, exist_ok=True)
        for i, x in enumerate(host):
            np.save(os.path.join(tmp, f"{i}.npy"), x)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                     # atomic publish
        _gc(ckpt_dir, keep_last)

    os.makedirs(ckpt_dir, exist_ok=True)
    if blocking:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    return os.path.join(ckpt_dir, f"step-{step}")


def wait_for_pending() -> None:
    """Join every asynchronous save."""
    while _PENDING:
        _PENDING.pop(0).join()


def _list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step-"):
            try:
                out.append(int(name.split("-", 1)[1]))
            except ValueError:
                pass
    return out


def _gc(ckpt_dir: str, keep_last: int) -> None:
    for s in sorted(_list_steps(ckpt_dir))[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s}"), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def _load(path: str, dtype_name: str) -> torch.Tensor:
    x = np.load(path)
    if x.dtype.kind == "V":
        if dtype_name != "bfloat16" or x.dtype.itemsize != 2:
            raise ValueError(f"{path}: raw {x.dtype} records of dtype "
                             f"{dtype_name!r}; only bfloat16 is read")
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, int]:
    """Checkpoint ``step`` in the structure of ``like``, each leaf a whole
    tensor in its ``like`` leaf's dtype and on its device (shapes checked;
    a DTensor leaf's global shape, its local shard's device); returns
    (tree, step)."""
    path = os.path.join(ckpt_dir, f"step-{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    ref = leaves(like)
    if manifest["n_leaves"] != len(ref):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree {len(ref)}")
    out = []
    for i, r in enumerate(ref):
        x = _load(os.path.join(path, f"{i}.npy"), manifest["dtypes"][i])
        if tuple(x.shape) != tuple(r.shape):
            raise ValueError(f"leaf {i}: checkpoint shape "
                             f"{tuple(x.shape)}, tree {tuple(r.shape)}")
        dev = r.to_local().device if _is_dtensor(r) else r.device
        out.append(x.to(device=dev, dtype=r.dtype))
    return unflatten(like, out), manifest["step"]
