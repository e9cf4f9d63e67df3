"""Gradient compression: an int8 mean all-reduce over a process group,
port of `repro/train/compression.py`.

Before the data-parallel mean each gradient is quantized to int8 against a
scale shared by every rank (the all-reduce MAX of each rank's max |g|, so
every rank rounds on the same grid), summed as int32 (no overflow:
127·n < 2^31) and dequantized: ``sum · scale / n``.  The SUM all-reduce
carries int32 values, 4 bytes an element, each rank's in int8 range: as
in the reference (a ``psum`` of int32), the wire is as wide as float32's;
what the int8 grid buys is a sum that is exact and the same on every
rank.  Quantization error is zero-mean and at most half a step, scale/2.

`compressed_mean_all_reduce` is `compressed_psum_mean` as explicit
`torch.distributed` collectives through `dist.comms.all_reduce`: one MAX
all-reduce of every tensor's max |g| (a vector) and one SUM all-reduce of
every tensor's int8 values widened to int32 (one flat buffer).  Each
tensor's arithmetic is the reference's `_compress_one` in float32.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["compressed_mean_all_reduce", "quantize", "dequantize"]


def quantize(g: torch.Tensor, amax: torch.Tensor):
    """(int32 values on the shared grid, the grid's float32 step) of ``g``
    given the shared max |g| ``amax`` (0-d float32)."""
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8).to(torch.int32), scale


def dequantize(total: torch.Tensor, scale: torch.Tensor, n: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The mean of ``n`` ranks' values from their int32 sum."""
    return (total.to(torch.float32) * scale / float(n)).to(dtype)


def compressed_mean_all_reduce(tensors: Sequence[torch.Tensor],
                               group=None) -> List[torch.Tensor]:
    """The int8-compressed mean of each tensor over ``group`` (default: the
    world): new tensors in the inputs' dtypes, the same on every rank."""
    import torch.distributed as dist

    from repro_torch.dist import comms

    tensors = list(tensors)
    if not tensors:
        return []
    group = group if group is not None else dist.group.WORLD
    amax = torch.stack([torch.amax(torch.abs(g.to(torch.float32)))
                        for g in tensors])
    comms.all_reduce(amax, group, op="max")
    qs = [quantize(g, a) for g, a in zip(tensors, amax)]
    flat = torch.cat([q.reshape(-1) for q, _ in qs])
    comms.all_reduce(flat, group)
    n, out, off = dist.get_world_size(group), [], 0
    for g, (_, scale) in zip(tensors, qs):
        total = flat[off:off + g.numel()].reshape(g.shape)
        off += g.numel()
        out.append(dequantize(total, scale, n, g.dtype))
    return out
