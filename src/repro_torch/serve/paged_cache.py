"""Paged KV cache for continuous-batching serving, port of
`repro/serve/paged_cache.py`.

The static engine reserves ``B·smax`` K/V rows per layer.  Here the K/V
storage is a pool of fixed-size *physical blocks* shared by all slots; a
block table maps ``(slot, logical block) → physical block``, so the pool
is sized by the live tokens, not by the reservation.  Three pieces:

  * :class:`BlockAllocator` — host-side free list, refcounts and an exact
    token-prefix registry (prefix caching): a full block whose content is a
    prompt prefix can be mapped by several requests at once.  Decode only
    writes a slot's own private tail and decode blocks, never a shared
    full block, so sharing needs no copy-on-write;
  * :func:`init_paged_cache` — the pool, in `models.transformer.
    init_cache`'s ``{"sub{i}": {"k", "v", "ssm"}}`` layout but with
    ``(n_blocks_layers, n_phys, block, Hk, dh)`` K/V leaves; SSM state is
    O(1) a sequence and stays resident, one row a slot.  Physical block 0
    is the *trash* block: idle slots and out-of-range writes land there
    and it is never read unmasked.  The pool starts zeroed, so every value
    under a masked key is finite and contributes an exact zero.  A stack
    with sliding-window (ring) layers is refused: a ring's positions are
    shared across the batch;
  * :func:`splice_prefill` — one in-place scatter of an admitted request's
    prefill cache into its pool blocks and its slot's SSM rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import FULL_WINDOW
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.models.transformer import _mixer_kind, cache_leaves

__all__ = ["BlockAllocator", "init_paged_cache", "splice_prefill",
           "paged_cache_nbytes"]


class BlockAllocator:
    """Host-side physical-block bookkeeping: free list, refcounts, and the
    exact-prefix registry for shared prompt-head blocks.

    Prefix keys are the exact token tuple of the prompt head the block
    completes.  Only full blocks register; a block is freed (and
    deregistered) when its refcount drops to zero, so a cached prefix lives
    as long as some holder does.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the "
                             "reserved trash block)")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._by_prefix: Dict[Tuple[int, ...], int] = {}
        self._prefix_of: Dict[int, Tuple[int, ...]] = {}
        self.peak_used = 0
        self.prefix_hits = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("paged KV pool exhausted — size n_blocks to "
                               "the admission-time reservation bound")
        b = self._free.pop()
        self._refs[b] = 1
        self.peak_used = max(self.peak_used, self.used)
        return b

    def retain(self, b: int) -> None:
        self._refs[b] += 1

    def release(self, b: int) -> None:
        self._refs[b] -= 1
        if self._refs[b] == 0:
            del self._refs[b]
            pfx = self._prefix_of.pop(b, None)
            if pfx is not None:
                del self._by_prefix[pfx]
            self._free.append(b)

    def lookup(self, prefix: Tuple[int, ...]) -> Optional[int]:
        return self._by_prefix.get(prefix)

    def register(self, prefix: Tuple[int, ...], b: int) -> None:
        self._by_prefix[prefix] = b
        self._prefix_of[b] = prefix


def init_paged_cache(cfg: ModelConfig, n_phys: int, block_size: int,
                     slots: int = 1, device="cuda"):
    """Zeroed paged decode cache on ``device``: per column ``sub{i}``,
    (n_blocks_layers, n_phys, block_size, Hk, dh) K/V pools for attention
    layers and (n_blocks_layers, slots, …) SSM state for SSM layers.
    Raises for a stack with a sliding-window (ring cache) layer."""
    dtype = getattr(torch, cfg.param_dtype)
    kind = _mixer_kind(cfg)
    L = cfg.n_blocks
    out = {}
    for i in range(cfg.layers_per_block):
        for b in range(L):
            layer = b * cfg.layers_per_block + i
            if kind != "ssm" and \
                    cfg.window_for_layer(layer, FULL_WINDOW) < FULL_WINDOW:
                raise ValueError(
                    f"{cfg.name}: layer {layer} uses a sliding-window ring "
                    "cache — paged decode supports full-attention and "
                    "pure-SSM stacks only (DESIGN.md §15)")
        col = {}
        if kind in ("attn", "hybrid"):
            shape = (L, n_phys, block_size, cfg.num_kv_heads, cfg.head_dim)
            col["k"] = torch.zeros(shape, dtype=dtype, device=device)
            col["v"] = torch.zeros(shape, dtype=dtype, device=device)
        if kind in ("ssm", "hybrid"):
            one = init_ssm_cache(cfg, slots, "meta", dtype)
            col["ssm"] = {k: torch.zeros((L, *t.shape), dtype=t.dtype,
                                         device=device)
                          for k, t in one.items()}
        out[f"sub{i}"] = col
    return out


def paged_cache_nbytes(cache) -> int:
    """Device bytes of the pool's leaves."""
    return sum(t.numel() * t.element_size() for _, t in cache_leaves(cache))


def splice_prefill(cache, pf_cache, phys, offs, slot: int = 0):
    """Copy row 0 of an admitted request's prefill cache into the pool, in
    place, and return the pool.

    ``phys``/``offs`` ((S,) int64 on the pool's device, host-built) give
    the (physical block, offset) of each padded prefill position; pad
    positions and positions in shared prefix blocks go to the trash block
    0 (shared blocks already hold the same K/V: a prefix position's K/V
    depends only on the prefix).  SSM state and conv rows copy into row
    ``slot``.
    """
    for sub, col in cache.items():
        src = pf_cache[sub]
        for name in ("k", "v"):
            if name in col:
                col[name][:, phys, offs] = src[name][:, 0].to(
                    col[name].dtype)
        if "ssm" in col:
            for name, t in col["ssm"].items():
                t[:, slot] = src["ssm"][name][:, 0].to(t.dtype)
    return cache
