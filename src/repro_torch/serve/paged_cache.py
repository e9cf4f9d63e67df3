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
    init_cache`'s ``{"sub0": {"k", "v"}}`` layout but with
    ``(n_blocks_layers, n_phys, block, Hk, dh)`` leaves.  Physical block 0
    is the *trash* block: idle slots and out-of-range writes land there
    and it is never read unmasked.  The pool starts zeroed, so every value
    under a masked key is finite and contributes an exact zero;
  * :func:`splice_prefill` — one in-place scatter of an admitted request's
    prefill cache into its pool blocks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

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
                     device="cuda"):
    """Zeroed paged decode cache {"sub0": {"k", "v"}} of
    (n_blocks_layers, n_phys, block_size, Hk, dh) pools on ``device``.
    (The reference's ``slots`` argument sizes slot-resident SSM state,
    which the dense family has none of.)"""
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: the port's paged pool serves dense "
                         f"stacks only, got family {cfg.family!r}")
    shape = (cfg.n_blocks, n_phys, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    dtype = getattr(torch, cfg.param_dtype)
    return {"sub0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


def paged_cache_nbytes(cache) -> int:
    """Device bytes of the pool's leaves."""
    return sum(t.numel() * t.element_size()
               for col in cache.values() for t in col.values())


def splice_prefill(cache, pf_cache, phys, offs):
    """Copy row 0 of an admitted request's prefill cache into the pool, in
    place, and return the pool.

    ``phys``/``offs`` ((S,) int64 on the pool's device, host-built) give
    the (physical block, offset) of each padded prefill position; pad
    positions and positions in shared prefix blocks go to the trash block
    0 (shared blocks already hold the same K/V: a prefix position's K/V
    depends only on the prefix).  The dense family has no slot-resident
    SSM rows, so the reference's ``slot`` argument is not taken.
    """
    for sub, col in cache.items():
        for name in ("k", "v"):
            col[name][:, phys, offs] = pf_cache[sub][name][:, 0].to(
                col[name].dtype)
    return cache
