"""Continuous-batching slot scheduler over the paged KV pool, port of
`repro/serve/scheduler.py`.

The static `serve.Engine` packs one batch and runs it to completion, every
request waiting for the slowest batchmate while ``B·smax`` KV rows stay
reserved.  :class:`SlotScheduler` keeps a fixed set of decode *slots* hot
and admits requests from an arrival queue as soon as a slot frees up:

  * the slot axis has a fixed size, idle slots ride along with ``done`` set
    and their writes routed to the pool's trash block, so admission and
    retirement never change a shape.  A decode chunk is ``decode_chunk``
    paged decode steps; on CUDA one step (`models.transformer.decode_step`
    over the pool and the block table, sampling, the EOS latch, the
    position increment) is captured once into a CUDA graph over persistent
    device buffers and replayed ``decode_chunk`` times, then the chunk's
    (token, emit) rows reach the host in one copy.  On the CPU the same
    step runs eagerly;
  * K/V lives in the paged pool (`serve.paged_cache`): admission reserves
    a request's whole-lifetime block budget up front (no exhaustion
    mid-flight), retirement frees the blocks for the next request, and
    prompt-head blocks shared with earlier requests are refcount-mapped
    instead of copied (prefix caching);
  * admission prefills the request alone through the scheduler's own
    engine at its bucketed length and splices row 0 into the pool; it
    writes the block table and the slot's state into the persistent
    buffers with copies outside the graph.

Outputs equal ``self.engine.generate([prompt])`` run alone (the engine has
``smax == slot_tokens`` and ``lanes == slots``): the pool is indexed by
logical position, masked keys contribute exact zeros, the gathered key
axis is as long as the solo cache, and the attention and RMSNorm sums are
float64 (`models/layers.py`), so where a key sits does not change the
rounded result.  Sampling follows the solo engine's chain: each slot owns a
``torch.Generator``, seeded with ``req.seed`` at admission; the first token
is the engine's first draw over the (slots, V) prefill logits, and every
later step draws (slots, V) uniforms from the slot's generator and uses
row 0, as the solo engine does for its one request.  Sampled tokens
therefore equal the solo engine's too, and depend on neither arrival order
nor slot-mates.  On CUDA every slot generator is registered with the graph
(`CUDAGraph.register_generator_state`), so a replay draws what the eager
step would.

Scope: full-attention and pure-SSM stacks, and hybrids of the two (SSM
state is resident, one row a slot, spliced in at admission); a stack with
sliding-window ring caches is refused at construction, as in the
reference.  ``mesh=`` / ``dist_layout=`` pass through to the engine
(`serve.Engine`): every launch of admission and decode is sharded, and the
chunk's step runs uncaptured (a CUDA graph cannot hold a ``gloo``
collective; ``engine.captured`` is False).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, capture_graph, gumbel_argmax
from repro_torch.serve.paged_cache import (BlockAllocator, init_paged_cache,
                                           paged_cache_nbytes, splice_prefill)

__all__ = ["Request", "SlotScheduler"]


@dataclass
class Request:
    """One serving request.  ``arrival`` is in virtual decode steps (the
    scheduler's clock advances ``decode_chunk`` per chunk); ``seed`` is the
    request's own sampling chain — its solo twin is
    ``Engine.generate([prompt], max_new_tokens, seed=seed)``."""
    prompt: List[int]
    max_new_tokens: int = 32
    seed: int = 0
    arrival: float = 0.0
    rid: Optional[int] = None


@dataclass
class _Slot:
    req: Request
    blocks: List[int]            # physical blocks held (shared ones retained)
    out: List[int]               # emitted new tokens (first included)
    admit_step: int
    done_step: Optional[int] = None
    finished: bool = False


class SlotScheduler:
    """Continuous-batching scheduler: ``slots`` resident decode lanes over a
    paged KV pool of ``n_blocks × block_size`` token rows.

    ``slot_tokens`` is each lane's logical capacity (and the ``smax`` of the
    internal engine); ``n_blocks`` sizes the physical pool (default the
    static reservation ``1 + slots · slot_tokens / block_size``).
    Admission is in strict arrival order, at chunk boundaries.  ``device``
    defaults to "cuda"; the CPU is used only when asked.
    ``chunk_captures`` counts the graphs captured, ``chunk_replays`` the
    captured steps replayed, ``admissions`` the requests admitted.  With
    ``time_admissions`` set, ``admit_seconds`` adds up the wall time of
    every admission attempt (prefill, splice, first token), the device
    synchronised before and after each.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 block_size: int = 16, slot_tokens: int = 256,
                 n_blocks: Optional[int] = None, decode_chunk: int = 8,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 prefix_sharing: bool = True, mesh=None,
                 dist_layout: Optional[str] = None, device=None):
        if slot_tokens % block_size:
            raise ValueError("slot_tokens must be a multiple of block_size")
        self.cfg = cfg
        self.slots = int(slots)
        self.block_size = int(block_size)
        self.slot_tokens = int(slot_tokens)
        self.nlog = slot_tokens // block_size
        self.n_blocks = int(n_blocks) if n_blocks is not None \
            else 1 + self.slots * self.nlog
        self.decode_chunk = int(decode_chunk)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.prefix_sharing = bool(prefix_sharing)
        # refuse ring-cache stacks before any weight is encoded
        init_paged_cache(cfg, 2, self.block_size, 1, device="meta")
        # lanes=slots: the solo reference decodes at the chunk's shapes
        self.engine = Engine(cfg, params, smax=slot_tokens, lanes=self.slots,
                             device=device, mesh=mesh,
                             dist_layout=dist_layout)
        self.device = dev = self.engine.device
        # the persistent buffers a captured step reads and writes
        self._cache = init_paged_cache(cfg, self.n_blocks, self.block_size,
                                       self.slots, device=dev)
        self._bt = torch.full((self.slots, self.nlog), -1, dtype=torch.int64,
                              device=dev)
        self._cur = torch.zeros(self.slots, dtype=torch.int64, device=dev)
        self._done = torch.ones(self.slots, dtype=torch.bool, device=dev)
        self._pos = torch.zeros(self.slots, dtype=torch.int64, device=dev)
        self._step_idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self._eos = torch.full((), -1 if eos_id is None else int(eos_id),
                               dtype=torch.int64, device=dev)
        self._temp = self.engine._temperature(self.temperature)
        # row 0: the chunk's tokens, row 1: whether each was emitted
        self._out = torch.zeros((2, self.decode_chunk, self.slots),
                                dtype=torch.int64, device=dev)
        self._gens = [torch.Generator(device=dev) for _ in range(self.slots)]
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.chunk_captures = 0
        self.chunk_replays = 0
        self.admissions = 0
        self.time_admissions = False
        self.admit_seconds = 0.0
        self.stats: Dict[str, Any] = {}

    # ----------------------------------------------------------- device step -
    def _step(self) -> None:
        """One paged decode step over the persistent buffers, reading
        nothing on the host: the captured graph's body, and the CPU's eager
        step."""
        logits, _ = T.decode_step(self.cfg, self.engine.params, self._cache,
                                  {"tokens": self._cur[:, None]}, self._pos,
                                  block_tables=self._bt)
        if self._temp is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            u = torch.stack([torch.rand(logits.shape, generator=g,
                                        device=logits.device)[0]
                             for g in self._gens])
            nxt = gumbel_argmax(logits, self._temp, u)
        self._out.index_copy_(
            1, self._step_idx, torch.stack([nxt, (~self._done).long()])[:, None])
        done = self._done | (nxt == self._eos)
        # a finished lane's position freezes: its junk steps keep writing
        # one private row (or the trash block) and are never read
        self._pos.copy_(torch.where(done, self._pos, self._pos + 1))
        self._done.copy_(done)
        self._cur.copy_(nxt)
        self._step_idx += 1

    def _capture(self) -> None:
        """Capture one step into a CUDA graph with every slot generator
        registered.  Runs on the all-idle state, which the caller resets
        afterwards."""
        self._graph = capture_graph(
            self._step, [] if self._temp is None else self._gens,
            self.device)
        self.chunk_captures += 1

    def _reset(self) -> None:
        """Zero the pool and idle every slot, in place."""
        T.reset_cache(self._cache)
        self._bt.fill_(-1)
        self._cur.zero_()
        self._done.fill_(True)
        self._pos.zero_()
        self._out.zero_()

    def _run_chunk(self):
        """``decode_chunk`` steps (graph replays on CUDA); the chunk's
        tokens and emit flags, (decode_chunk, slots) each, on the host."""
        self._step_idx.zero_()
        for _ in range(self.decode_chunk):
            if self._graph is not None:
                self._graph.replay()
                self.chunk_replays += 1
            else:
                self._step()
        out = self._out.cpu().numpy()
        return out[0], out[1].astype(bool)

    # ------------------------------------------------------------- admission -
    def _lifetime_blocks(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens) // self.block_size)

    def _try_admit(self, req: Request, slot: int,
                   clock: int) -> Optional[_Slot]:
        """Reserve blocks, prefill, splice, and seat ``req`` in ``slot``.
        Returns None (state untouched) when the pool cannot cover the
        request's whole-lifetime reservation yet."""
        bs, prompt = self.block_size, req.prompt
        plen = len(prompt)
        nfull = plen // bs
        shared: List[int] = []
        if self.prefix_sharing:
            for j in range(nfull):
                b = self._alloc.lookup(tuple(prompt[:(j + 1) * bs]))
                if b is None:
                    break
                shared.append(b)
        lifetime = self._lifetime_blocks(req)
        if self._alloc.free_count < lifetime - len(shared):
            return None
        self._alloc.prefix_hits += len(shared)
        for b in shared:
            self._alloc.retain(b)
        blocks = shared + [self._alloc.alloc()
                           for _ in range(lifetime - len(shared))]
        row = np.full((self.nlog,), -1, np.int64)
        row[:lifetime] = blocks
        self._bt[slot].copy_(torch.from_numpy(row))

        # prefill alone at the bucketed length (the solo engine's own packed
        # shape, hence the same K/V), then splice row 0 into the pool
        batch, _ = self.engine._pack([prompt])
        pbuck = batch["tokens"].shape[1]
        pad = pbuck - plen
        logits, pf_cache, _ = T.prefill(self.cfg, self.engine.params, batch,
                                        pbuck)
        phys = np.zeros((pbuck,), np.int64)
        offs = np.zeros((pbuck,), np.int64)
        for s in range(pbuck):
            lp = s - pad
            if lp < 0 or lp // bs < len(shared):
                continue              # pad slots / already-shared blocks → trash
            phys[s] = blocks[lp // bs]
            offs[s] = lp % bs
        splice_prefill(self._cache, pf_cache,
                       torch.from_numpy(phys).to(self.device),
                       torch.from_numpy(offs).to(self.device), slot=slot)
        if self.prefix_sharing:
            for j in range(len(shared), nfull):
                self._alloc.register(tuple(prompt[:(j + 1) * bs]), blocks[j])

        first = int(self.engine._first(logits, self._temp, self._gens[slot],
                                       req.seed)[0])
        st = _Slot(req=req, blocks=blocks, out=[first], admit_step=clock)
        if req.max_new_tokens <= 1 or (self.eos_id is not None
                                       and first == self.eos_id):
            st.finished, st.done_step = True, clock
            self._release(slot, st)
        else:
            self._slots[slot] = st
            self._cur[slot] = first
            self._pos[slot] = plen
            self._done[slot] = False
        return st

    def _admit(self, req: Request, slot: int,
               clock: int) -> Optional[_Slot]:
        """`_try_admit`, counted, and timed when ``time_admissions`` is
        set."""
        timed = self.time_admissions
        if timed:
            self._sync()
            t = time.perf_counter()
        st = self._try_admit(req, slot, clock)
        if timed:
            self._sync()
            self.admit_seconds += time.perf_counter() - t
        if st is not None:
            self.admissions += 1
        return st

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _release(self, slot: int, st: _Slot) -> None:
        for b in st.blocks:
            self._alloc.release(b)
        self._bt[slot] = -1
        self._done[slot] = True
        self._slots[slot] = None

    # ----------------------------------------------------------------- serve -
    def serve(self, requests: Sequence[Request]) -> List[List[int]]:
        """Run every request to completion; returns, in INPUT order, each
        request's full token list (prompt + new tokens).  Re-entrant: the
        pool, allocator and slot state are reset in place per call."""
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.slot_tokens:
                raise ValueError(
                    f"request needs {len(r.prompt) + r.max_new_tokens} "
                    f"tokens > slot_tokens={self.slot_tokens}")
            if self._lifetime_blocks(r) > self.n_blocks - 1:
                raise ValueError("request's lifetime block reservation "
                                 f"exceeds the pool ({self.n_blocks - 1} "
                                 "usable blocks)")
        with torch.inference_mode(), self.engine._ctx():
            return self._serve(requests)

    def _serve(self, requests: Sequence[Request]) -> List[List[int]]:
        order = sorted(range(len(requests)),
                       key=lambda i: (requests[i].arrival, i))
        pending = deque(order)
        results: List[Optional[_Slot]] = [None] * len(requests)

        self._alloc = BlockAllocator(self.n_blocks)
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._reset()
        if self._graph is None and self.engine.captured:
            self._capture()
            self._reset()
        pool_bytes = paged_cache_nbytes(self._cache)

        clock = 0
        chunks = 0
        while pending or any(s is not None for s in self._slots):
            # admit, strict arrival order, into free slots
            while pending and requests[pending[0]].arrival <= clock:
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not free:
                    break
                idx = pending[0]
                st = self._admit(requests[idx], free[0], clock)
                if st is None:
                    break               # pool full: wait for a retirement
                results[idx] = st
                pending.popleft()
            if all(s is None for s in self._slots):
                # idle: jump the clock to the next arrival
                clock = max(clock + 1,
                            math.ceil(requests[pending[0]].arrival))
                continue

            toks, emit = self._run_chunk()
            chunks += 1
            for t in range(self.decode_chunk):
                for i, st in enumerate(self._slots):
                    if st is None or st.finished:
                        continue
                    if emit[t, i]:
                        tok = int(toks[t, i])
                        st.out.append(tok)
                        hit_eos = (self.eos_id is not None
                                   and tok == self.eos_id)
                        if hit_eos or len(st.out) >= st.req.max_new_tokens:
                            st.finished = True
                            st.done_step = clock + t + 1
            clock += self.decode_chunk
            for i, st in enumerate(self._slots):
                if st is not None and st.finished:
                    self._release(i, st)

        outs = []
        lat = []
        total_new = 0
        for i, r in enumerate(requests):
            st = results[i]
            outs.append(list(r.prompt) + st.out)
            total_new += len(st.out)
            lat.append(st.done_step - r.arrival)
        lat = sorted(lat)
        self.stats = {
            "requests": len(requests),
            "new_tokens": total_new,
            "chunks": chunks,
            "steps": clock,
            "pool_bytes": pool_bytes,
            "peak_blocks": self._alloc.peak_used,
            "prefix_hits": self._alloc.prefix_hits,
            "latency_steps_p50": lat[len(lat) // 2] if lat else 0.0,
            "latency_steps_p99": lat[min(len(lat) - 1,
                                         math.ceil(0.99 * len(lat)) - 1)]
            if lat else 0.0,
        }
        return outs
