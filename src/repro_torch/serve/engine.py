"""Static batched serving engine, port of `repro/serve/engine.py`.

Requests are left-padded (right-aligned) to a common power-of-two prefill
length (rounded up to ``ssm_chunk`` for SSM stacks), prefilled together,
then decoded together for ``max_new_tokens``.
Ragged prompts batch correctly through the per-sequence positions
``arange(S) − pad[i]``; ``lanes=`` pins the batch width by adding fully
padded dummy rows, so a prompt decodes at the same shapes alone or in a
batch.

Decode runs on the device (``engine="scan"``, the default, the reference's
one ``lax.scan`` over the new tokens): one decode step — `models.transformer.
decode_step` at a device-side cache position, sampling, the EOS latch and
the position increment — is captured once per (lanes, smax, greedy or
sampled) into a CUDA graph over persistent buffers (the KV cache, the
current token, the done latch, the position, the temperature, the EOS id
and a (smax, B) token buffer written at a device-side step index) and
replayed ``max_new_tokens − 1`` times after an eager prefill into the same
cache; the tokens reach the host once, at the end.  Captures are kept in a
small LRU (`_SCAN_CACHE_MAX`).  On the CPU there is no graph: ``"scan"``
runs the same step function eagerly over the same buffers.
``engine="host"`` is the per-token Python loop over the same
`decode_step` with an int position (the measured baseline).  Both check
that the prompt bucket plus the new tokens fit ``smax`` before any step.

``verify="static"`` proves the config before any weight is encoded
(`analysis.check_config`: every bound and launch choice its decode path
relies on; raises `analysis.AnalysisError` naming the violation).  Every
engine warms the tile kernel's tuner for its decode shapes
(`kernels.tune.warm_for_config`, at the reference's batch sizes and
``lanes``): with a populated table every lookup is a hit and no launch
sweeps; ``tune_report`` records the hits.

``mesh=`` (a `launch.mesh.Mesh` over an initialised process group, every
rank a process running the same calls) serves the model sharded
(`repro_torch.dist`): each rank encodes only its part of every linear
weight (`dist.engine.place_params`) and every fused launch of prefill and
decode splits over the mesh's "model" axis, in ``dist_layout`` (default:
the config's, else "auto"), with tokens and logits bit-equal to the
unsharded engine's on every rank.  A CUDA graph cannot hold a ``gloo``
collective, so under a mesh ``engine="scan"`` runs its step uncaptured
(``captured`` is False).

The linear weights are encoded to residues once at construction when the
config asks for it (``encode_weights``), so decode does no per-step weight
quantization or conversion; a residue-resident config (``linear_domain=
"residue"``) encodes its MLP weights in the chain basis.  Without
``encode_weights`` the weights stay float and every linear quantizes and
converts its weight per call (the staged ``rns_int8:pallas`` datapath).

Sampling is greedy (``temperature <= 0``) or Gumbel-max at the given
temperature from a ``torch.Generator`` seeded with ``seed`` on the engine's
device: deterministic per seed and the same draws in both engines (the
scan's generator is registered with its graph, so a replay draws what the
eager step would), but not the reference's JAX PRNG stream.  The
temperature is a device scalar, so every temperature reuses one capture.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import contextlib

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rns import basis_for_chain
from repro_torch.core.rns_tensor import encode_params
from repro_torch.kernels import tune
from repro_torch.models import transformer as T

__all__ = ["Engine", "bucket_plen", "encoded_params"]

# decode captures kept per engine: (lanes, smax, sampled) keys
_SCAN_CACHE_MAX = 8


def bucket_plen(cfg: ModelConfig, plen: int) -> int:
    """Next power of two, floor 8, then rounded up to ``ssm_chunk`` for a
    stack with SSM layers (the chunked dual form needs whole chunks): a
    ragged workload meets a handful of prefill shapes; extra pad slots are
    inert."""
    b = 8
    while b < plen:
        b *= 2
    if cfg.ssm or cfg.hybrid:
        b = -(-b // cfg.ssm_chunk) * cfg.ssm_chunk
    return b


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    return node.to(device)


def _sample(logits: torch.Tensor, temperature: Optional[torch.Tensor],
            generator: torch.Generator) -> torch.Tensor:
    """Greedy (``temperature`` None) or Gumbel-max at a 0-d float32
    temperature on the logits' device; (B,) int64 tokens."""
    if temperature is None:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return gumbel_argmax(logits, temperature, u)


def gumbel_argmax(logits: torch.Tensor, temperature: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """argmax(logits / temperature + Gumbel(u)) per row, ``u`` uniform
    draws of the logits' shape."""
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits / temperature + gumbel, dim=-1)


def capture_graph(step: Callable[[], None],
                  generators: Sequence[torch.Generator],
                  device: torch.device) -> torch.cuda.CUDAGraph:
    """Warm ``step`` up once on a side stream (first launches, cached
    tables, the tuner's sweeps of new shapes), then capture one call of it
    into a CUDA graph with every generator it draws from registered, so a
    replay draws what the eager step would.  ``step`` must read and write
    only persistent buffers: the warm-up call runs it for real.  The graph
    keeps its node list (``keep_graph``), which `kernels._build.
    graph_kernels` reads to count the kernels a replay launches."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        step()
    graph.instantiate()
    return graph


class _ScanState:
    """The persistent buffers of one decode capture: a batch of ``B`` lanes
    over a cache of ``smax`` slots.  ``toks[t]`` holds the token of step t
    (row 0 the prefill's), −1 once the sequence has met its EOS."""

    def __init__(self, cfg: ModelConfig, B: int, smax: int, sampled: bool,
                 device: torch.device):
        self.cache = T.init_cache(cfg, B, smax, device)
        self.cur = torch.zeros(B, dtype=torch.int64, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.pad = torch.zeros(B, dtype=torch.int32, device=device)
        self.eos = torch.full((), -1, dtype=torch.int64, device=device)
        self.temp = (torch.ones((), dtype=torch.float32, device=device)
                     if sampled else None)
        self.toks = torch.zeros((smax, B), dtype=torch.int64, device=device)
        self.gen = torch.Generator(device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None


def encoded_params(cfg, params):
    """The parameters a config serves: its linear weights encoded to
    residues once when the config encodes them (`encode_params`), else
    ``params`` as they are."""
    spec = cfg.linear_spec
    if not (spec.is_rns and spec.encode_weights):
        return params
    # a residue-resident GLU MLP needs its weights in the chain basis,
    # sized for the gated down product d_ff·127³
    gb = ({"mlp": basis_for_chain(cfg.d_ff)}
          if spec.domain == "residue" and cfg.glu and cfg.d_ff > 0 else None)
    return encode_params(params, group_basis=gb)


class Engine:
    """Serving engine over ``params`` (the reference's layout, as from
    `models.transformer.make_params` or `weights.from_jax_params`).

    ``device`` defaults to "cuda"; an engine runs on the CPU only when asked
    with ``device="cpu"``, and raises when CUDA is asked for but absent.
    ``scan_replays`` counts the captured decode steps replayed,
    ``scan_captures`` the graphs captured; ``captured`` says whether
    ``engine="scan"`` captures its step (on CUDA without a mesh).
    """

    def __init__(self, cfg: ModelConfig, params, smax: int = 2048,
                 lanes: Optional[int] = None, device=None,
                 verify: Optional[str] = None, mesh=None,
                 dist_layout: Optional[str] = None):
        if verify not in (None, "static"):
            raise ValueError(f"verify={verify!r}: expected None or 'static'")
        if verify == "static":
            from repro_torch.analysis import check_config

            check_config(cfg).raise_if_failed()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine needs a CUDA device and none is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self._dist_ctx = None
        if mesh is not None:
            from repro_torch.dist import engine as dist_engine

            self._dist_ctx = dist_engine.make_context(cfg, mesh,
                                                      layout=dist_layout)
        elif dist_layout is not None:
            raise ValueError("dist_layout= without mesh=: pass the mesh the "
                             "layout should shard over")
        self.cfg = cfg
        self.lanes = None if lanes is None else int(lanes)
        self.smax = int(smax)
        self.captured = self.device.type == "cuda" and mesh is None
        params = _to_device(params, self.device)
        with torch.inference_mode():
            if self._dist_ctx is not None:
                self.params = dist_engine.place_params(self._dist_ctx, cfg,
                                                       params)
            else:
                self.params = encoded_params(cfg, params)
        self._scan: "OrderedDict[tuple, _ScanState]" = OrderedDict()
        self.scan_replays = 0
        self.scan_captures = 0
        sizes = tune.ZOO_BATCH_SIZES
        if self.lanes is not None and self.lanes not in sizes:
            sizes = tuple(sorted({*sizes, self.lanes}))
        self.tune_report = tune.warm_for_config(cfg, sizes,
                                                device=self.device)

    def _ctx(self):
        """The engine's distribution context, active around prefill and
        decode (a null context without a mesh)."""
        if self._dist_ctx is None:
            return contextlib.nullcontext()
        from repro_torch.dist import context

        return context.use(self._dist_ctx)

    def prefill_logits(self, prompts: List[List[int]]) -> torch.Tensor:
        """The (B, V) last-position logits of one prefill of ``prompts``,
        packed as `generate` packs them."""
        batch, _ = self._pack(prompts)
        with torch.inference_mode(), self._ctx():
            logits, _, _ = T.prefill(self.cfg, self.params, batch, self.smax)
        return logits

    def _pack(self, prompts: List[List[int]]):
        """Left-pad ragged prompts to a bucketed common length; dummy lanes
        up to a multiple of ``lanes`` are fully padded."""
        if self.cfg.frontend != "tokens":
            raise ValueError(
                f"{self.cfg.name} takes a {self.cfg.frontend!r} frontend: "
                "Engine packs token prompts only; run its embeds through "
                "models.transformer.prefill / decode_step")
        B = len(prompts)
        L = B if self.lanes is None else self.lanes * (-(-B // self.lanes))
        plen = bucket_plen(self.cfg, max(len(p) for p in prompts))
        toks = np.zeros((L, plen), np.int64)
        pad = np.full((L,), plen, np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
            pad[i] = plen - len(p)
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "pad": torch.from_numpy(pad).to(self.device)}
        return batch, plen

    def _first(self, logits: torch.Tensor,
               temperature: Optional[torch.Tensor],
               generator: torch.Generator, seed: int) -> torch.Tensor:
        """The first token of every row: ``generator`` seeded with
        ``seed``, then one draw over the prefill's (B, V) logits; the
        generator's chain goes on from there."""
        generator.manual_seed(seed)
        return _sample(logits, temperature, generator)

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 engine: str = "scan") -> List[List[int]]:
        """Batched generation; returns each prompt followed by its new
        tokens, up to and including an ``eos_id`` token.  ``engine="scan"``
        replays a captured decode step on CUDA (the same step eagerly on
        the CPU); ``"host"`` runs the per-token Python loop."""
        if engine not in ("scan", "host"):
            raise ValueError(f"engine must be 'scan' or 'host', got "
                             f"{engine!r}")
        if not prompts or any(len(p) == 0 for p in prompts):
            raise ValueError("generate needs non-empty prompts")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        batch, plen = self._pack(prompts)
        if plen + max_new_tokens - 1 > self.smax:
            raise ValueError(f"prompt bucket {plen} + {max_new_tokens} new "
                             f"tokens exceeds smax={self.smax}")
        eos = -1 if eos_id is None else int(eos_id)
        run = self._generate_scan if engine == "scan" else \
            self._generate_host
        with torch.inference_mode(), self._ctx():
            toks = run(batch, max_new_tokens, float(temperature), int(seed),
                       eos)
        out = [list(p) for p in prompts]
        for i in range(len(prompts)):
            out[i].extend(int(t) for t in toks[:, i] if t >= 0)
        return out

    def _temperature(self, temperature: float) -> Optional[torch.Tensor]:
        if temperature <= 0.0:
            return None
        return torch.full((), temperature, dtype=torch.float32,
                          device=self.device)

    def _generate_host(self, batch, new: int, temperature: float, seed: int,
                       eos: int) -> np.ndarray:
        """The per-token loop: (new, B) tokens, −1 after a sequence's EOS."""
        cfg, params, pad = self.cfg, self.params, batch["pad"]
        gen = torch.Generator(device=self.device)
        temp = self._temperature(temperature)
        logits, cache, pos0 = T.prefill(cfg, params, batch, self.smax)
        cur = self._first(logits, temp, gen, seed)
        done = cur == eos
        toks = [cur]
        for t in range(pos0, pos0 + new - 1):
            logits, cache = T.decode_step(cfg, params, cache,
                                          {"tokens": cur[:, None]}, t,
                                          positions=t - pad)
            cur = _sample(logits, temp, gen)
            toks.append(torch.where(done, -1, cur))   # EOS itself is kept
            done = done | (cur == eos)
        return torch.stack(toks).cpu().numpy()

    def _state(self, B: int, sampled: bool) -> _ScanState:
        """The capture state of (B lanes, smax, sampled), LRU-bounded."""
        key = (B, self.smax, sampled)
        if key in self._scan:
            self._scan.move_to_end(key)
            return self._scan[key]
        st = _ScanState(self.cfg, B, self.smax, sampled, self.device)
        self._scan[key] = st
        while len(self._scan) > _SCAN_CACHE_MAX:
            self._scan.popitem(last=False)
        return st

    def _step(self, st: _ScanState) -> None:
        """One decode step over the state's buffers, reading nothing on the
        host: the captured graph's body, and the CPU's eager step."""
        logits, _ = T.decode_step(self.cfg, self.params, st.cache,
                                  {"tokens": st.cur[:, None]}, st.pos,
                                  positions=st.pos - st.pad)
        nxt = _sample(logits, st.temp, st.gen)
        st.toks.index_copy_(0, st.step, torch.where(st.done, -1, nxt)[None])
        st.done |= nxt == st.eos
        st.cur.copy_(nxt)
        st.pos += 1
        st.step += 1

    def _capture(self, st: _ScanState) -> None:
        """Capture one step into the state's CUDA graph, the sampling
        generator registered with it."""
        st.graph = capture_graph(lambda: self._step(st),
                                 [] if st.temp is None else [st.gen],
                                 self.device)
        self.scan_captures += 1

    def _generate_scan(self, batch, new: int, temperature: float, seed: int,
                       eos: int) -> np.ndarray:
        """Eager prefill into the capture's cache, then ``new − 1`` replays
        of the captured step (eager steps on the CPU): (new, B) tokens, −1
        after a sequence's EOS, read from the device once."""
        pad = batch["pad"]
        st = self._state(pad.shape[0], temperature > 0.0)
        if st.graph is None and self.captured and new > 1:
            # warm up and capture before the prefill: the warm-up runs the
            # step for real (a KV slot, a ring slot, the SSM state's
            # recurrence), and the prefill resets and rewrites every cache
            # buffer after it
            st.cur.zero_()
            st.pad.copy_(pad)
            st.pos.fill_(batch["tokens"].shape[1])
            st.step.fill_(1)
            self._capture(st)
        logits, _, pos0 = T.prefill(self.cfg, self.params, batch, self.smax,
                                    cache=st.cache)
        st.pad.copy_(pad)
        st.eos.fill_(eos)
        if st.temp is not None:
            st.temp.fill_(temperature)
        first = self._first(logits, st.temp, st.gen, seed)
        st.toks[0].copy_(first)
        st.cur.copy_(first)
        torch.eq(first, st.eos, out=st.done)
        st.pos.fill_(pos0)
        st.step.fill_(1)
        for _ in range(new - 1):
            if st.graph is not None:
                st.graph.replay()
                self.scan_replays += 1
            else:
                self._step(st)
        return st.toks[:new].cpu().numpy()
