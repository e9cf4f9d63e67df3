"""Static batched serving engine, port of `repro/serve/engine.py`.

Requests are left-padded (right-aligned) to a common power-of-two prefill
length, prefilled together, then decoded together for ``max_new_tokens``.
Ragged prompts batch correctly through the per-sequence positions
``arange(S) − pad[i]``; ``lanes=`` pins the batch width by adding fully
padded dummy rows, so a prompt decodes at the same shapes alone or in a
batch.  Decode is a Python loop over `models.transformer.decode_step` with
sampling, the EOS latch and the token buffer on the device; the tokens reach
the host once, at the end.

The linear weights are encoded to residues once at construction when the
config asks for it (``encode_weights``), so decode does no per-step weight
quantization or conversion; a residue-resident config (``linear_domain=
"residue"``) encodes its MLP weights in the chain basis.  Without
``encode_weights`` the weights stay float and every linear quantizes and
converts its weight per call (the staged ``rns_int8:pallas`` datapath).

Sampling is greedy (``temperature <= 0``) or Gumbel-max at the given
temperature from a ``torch.Generator`` seeded with ``seed`` on the engine's
device: deterministic per seed, but not the reference's JAX PRNG stream.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rns import basis_for_chain
from repro_torch.core.rns_tensor import encode_params
from repro_torch.models import transformer as T

__all__ = ["Engine", "bucket_plen"]


def bucket_plen(plen: int) -> int:
    """Next power of two, floor 8: a ragged workload compiles and caches a
    handful of prefill shapes; extra pad slots are inert."""
    b = 8
    while b < plen:
        b *= 2
    return b


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    return node.to(device)


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits / temperature + gumbel, dim=-1)


class Engine:
    """Serving engine over ``params`` (the reference's layout, as from
    `models.transformer.make_params` or `weights.from_jax_params`).

    ``device`` defaults to "cuda"; an engine runs on the CPU only when asked
    with ``device="cpu"``, and raises when CUDA is asked for but absent.
    """

    def __init__(self, cfg: ModelConfig, params, smax: int = 2048,
                 lanes: Optional[int] = None, device=None):
        if cfg.family != "dense":
            raise ValueError(f"the port serves dense configs, got "
                             f"{cfg.family!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine needs a CUDA device and none is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.cfg = cfg
        self.lanes = None if lanes is None else int(lanes)
        self.smax = int(smax)
        params = _to_device(params, self.device)
        spec = cfg.linear_spec
        if spec.is_rns and spec.encode_weights:
            # a residue-resident MLP needs its weights in the chain basis,
            # sized for the gated down product d_ff·127³
            gb = ({"mlp": basis_for_chain(cfg.d_ff)}
                  if spec.domain == "residue" else None)
            with torch.inference_mode():
                params = encode_params(params, group_basis=gb)
        self.params = params

    def _pack(self, prompts: List[List[int]]):
        """Left-pad ragged prompts to a bucketed common length; dummy lanes
        up to a multiple of ``lanes`` are fully padded."""
        B = len(prompts)
        L = B if self.lanes is None else self.lanes * (-(-B // self.lanes))
        plen = bucket_plen(max(len(p) for p in prompts))
        toks = np.zeros((L, plen), np.int64)
        pad = np.full((L,), plen, np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
            pad[i] = plen - len(p)
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "pad": torch.from_numpy(pad).to(self.device)}
        return batch, plen

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Batched generation; returns each prompt followed by its new
        tokens, up to and including an ``eos_id`` token."""
        if not prompts or any(len(p) == 0 for p in prompts):
            raise ValueError("generate needs non-empty prompts")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        batch, plen = self._pack(prompts)
        if plen + max_new_tokens - 1 > self.smax:
            raise ValueError(f"prompt bucket {plen} + {max_new_tokens} new "
                             f"tokens exceeds smax={self.smax}")
        cfg, params = self.cfg, self.params
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        eos = -1 if eos_id is None else int(eos_id)
        pad = batch["pad"]
        with torch.inference_mode():
            logits, cache, pos0 = T.prefill(cfg, params, batch, self.smax)
            cur = _sample(logits, temperature, gen)
            first = cur
            done = cur == eos
            toks, emit = [], []
            for t in range(pos0, pos0 + max_new_tokens - 1):
                logits, cache = T.decode_step(cfg, params, cache,
                                              {"tokens": cur[:, None]}, t,
                                              positions=t - pad)
                cur = _sample(logits, temperature, gen)
                toks.append(cur)
                emit.append(~done)          # EOS itself is emitted
                done = done | (cur == eos)
            first = first.cpu().numpy()
            if toks:
                toks = torch.stack(toks).cpu().numpy()   # (T-1, B)
                emit = torch.stack(emit).cpu().numpy()
        out = [list(p) for p in prompts]
        for i in range(len(prompts)):
            out[i].append(int(first[i]))
            for t in range(len(toks)):
                if emit[t, i]:
                    out[i].append(int(toks[t, i]))
        return out
