"""Optimizers, port of `repro/train/optimizer.py`: AdamW (float32 moments)
and Adafactor (factored second moments), global-norm clipping and the
linear-warmup + cosine schedule.

Plain functions on nested dicts of tensors, with the reference's update
formulas in its op order: parameters keep their dtype (bf16), every update
computes in float32.  Not `torch.optim.AdamW`: its decoupled decay
(p ← p·(1 − lr·wd) before the step) rounds differently from the
reference's p − lr·(u + wd·p).  Adafactor is llama4-maverick's (AdamW's
two float32 moments for 400B parameters would not fit).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from .tree import leaves, tree_map

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # update(grads, state, params, step) -> (new_params, new_state)
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]


def _f32(step, like: torch.Tensor | None = None) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32,
                           device=None if like is None else like.device)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step → float32 learning rate: linear warmup to ``base_lr`` over
    ``warmup`` steps, then a cosine decay to 0 at ``total``."""
    def lr(step, like: torch.Tensor | None = None):
        step = _f32(step, like)
        # divisors as tensors: torch divides by a Python number through
        # its reciprocal, which rounds differently from the reference
        warm = base_lr * step / _f32(max(1.0, warmup), step)
        frac = torch.clamp((step - warmup)
                           / _f32(max(1.0, total - warmup), step), 0.0, 1.0)
        # the float32 cosine rounded once from float64: torch's float32
        # cos is off by an ulp where the reference's is not, and 1 + cos
        # cancels bits
        c = torch.cos((math.pi * frac).to(torch.float64)).to(torch.float32)
        cos = 0.5 * base_lr * (1.0 + c)
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, as float32;
    the norm before clipping)."""
    g = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, g) / (g + 1e-9), max=1.0)
    return tree_map(lambda x: x.to(torch.float32) * scale, grads), g


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip: float = 1.0) -> Optimizer:
    def init(params):
        def zeros(x):
            return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, clip)
        some = leaves(params)[0]
        t = _f32(step, some) + 1.0
        lr = lr_fn(step, some)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)
        mhat_scale = 1.0 / (1.0 - b1 ** t)
        vhat_scale = 1.0 / (1.0 - b2 ** t)

        def upd(p, m, v):
            u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init=init, update=update)


def adafactor(lr_fn, eps: float = 1e-30, clip: float = 1.0,
              weight_decay: float = 0.0,
              min_dim_factored: int = 2) -> Optimizer:
    """Factored RMS optimizer (Shazeer & Stern 2018), no momentum: a leaf
    of two or more dims keeps row and column second-moment statistics,
    O(n + m) for an (n, m) matrix; smaller leaves keep full ones."""
    def init(params):
        def st(x):
            f32 = dict(dtype=torch.float32, device=x.device)
            if x.ndim >= min_dim_factored:
                return {"vr": torch.zeros(x.shape[:-1], **f32),
                        "vc": torch.zeros(x.shape[:-2] + x.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(x.shape, **f32)}
        return tree_map(st, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, clip)
        some = leaves(params)[0]
        t = _f32(step, some) + 1.0
        beta2 = 1.0 - t ** -0.8
        lr = lr_fn(step, some)

        def upd(p, g, s):
            g2 = g * g + eps
            if p.ndim >= min_dim_factored:
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / (vr.mean(-1, keepdim=True)[..., None] + eps))
                u = g * torch.rsqrt(denom + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            # update clipping (RMS <= 1), as Adafactor does
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms, min=1.0)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), ns

        def walk(p, g, s):
            # the state has the params' structure, each leaf a dict
            if not isinstance(p, dict):
                return upd(p, g, s)
            both = {k: walk(p[k], g[k], s[k]) for k in p}
            return ({k: v[0] for k, v in both.items()},
                    {k: v[1] for k, v in both.items()})

        return walk(params, grads, state)

    return Optimizer(init=init, update=update)


def make_optimizer(cfg, total_steps: int = 10000, base_lr: float = 3e-4,
                   warmup: int | None = None) -> Optimizer:
    """The config's optimizer (``cfg.optimizer``) on the cosine schedule;
    the warmup defaults to a tenth of the steps, at most 200."""
    if warmup is None:
        warmup = min(200, max(1, total_steps // 10))
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)
    if cfg.optimizer == "adafactor":
        return adafactor(lr_fn)
    return adamw(lr_fn)
