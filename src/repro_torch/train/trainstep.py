"""Loss and train step, port of `repro/train/trainstep.py`.

  loss = token-mean cross-entropy + 0.01·(MoE load-balance aux)
         + 1e-4·z-loss (the mean squared logsumexp), in float32
  gradients by autograd through `models.transformer.forward` (each layer
  under the config's remat policy; the RNS linears' straight-through
  backward), optionally accumulated over microbatches in float32, then
  the optimizer's update.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

from .optimizer import Optimizer
from .tree import leaves, tree_map, unflatten

__all__ = ["loss_fn", "make_train_step", "make_eval_step"]

AUX_WEIGHT = 0.01
Z_WEIGHT = 1e-4


def _train_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config training runs: a residue-domain config trains the
    float-domain per-linear path (`rns_dense` and its straight-through
    backward), as the reference does; `rns_chain_linear` is forward-only.
    Serving keeps the chains."""
    if cfg.linear_domain != "float":
        return dataclasses.replace(cfg, linear_domain="float")
    return cfg


def loss_fn(cfg: ModelConfig, params, batch):
    """(loss, {"ce", "aux", "zloss"}), 0-d float32 tensors, of ``batch``
    ({"tokens" or "embeds", "labels"})."""
    logits, aux = T.forward(_train_cfg(cfg), params, batch)   # (B, S, V)
    labels = batch["labels"].long()
    if hasattr(logits, "placements"):
        lse, ll = _lse_and_label_on_shards(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)                 # (B, S)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    z = torch.mean(lse * lse)
    loss = ce + AUX_WEIGHT * aux + Z_WEIGHT * z
    return loss, {"ce": ce, "aux": aux, "zloss": z}


def _lse_and_label_on_shards(logits, labels):
    """(logsumexp, the labels' logits), each (B, S), of a mesh run's
    vocab-sharded DTensor logits, each rank on its own (rows, vocab)
    block: a local max, sum of exponentials and label pick, combined over
    the vocab shards by an all-reduce (max, then sums).  DTensor's own
    strategies for ``logsumexp`` and a masked pick gather the batch or the
    vocab, and their gradients with them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.models.layers import from_local_blocks, local_block
    mesh, nd = logits.device_mesh, logits.ndim
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim % nd == nd - 1]
    rows = [p if isinstance(p, Shard) and p.dim % nd < nd - 1 else
            Replicate() for p in logits.placements]
    block = [Shard(nd - 1) if i in vocab else p for i, p in enumerate(rows)]
    x = local_block(logits, mesh, block)
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                      block)

    def over_vocab(t, op):
        return DTensor.from_local(
            t, mesh, [Partial(op) if i in vocab else p
                      for i, p in enumerate(rows)],
            run_check=False).redistribute(mesh, rows).to_local()

    m = x.amax(-1).detach()
    if vocab:
        m = over_vocab(m, "max")
    se = torch.exp(x - m[..., None]).sum(-1)
    idx = local_block(labels, mesh, rows) - offset[-1]
    inside = (idx >= 0) & (idx < x.shape[-1])
    pick = torch.gather(x, -1, idx.clamp(0, x.shape[-1] - 1)[..., None])
    pick = torch.where(inside, pick[..., 0], 0.0)
    if vocab:
        se, pick = over_vocab(se, "sum"), over_vocab(pick, "sum")
    shape = logits.shape[:-1]
    return (from_local_blocks(torch.log(se) + m, mesh, rows, shape),
            from_local_blocks(pick, mesh, rows, shape))


def _value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads in the params' dtypes); a parameter the loss
    does not read (the token table of an embeddings frontend, the unused
    gate of a non-GLU MLP) gets a zero gradient, as in the reference."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, metrics = loss_fn(cfg, unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, list(grads)))


def make_train_step(cfg: ModelConfig, opt: Optimizer, n_micro: int = 1):
    """train_step(params, opt_state, batch, step) → (params, opt_state,
    metrics).  ``n_micro`` > 1 splits the batch into that many
    microbatches and sums their gradients in float32 (the metrics then
    carry the mean loss as "ce")."""

    def accum_grads(params, batch):
        if n_micro == 1:
            return _value_and_grad(cfg, params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = 0.0
        for i in range(n_micro):
            mb = {k: v.reshape(n_micro, B // n_micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, _, grads = _value_and_grad(cfg, params, mb)
            acc = tree_map(lambda a, g: a + g.to(torch.float32), acc, grads)
            loss_sum = loss_sum + loss
        n = torch.tensor(float(n_micro), device=loss_sum.device)
        grads = tree_map(lambda g: g / n, acc)
        loss = loss_sum / n
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"ce": loss, "aux": zero, "zloss": zero}, grads

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = accum_grads(params, batch)
        new_params, new_state = opt.update(grads, opt_state, params, step)
        return new_params, new_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(cfg: ModelConfig):
    """eval_step(params, batch) → {"loss", "ce", "aux", "zloss"}."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(cfg, params, batch)
        return dict(metrics, loss=loss)
    return eval_step
