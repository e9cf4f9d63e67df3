"""The port's training path against the reference on the CPU:
`models.transformer.forward` (logits and MoE aux), `train.trainstep.
loss_fn` and every gradient leaf against `jax.value_and_grad` of the
reference's `loss_fn`, on the reference's `make_params` weights carried
over by `from_jax_params` and a batch of `data.pipeline.batch_for_step`;
the three remat policies against each other; microbatch accumulation; and
a short training run whose loss falls, as the reference's own test asks.

The five configs cover the dense bf16 stack, the fused and the staged RNS
datapaths (live weights: the straight-through backward of `rns_dense`),
the pure SSM and MoE (its load-balance aux in the loss).

Tolerances (measured on these inputs, stated with their reason).  The
configs are bf16 as published: the reference's jitted program skips
intermediate bf16 roundings the port's op-by-op program takes, so the
gradients differ by up to 1.6% of a leaf's largest |gradient|
(GRAD_RTOL = 0.05, three times that), the loss by up to 7.4e-4 (LOSS_ATOL
= 3e-3) and the logits by up to 0.8% of the largest |logit| (moonshot:
0.031 of 3.98; LOGIT_RTOL = 0.08, the families tests' bound).  The float32
twins of `test_torch_train_f32.py` hold the same computation to ~1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _train_compare as tc
from repro.data.pipeline import batch_for_step
from repro_torch.train import trainstep as TS
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.tree import leaves

TRAIN_CONFIGS = tc.TRAIN_CONFIGS
GRAD_RTOL = 0.05
LOSS_ATOL = 3e-3
LOGIT_RTOL = 0.08
configs, batches, params = tc.configs, tc.batches, tc.params


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_forward_loss_and_grads_match_reference(name):
    tc.check(name, None, lambda m: LOGIT_RTOL * m, LOSS_ATOL, GRAD_RTOL)
    if name.startswith("moonshot"):
        assert tc.run(name)["port"][1] > 0    # the MoE aux reaches the loss


def _grads(cfg, tp, tb):
    loss, _, g = TS._value_and_grad(cfg, tp, tb)
    return loss, leaves(g)


@pytest.mark.parametrize("name", ["rns-smollm-135m-fused", "mamba2-1.3b",
                                  "hymba-1.5b", "moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_remat_policies_bit_equal(name):
    """full, save_ar and none give the same loss and gradients bit for bit:
    a recompute replays the same ops on the same inputs."""
    jcfg, tcfg = configs(name)
    _, tp = params(jcfg, tcfg)
    _, tb = batches(jcfg)
    outs = {pol: _grads(dataclasses.replace(tcfg, remat_policy=pol), tp, tb)
            for pol in ("full", "save_ar", "none")}
    outs["off"] = _grads(dataclasses.replace(tcfg, remat=False), tp, tb)
    want_loss, want = outs.pop("none")
    for pol, (loss, grads) in outs.items():
        assert torch.equal(loss, want_loss), pol
        assert all(torch.equal(a, b) for a, b in zip(grads, want)), pol


def test_remat_linear_launches(monkeypatch):
    """Each policy's forwards of the RNS linear in one train step, per
    layer: 7 without remat, 14 when "full" recomputes the whole layer, 12
    when "save_ar" recomputes all but `wo` and `w_down` (the counts the
    card's launch counters see, `chip_smoke.py`)."""
    from repro_torch.core import rns_linear
    calls = [0]
    forward = rns_linear._dense_forward

    def counted(*args):
        calls[0] += 1
        return forward(*args)

    monkeypatch.setattr(rns_linear, "_dense_forward", counted)
    jcfg, tcfg = configs("rns-smollm-135m-fused")
    _, tp = params(jcfg, tcfg)
    _, tb = batches(jcfg)
    for pol, want in (("full", 14), ("save_ar", 12), ("none", 7)):
        calls[0] = 0
        TS._value_and_grad(dataclasses.replace(tcfg, remat_policy=pol), tp,
                           tb)
        assert calls[0] == want * tcfg.num_layers, pol


def test_remat_policy_validated():
    jcfg, tcfg = configs("smollm-135m")
    _, tp = params(jcfg, tcfg)
    _, tb = batches(jcfg)
    with pytest.raises(ValueError, match="remat_policy"):
        TS.loss_fn(dataclasses.replace(tcfg, remat_policy="most"), tp, tb)


def test_residue_domain_trains_per_linear():
    """A residue-resident config trains the float-domain per-linear path,
    as the reference's `_train_cfg`: the same loss as its float twin."""
    jcfg, tcfg = configs("rns-smollm-135m-resident")
    _, tp = params(jcfg, tcfg)
    _, tb = batches(jcfg)
    assert TS._train_cfg(tcfg).linear_domain == "float"
    loss, _ = TS.loss_fn(tcfg, tp, tb)
    want, _ = TS.loss_fn(dataclasses.replace(tcfg, linear_domain="float"),
                         tp, tb)
    assert torch.equal(loss, want)


def test_grad_accum_identical():
    """n_micro = 4 against one batch, as the reference asserts (atol 1e-6
    on the updated parameters), and the accumulated gradients' loss."""
    jcfg, tcfg = configs("smollm-135m")
    _, tp = params(jcfg, tcfg)
    b = batch_for_step(0, 0, 8, 32, tcfg.vocab_size)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    opt = make_optimizer(tcfg, total_steps=10, base_lr=1e-2, warmup=1)
    state = opt.init(tp)
    p1, _, m1 = TS.make_train_step(tcfg, opt)(tp, state, tb, 0)
    p4, _, m4 = TS.make_train_step(tcfg, opt, n_micro=4)(tp, state, tb, 0)
    for a, c in zip(leaves(p1), leaves(p4)):
        np.testing.assert_allclose(a.to(torch.float32).numpy(),
                                   c.to(torch.float32).numpy(), atol=1e-6)
    # the mean of four microbatch losses is the batch's token mean
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 1e-5


def test_eval_step_is_the_loss():
    jcfg, tcfg = configs("moonshot-v1-16b-a3b")
    _, tp = params(jcfg, tcfg)
    _, tb = batches(jcfg)
    m = TS.make_eval_step(tcfg)(tp, tb)
    loss, metrics = TS.loss_fn(tcfg, tp, tb)
    assert torch.equal(m["loss"], loss) and not m["loss"].requires_grad
    assert all(torch.equal(m[k], metrics[k]) for k in ("ce", "aux", "zloss"))
    assert torch.allclose(loss, metrics["ce"] + TS.AUX_WEIGHT * metrics["aux"]
                          + TS.Z_WEIGHT * metrics["zloss"])


def test_loss_decreases_end_to_end():
    """40 AdamW steps on the pipeline's learnable stream lower the loss by
    0.3 (the reference's own threshold, tests/test_train.py)."""
    jcfg, tcfg = configs("smollm-135m")
    _, tp = params(jcfg, tcfg)
    opt = make_optimizer(tcfg, total_steps=60, base_lr=1e-2, warmup=5)
    step = TS.make_train_step(tcfg, opt)
    state = opt.init(tp)
    losses = []
    for s in range(40):
        b = batch_for_step(0, s, 8, 32, tcfg.vocab_size)
        tp, state, m = step(tp, state,
                            {k: torch.from_numpy(v) for k, v in b.items()}, s)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
