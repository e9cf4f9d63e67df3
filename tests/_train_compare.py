"""Shared helpers of the training tests: reference and port smoke configs,
weights (the reference's `make_params` carried over by `from_jax_params`),
a pipeline batch for both, and one forward/loss/gradient run of both
sides."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data.pipeline import batch_for_step
from repro.models import transformer as JT
from repro.train import trainstep as JS
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.train import trainstep as TS
from repro_torch.train.tree import leaves
from repro_torch.weights import from_jax_params

TRAIN_CONFIGS = ["smollm-135m", "rns-smollm-135m-fused",
                 "rns-smollm-135m-pallas", "mamba2-1.3b",
                 "moonshot-v1-16b-a3b"]
B, S = 2, 16


def configs(name, dtype=None):
    """(reference, port) smoke configs; the reference's RNS backends on
    its `jnp` engine (bit-identical to its Pallas kernels, and fast on the
    CPU)."""
    jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
    if jcfg.linear_backend.startswith("rns_int8"):
        jcfg = dataclasses.replace(jcfg, linear_backend="rns_int8:jnp")
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, param_dtype=dtype)
    return jcfg, tcfg


def batches(cfg, seed=0, step=0):
    """(reference batch, port batch) of one step of the pipeline; for the
    embeddings frontend, seeded bf16 embeds and the pipeline's labels."""
    b = batch_for_step(seed, step, B, S, cfg.vocab_size)
    jb = {"labels": jnp.asarray(b["labels"])}
    tb = {"labels": torch.from_numpy(b["labels"])}
    if cfg.frontend == "embeddings":
        e = np.random.default_rng(seed).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        jb["embeds"] = jnp.asarray(e).astype(jnp.bfloat16)
        tb["embeds"] = torch.from_numpy(e).to(torch.bfloat16)
    else:
        jb["tokens"] = jnp.asarray(b["tokens"])
        tb["tokens"] = torch.from_numpy(b["tokens"])
    return jb, tb


def params(jcfg, tcfg):
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@functools.lru_cache(maxsize=None)
def run(name, dtype=None):
    """Both sides' forward, loss and gradients on one batch."""
    jcfg, tcfg = configs(name, dtype)
    jp, tp = params(jcfg, tcfg)
    jb, tb = batches(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        functools.partial(JS.loss_fn, jcfg), has_aux=True))(jp, jb)
    jlog, jaux = jax.jit(functools.partial(JT.forward, jcfg))(jp, jb)
    with torch.no_grad():
        tlog, taux = TT.forward(tcfg, tp, tb)
    tl, tm, tg = TS._value_and_grad(tcfg, tp, tb)
    return {"ref": (f32(jlog), float(jaux), float(jl), float(jm["ce"]),
                    [f32(g) for g in jax.tree.leaves(jg)]),
            "port": (tlog.numpy(), float(taux), float(tl), float(tm["ce"]),
                     [g.to(torch.float32).numpy() for g in leaves(tg)]),
            "grad_dtypes": [g.dtype for g in leaves(tg)],
            "param_dtypes": [p.dtype for p in leaves(tp)]}


def check(name, dtype, logit_tol, loss_tol, grad_rtol):
    r = run(name, dtype)
    jlog, jaux, jl, jce, jg = r["ref"]
    tlog, taux, tl, tce, tg = r["port"]
    assert tlog.dtype == np.float32 and tlog.shape == jlog.shape
    assert np.abs(tlog - jlog).max() <= logit_tol(np.abs(jlog).max())
    assert abs(taux - jaux) <= loss_tol
    assert abs(tl - jl) <= loss_tol and abs(tce - jce) <= loss_tol
    assert len(tg) == len(jg)
    assert r["grad_dtypes"] == r["param_dtypes"]
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, i
        assert np.isfinite(a).all(), i
        assert np.abs(a - b).max() <= grad_rtol * np.abs(b).max(), i
