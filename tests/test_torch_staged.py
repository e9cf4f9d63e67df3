"""The port's staged RNS datapath against the JAX reference, on the CPU.

On CPU tensors the staged kernels' wrappers run their plain versions, which
must be bit-equal to the reference's jnp twins and to its Pallas kernels in
interpret mode (one tiny shape each): `rns_matmul` in its broadcast (signed
int8, −128 corners) and canonical forms, `rns_reverse` with and without a
fused scale, `rns_modmul`; then the staged `rns_dense` (live and encoded
weights) against the jitted reference at smollm launch shapes, and the
whole smoke `rns-smollm-135m-pallas` model within LOGIT_ATOL of the
reference, greedy tokens equal at every decisive step.  The reference runs
on its jnp backend where its own tests prove jnp equal to Pallas.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_compare as cmp
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import channel_plan as jcp
from repro.core import rns as jrns
from repro.core import rns_linear as jlin
from repro.core import rns_tensor as jrt
from repro.core.conversion_plan import ConversionPlan as JConv
from repro.kernels.rns_convert import rns_reverse as jreverse
from repro.kernels.rns_matmul import rns_matmul as jmatmul
from repro.kernels.rns_modmul import rns_modmul as jmodmul
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import channel_plan as tcp
from repro_torch.core import rns as trns
from repro_torch.core import rns_linear as tlin
from repro_torch.core import rns_tensor as trt
from repro_torch.core.conversion_plan import ConversionPlan as TConv
from repro_torch.kernels import (rns_forward, rns_fused_matmul, rns_matmul,
                                 rns_modmul, rns_reverse)

NAME = "rns-smollm-135m-pallas"


def _residues(rng, mods, shape, dtype=np.int8):
    return np.stack([rng.integers(0, m, shape) for m in mods]).astype(dtype)


def _signed_int8(rng, shape):
    a = rng.integers(-128, 128, shape).astype(np.int8)
    a.reshape(-1)[:3] = [-128, 127, -127]
    return a


@pytest.mark.parametrize("M,K,N", [(8, 576, 192), (5, 1536, 576)])
def test_matmul_broadcast_matches_reference(M, K, N):
    rng = np.random.default_rng(M + K)
    mods = jrns.basis_for_int8_matmul(K).moduli
    x, w = _signed_int8(rng, (M, K)), _signed_int8(rng, (K, N))
    want = jax.jit(lambda a, b: jcp.matmul_broadcast(
        a, b, mods, backend="jnp"))(x, w)
    got = tcp.matmul_broadcast(torch.from_numpy(x), torch.from_numpy(w),
                               mods)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("F", [128, 1536])
def test_matmul_canonical_matches_reference(F):
    M, K, N = 6, 576, 40
    rng = np.random.default_rng(F)
    mods = jrns.basis_for_chain(F).moduli
    a, b = _residues(rng, mods, (M, K)), _residues(rng, mods, (K, N))
    a[:, 0, :4] = np.array(mods)[:, None] - 1          # the (m−1)² corner
    b[:, :4, 0] = np.array(mods)[:, None] - 1
    plan = jcp.ChannelPlan.for_matmul(mods, K, signed=False)
    want = jax.jit(lambda x, y: jcp.matmul(x, y, mods, backend="jnp",
                                           plan=plan))(a, b)
    got = tcp.matmul(torch.from_numpy(a), torch.from_numpy(b), mods,
                     plan=tcp.ChannelPlan.for_matmul(mods, K, signed=False))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("signed_a", [True, False])
def test_matmul_matches_pallas_interpret(signed_a):
    M, K, N = 5, 64, 24
    rng = np.random.default_rng(3)
    mods = jrns.basis_for_chain(128).moduli
    a = (_signed_int8(rng, (1, M, K)) if signed_a
         else _residues(rng, mods, (M, K)))
    b = _residues(rng, mods, (K, N))
    want = jmatmul(jnp.asarray(a), jnp.asarray(b), mods, signed_a=signed_a,
                   block_m=8, block_n=8, block_k=32, interpret=True)
    got = rns_matmul(torch.from_numpy(a), torch.from_numpy(b), mods,
                     signed_a=signed_a)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _signed_values(rng, basis, S):
    half = basis.M // 2
    v = rng.integers(-half, half, S, dtype=np.int64)
    v[:4] = [0, -1, half - 1, -half]
    return np.stack([np.mod(v, m) for m in basis.moduli]).astype(np.int32)


@pytest.mark.parametrize("basis_of", [lambda: jrns.basis_for_int8_matmul(576),
                                      lambda: jrns.basis_for_chain(1536)],
                         ids=["int8-576", "chain-1536"])
@pytest.mark.parametrize("with_scale", [False, True])
def test_reverse_matches_reference(basis_of, with_scale):
    jb = basis_of()
    tb = trns.RNSBasis(name=jb.name, moduli=jb.moduli)
    rng = np.random.default_rng(len(jb.moduli))
    res = _signed_values(rng, jb, 3000).reshape(-1, 3, 1000)
    scale = (rng.random((3, 1)) * 1e-3).astype(np.float32) \
        if with_scale else None
    conv = JConv.for_basis(jb)
    want = jax.jit(lambda r, s: conv.reverse(r, backend="jnp", scale=s))(
        res, scale)
    got = TConv.for_basis(tb).reverse(
        torch.from_numpy(res),
        None if scale is None else torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (3, 1000)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("with_scale", [False, True])
def test_reverse_matches_pallas_interpret(with_scale):
    jb = jrns.basis_for_chain(1536)
    tb = trns.basis_for_chain(1536)
    rng = np.random.default_rng(9)
    res = _signed_values(rng, jb, 300)
    scale = (rng.random(300) * 1e-3).astype(np.float32) \
        if with_scale else None
    want = jreverse(jnp.asarray(res), JConv.for_basis(jb),
                    scale=None if scale is None else jnp.asarray(scale),
                    block=128, interpret=True)
    got = rns_reverse(torch.from_numpy(res), TConv.for_basis(tb),
                      scale=None if scale is None
                      else torch.from_numpy(scale))
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_modmul_matches_reference_and_pallas_interpret(dtype):
    mods = jrns.basis_for_chain(1536).moduli
    rng = np.random.default_rng(4)
    a, b = _residues(rng, mods, 700, dtype), _residues(rng, mods, 700, dtype)
    a[:, 0] = b[:, 0] = np.array(mods) - 1
    want = jax.jit(lambda x, y: jcp.modmul(x, y, mods, backend="jnp"))(a, b)
    kern = jmodmul(jnp.asarray(a), jnp.asarray(b), mods, block=256,
                   interpret=True)
    got = rns_modmul(torch.from_numpy(a), torch.from_numpy(b), mods)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(kern))


def _dense_operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :3] = [0.0, 40.0, -40.0]
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    w[:, 0] = 0.0
    return x, w


@pytest.mark.parametrize("K,N", [(576, 192), (576, 1536), (1536, 576)])
@pytest.mark.parametrize("encoded", [False, True])
def test_staged_dense_matches_jitted_reference(K, N, encoded):
    x, w = _dense_operands(8, K, N, K + N)
    if encoded:
        jw = jrt.encode(jnp.asarray(w))
        want = jax.jit(lambda a, r, s: jlin.rns_dense(
            a, jrt.RNSTensor(residues=r, scale=s, basis=jw.basis, bound=127,
                             signed=True), "jnp"))(
            jnp.asarray(x), jw.residues, jw.scale)
        tw = trt.encode(torch.from_numpy(w))
    else:
        want = jax.jit(lambda a, b: jlin.rns_dense(a, b, "jnp"))(
            jnp.asarray(x), jnp.asarray(w))
        tw = torch.from_numpy(w)
    got = tlin.rns_dense(torch.from_numpy(x), tw, "pallas")
    assert np.asarray(want).tobytes() == got.numpy().tobytes()
    fused = tlin.rns_dense(torch.from_numpy(x), tw, "pallas_fused")
    assert fused.numpy().tobytes() == got.numpy().tobytes()


def test_staged_dense_matches_pallas_interpret():
    x, w = _dense_operands(5, 64, 24, 2)
    want = jax.jit(lambda a, b: jlin.rns_dense(a, b, "pallas"))(
        jnp.asarray(x), jnp.asarray(w))
    got = tlin.rns_dense(torch.from_numpy(x), torch.from_numpy(w), "pallas")
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_staged_ops_validate_operands():
    mods = trns.basis_for_int8_matmul(64).moduli
    a = torch.zeros((1, 4, 64), dtype=torch.int8)
    b = torch.zeros((len(mods), 64, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="signed_a"):
        rns_matmul(a, b, mods)
    with pytest.raises(ValueError, match="do not fit"):
        rns_matmul(a, b[:, :32], mods, signed_a=True)
    with pytest.raises(ValueError, match="does not match"):
        rns_matmul(a, b, mods, signed_a=True,
                   plan=tcp.ChannelPlan.for_matmul(mods, 64, signed=False))
    with pytest.raises(ValueError, match="one shape"):
        rns_modmul(b, b[:, :, :4], mods)
    with pytest.raises(ValueError, match="channels"):
        rns_reverse(b[:2], TConv.for_basis(trns.basis_for_int8_matmul(64)))
    # the per-channel datapath, once refused, runs: bit-equal to the
    # reference's on its jnp backend
    x, w = _dense_operands(2, 64, 8, 1)
    got = tlin.rns_dense(torch.from_numpy(x), torch.from_numpy(w), "pallas",
                         broadcast=False)
    want = jax.jit(lambda a, b: jlin.rns_dense(a, b, "jnp",
                                               broadcast=False))(x, w)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    with pytest.raises(ValueError, match="backend"):
        tlin.rns_dense(torch.zeros(2, 64), torch.zeros(64, 8), "jnp")


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the staged wrappers run the plain versions: no build,
    no launch counted."""
    wrappers = (rns_forward, rns_fused_matmul, rns_matmul, rns_modmul,
                rns_reverse)
    before = [f.launches for f in wrappers]
    x, w = _dense_operands(3, 64, 16, 0)
    tlin.rns_dense(torch.from_numpy(x), torch.from_numpy(w), "pallas")
    assert [f.launches for f in wrappers] == before


@pytest.fixture(scope="module")
def staged_engines():
    jcfg = dataclasses.replace(jax_smoke_config(NAME),
                               linear_backend="rns_int8:jnp")
    return cmp.engines(jcfg, get_smoke_config(NAME))


def test_staged_engine_keeps_live_weights(staged_engines):
    _, teng = staged_engines
    assert teng.cfg.linear_spec.backend == "pallas"
    assert not teng.cfg.linear_spec.encode_weights
    w = teng.params["blocks"]["sub0"]["mlp"]["w_gate"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16


def test_staged_logits_within_tolerance(staged_engines):
    worst = cmp.max_logit_diff(*staged_engines, seeds=range(4))
    print(f"largest logit difference {worst:.4f} "
          f"(tolerance {cmp.LOGIT_ATOL})")
    assert worst <= cmp.LOGIT_ATOL


def test_staged_greedy_tokens_match_where_decisive(staged_engines):
    jeng, teng = staged_engines
    prompts = cmp.prompts(jeng.cfg.vocab_size, [3, 9, 14])
    decisive, equal, flips = cmp.compare_greedy(jeng, teng, prompts, 8)
    print(f"{equal} tokens equal ({decisive} decisive); near-tie flips "
          f"{flips}")
    assert decisive > 0


def test_staged_engine_equals_fused_engine(staged_engines):
    """Live weights on the staged kernels and encoded weights on the fused
    kernel serve the same greedy tokens (each linear is bit-identical)."""
    _, teng = staged_engines
    fcfg = get_smoke_config("rns-smollm-135m-fused")
    from repro_torch.serve.engine import Engine

    feng = Engine(fcfg, teng.params, smax=teng.smax, lanes=teng.lanes,
                  device="cpu")
    prompts = cmp.prompts(teng.cfg.vocab_size, [4, 11])
    assert feng.generate(prompts, max_new_tokens=6) == \
        teng.generate(prompts, max_new_tokens=6)
