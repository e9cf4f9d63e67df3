"""The port's plan layer, quantizer, encode and limb helpers against the JAX
reference, on the CPU: tables equal, integer datapaths bit-equal, the scale
rule bit-equal to the *jitted* reference (the regime serving runs in)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel_plan as jcp
from repro.core import conversion_plan as jconv
from repro.core import multiword as jmw
from repro.core import quant as jquant
from repro.core import rns as jrns
from repro.core import rns_tensor as jrt
from repro_torch.core import channel_plan as tcp
from repro_torch.core import conversion_plan as tconv
from repro_torch.core import multiword as tmw
from repro_torch.core import quant as tquant
from repro_torch.core import rns as trns
from repro_torch.core import rns_tensor as trt

CHANNEL_SETS = {
    "paper-n5": jrns.PAPER_N5_MODULI,
    "n8": jrns.N8_CHANNELS,
    "n11": jrns.N11_CHANNELS,
}
INT8_KS = [64, 128, 576, 1536]


@pytest.mark.parametrize("name", sorted(CHANNEL_SETS))
@pytest.mark.parametrize("bound", [127 * 127, 576 * 128 * 46, 2**30])
@pytest.mark.parametrize("signed", [False, True])
def test_channel_plan_tables_match(name, bound, signed):
    mods = CHANNEL_SETS[name]
    try:
        want = jcp.ChannelPlan.build(mods, bound, signed=signed)
    except ValueError:
        with pytest.raises(ValueError):        # both refuse the plan
            tcp.ChannelPlan.build(mods, bound, signed=signed)
        return
    got = tcp.ChannelPlan.build(mods, bound, signed=signed)
    assert np.array_equal(got.sched, want.sched)
    assert np.array_equal(got.mods, want.mods)
    assert got.n_sub == want.n_sub and got.signed == want.signed


@pytest.mark.parametrize("k", INT8_KS)
def test_int8_matmul_basis_and_plans_match(k):
    jb, tb = jrns.basis_for_int8_matmul(k), trns.basis_for_int8_matmul(k)
    assert tb.moduli == jb.moduli and tb.M == jb.M
    assert tb.mrc_inverses == jb.mrc_inverses
    for signed in (False, True):
        jp = jcp.ChannelPlan.for_matmul(jb.moduli, k, signed=signed)
        tp = tcp.ChannelPlan.for_matmul(tb.moduli, k, signed=signed)
        assert np.array_equal(tp.sched, jp.sched)
        assert tp.n_sub == jp.n_sub and tp.bound == jp.bound
    jc, tc = jconv.ConversionPlan.for_basis(jb), \
        tconv.ConversionPlan.for_basis(tb)
    assert np.array_equal(tc.inv, jc.inv)
    assert (tc.M, tc.half, tc.nlimbs) == (jc.M, jc.half, jc.nlimbs)
    assert tc.residue_dtype == torch.int8


def test_smollm_basis_numbers():
    """The numbers the kernel is shaped by (K = 576 and 1536)."""
    for k in (576, 1536):
        b = trns.basis_for_int8_matmul(k)
        c = tconv.ConversionPlan.for_basis(b)
        p = tcp.ChannelPlan.for_matmul(b.moduli, k, signed=True)
        assert b.moduli == (47, 43, 41, 39, 37) and b.M == 119_568_423
        assert (c.nlimbs, p.num_rungs, p.n_sub) == (2, 5, 3)
    assert len(trns.basis_for_int8_matmul(64).moduli) == 4


def test_paper_n5_conversion_plan_matches():
    jb = jrns.paper_n5_basis()
    tb = trns.RNSBasis(name="paper", moduli=trns.PAPER_N5_MODULI)
    jc, tc = jconv.ConversionPlan.for_basis(jb), \
        tconv.ConversionPlan.for_basis(tb)
    assert tb.M == jrns.PAPER_N5_DYNAMIC_RANGE
    assert np.array_equal(tc.inv, jc.inv)
    assert (tc.M, tc.half, tc.nlimbs) == (jc.M, jc.half, jc.nlimbs)
    assert tc.residue_dtype == torch.int32


def _adversarial(shape, seed):
    """Uniform floats plus values whose max|x|/127 lands where an eager
    divide and the compiled reciprocal multiply disagree."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, shape).astype(np.float32)
    x.reshape(-1)[::7] = rng.uniform(0, 1e-3, x.size)[::7]
    return x


@pytest.mark.parametrize("axis", [-1, 0])
def test_quant_scale_matches_jitted_reference(axis):
    x = _adversarial((4000, 64), 0)
    want = np.asarray(jax.jit(lambda a: jquant.quant_scale(a, axis))(x))
    got = tquant.quant_scale(torch.from_numpy(x), dim=axis).numpy()
    assert got.tobytes() == want.tobytes()
    # the hazard is real: an eager divide by 127 disagrees somewhere
    amax = np.maximum(np.abs(x).max(axis=axis, keepdims=True),
                      np.float32(1e-8))
    assert not np.array_equal(amax / np.float32(127.0), want)


def test_quantize_int8_matches_jitted_reference():
    x = _adversarial((64, 300), 1)
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    x[1] = 0.0                                   # all-zero row: 1e-8 floor
    x[2, :3] = [3.0, -3.0, 1.5]                  # exact ±127 and a .5 tie
    jq, js = jax.jit(lambda a: jquant.quantize_int8(a, axis=-1))(x)
    tq, ts = tquant.quantize_int8(torch.from_numpy(x), dim=-1)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tq.min() >= -127 and tq.max() <= 127


@pytest.mark.parametrize("shape", [(64, 96), (3, 576, 192), (2, 1536, 64)])
def test_encode_matches_jitted_reference(shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    jt = jrt.encode(jnp.asarray(w))              # jitted inside
    tt = trt.encode(torch.from_numpy(w))
    assert tt.moduli == jt.moduli
    assert tt.residues.dtype == torch.int8
    assert np.array_equal(tt.residues.numpy(), np.asarray(jt.residues))
    assert tt.scale.numpy().tobytes() == np.asarray(jt.scale).tobytes()


def test_encode_params_selects_linear_leaves():
    w = torch.randn(2, 8, 4)
    params = {"embed": torch.randn(5, 8),
              "blocks": {"sub0": {"norm_mix": torch.zeros(2, 8),
                                  "attn": {"wq": w},
                                  "mlp": {"w_up": w}}}}
    enc = trt.encode_params(params)
    assert isinstance(enc["blocks"]["sub0"]["attn"]["wq"], trt.RNSTensor)
    assert isinstance(enc["blocks"]["sub0"]["mlp"]["w_up"], trt.RNSTensor)
    assert enc["embed"] is params["embed"]
    layer = enc["blocks"]["sub0"]["attn"]["wq"][1]
    assert tuple(layer.residues.shape) == (4, 8, 4)
    assert trt.encode_params(enc)["blocks"]["sub0"]["attn"]["wq"] is \
        enc["blocks"]["sub0"]["attn"]["wq"]


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_forward_conversion_matches(dtype):
    mods = jrns.basis_for_int8_matmul(576).moduli
    if dtype == np.int8:
        x = np.arange(-128, 128, dtype=np.int8)
    else:
        rng = np.random.default_rng(3)
        x = rng.integers(-2**31, 2**31 - 1, 5000, dtype=np.int64)
        x[:4] = [-2**31, 2**31 - 1, -1, 0]
        x = x.astype(np.int32)
    want = np.asarray(jconv.forward(jnp.asarray(x), mods, backend="jnp",
                                    dtype=jnp.int32))
    got = tconv.forward(torch.from_numpy(x), mods, dtype=torch.int32)
    assert np.array_equal(got.numpy(), want)
    got8 = tconv.forward(torch.from_numpy(x), mods)
    assert got8.dtype == torch.int8 and np.array_equal(got8.numpy(), want)


def test_limb_helpers_match():
    basis = jrns.basis_for_int8_matmul(1536)
    L = jconv.ConversionPlan.for_basis(basis).nlimbs
    rng = np.random.default_rng(4)
    d = [rng.integers(0, m, 4096).astype(np.int32) for m in basis.moduli]
    d[0][:2] = 0
    d[-1][:2] = [0, basis.moduli[-1] - 1]
    jacc = jmw.limbs_from_scalar(jnp.asarray(d[-1]), L)
    tacc = tmw.limbs_from_scalar(torch.from_numpy(d[-1]), L)
    for j in range(len(d) - 2, -1, -1):
        jacc = jmw.limbs_horner(jacc, basis.moduli[j], jnp.asarray(d[j]))
        tacc = tmw.limbs_horner(tacc, basis.moduli[j], torch.from_numpy(d[j]))
    for a, b in zip(tacc, jacc):
        assert np.array_equal(a.numpy(), np.asarray(b))
    half = (basis.M + 1) // 2
    assert np.array_equal(tmw.limbs_ge_const(tacc, half).numpy(),
                          np.asarray(jmw.limbs_ge_const(jacc, half)))
    for a, b in zip(tmw.limbs_const_minus(basis.M, tacc),
                    jmw.limbs_const_minus(basis.M, jacc)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jf = jax.jit(jmw.limbs_to_float)(jacc)
    assert tmw.limbs_to_float(tacc).numpy().tobytes() == \
        np.asarray(jf).tobytes()
    assert tmw.to_limbs_const(basis.M, L) == jmw.to_limbs_const(basis.M, L)
    assert tmw.nlimbs_for(basis.M) == jmw.nlimbs_for(basis.M)


@pytest.mark.parametrize("k", [64, 576])
def test_reverse_matches_reference(k):
    """The plain MRC reverse (what the fused epilogue computes) against the
    reference's, over the whole signed range of the basis incl. ±(M−1)/2."""
    jb, tb = jrns.basis_for_int8_matmul(k), trns.basis_for_int8_matmul(k)
    rng = np.random.default_rng(k)
    half = (jb.M - 1) // 2
    v = rng.integers(-half, half + 1, 3000, dtype=np.int64)
    v[:5] = [-half, half, 0, -1, 1]
    res = np.stack([np.mod(v, m) for m in jb.moduli]).astype(np.int32)
    want = np.asarray(jax.jit(lambda r: jconv.ConversionPlan.for_basis(jb)
                              .reverse(r, backend="jnp"))(res))
    got = tconv.ConversionPlan.for_basis(tb).reverse(torch.from_numpy(res))
    assert got.numpy().tobytes() == want.tobytes()
