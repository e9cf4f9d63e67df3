"""The port's exact-int8 surface against the JAX reference, on the CPU.

`rns_int_matmul` at the reference's signature on its three routes (fused
raw-int8 `rns_fused_matmul`, the staged broadcast matmul, the per-channel
datapath), the raw-int8 / ``scale=`` / unscaled forms of
`rns_fused_matmul`, the raw-int8 and live forms of `rns_fused_crt_partial`
composed through `crt_finish`, `rns_dense(broadcast=False)` with its
straight-through gradients, a smoke model on ``LinearSpec(broadcast=False)``
and the rest of the int8 surface (`RNSTensor.from_int8`, Table III's
channels, `basis_for_accumulation(int8_only=)`, `ChannelPlan.for_channels`,
`rns_chain_linear(scale_row=)`, `attention(kv_valid_from=)`).

On CPU tensors the port's wrappers run their plain versions; the reference
runs on its ``jnp`` backend (its own tests hold jnp equal to its Pallas
kernels), its fused entry and oracle in interpret mode.  Every integer
result and every float epilogue is compared bit for bit: a product of int8
operands is exact in the residue channels and each scale is one IEEE
multiply on both sides.  The gradients and the model's logits carry the
tolerances of `tests/test_torch_ste.py` and `tests/test_torch_model.py`.
Seeds are numpy's, shared by both sides.  The kernels are held against the
plain versions on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import channel_plan as JCP
from repro.core import rns as JR
from repro.core import rns_linear as JL
from repro.core import rns_tensor as JRT
from repro.core import twit as JTW
from repro.core.conversion_plan import ConversionPlan as JConv
from repro.dist import rns_shard as JS
from repro.kernels import ref as JREF
from repro.kernels import rns_fused as JF
from repro.models import layers as JLAY
from repro.models import transformer as JT
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import channel_plan as TCP
from repro_torch.core import rns as TR
from repro_torch.core import rns_linear as TL
from repro_torch.core import rns_tensor as TRT
from repro_torch.core import twit as TTW
from repro_torch.dist import rns_shard as TS
from repro_torch.kernels import rns_fused as TF
from repro_torch.models import layers as TLAY
from repro_torch.models import transformer as TT
from repro_torch.weights import from_jax_params

SCALES = ["none", "scalar", "n", "m1", "mn"]
GRAD_RTOL = 1e-5          # tests/test_torch_ste.py, float32
LOGIT_ATOL = 0.03         # tests/test_torch_model.py


def _ints(rng, shape):
    a = rng.integers(-128, 128, shape).astype(np.int8)
    a.reshape(-1)[:3] = [-128, 127, -127]
    return a


def _scale(kind, M, N, rng):
    """A numpy scale of one broadcast form, or None."""
    return {"none": None,
            "scalar": np.float32(rng.uniform(0.01, 1.0)),
            "n": rng.uniform(0.01, 1.0, (N,)).astype(np.float32),
            "m1": rng.uniform(0.01, 1.0, (M, 1)).astype(np.float32),
            "mn": rng.uniform(0.01, 1.0, (M, N)).astype(np.float32)}[kind]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bits(a):
    return np.asarray(a, np.float32).tobytes()


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return rng, _ints(rng, (M, K)), _ints(rng, (K, N))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("encoded", [False, True], ids=["live", "encoded"])
@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["broadcast", "per_channel"])
@pytest.mark.parametrize("M,K,N", [(5, 64, 12), (16, 96, 16)])
def test_int_matmul_matches_reference(M, K, N, broadcast, encoded, scale):
    """Every route of the port (auto = fused, pallas = staged, and
    pallas_fused) bit-equal to the reference's jnp backend and to the int64
    product times the scale."""
    rng, xq, wq = _operands(M, K, N, M * K + broadcast + 2 * encoded)
    s = _scale(scale, M, N, rng)
    jw = JRT.RNSTensor.from_int8(jnp.asarray(wq)) if encoded \
        else jnp.asarray(wq)
    want = JL.rns_int_matmul(jnp.asarray(xq), jw, broadcast=broadcast,
                             backend="jnp", scale=_j(s))
    tw = TRT.RNSTensor.from_int8(_t(wq)) if encoded else _t(wq)
    oracle = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    if s is not None:
        oracle = oracle * s
    assert _bits(want) == _bits(oracle)
    for backend in ("auto", "pallas", "pallas_fused"):
        got = TL.rns_int_matmul(_t(xq), tw, broadcast=broadcast,
                                backend=backend, scale=_t(s))
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert got.numpy().tobytes() == _bits(want), backend


@pytest.mark.parametrize("backend", ["auto", "pallas", "pallas_fused"])
@pytest.mark.parametrize("broadcast", [True, False])
def test_int_matmul_min_value_and_oracle(backend, broadcast):
    """The reference's −128 regression (tests/test_rns_linear.py): a row
    and a column saturated at −128 reach the worst accumulator K·128², and
    the result is the int64 product on every route."""
    M, K, N = 4, 96, 8
    rng = np.random.default_rng(42)
    xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    xq[0, :] = -128
    wq[:, 0] = -128
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    assert int(want[0, 0]) == K * 128 * 128
    for w in (_t(wq), TRT.RNSTensor.from_int8(_t(wq))):
        got = TL.rns_int_matmul(_t(xq), w, broadcast=broadcast,
                                backend=backend)
        assert np.array_equal(got.numpy().astype(np.int64), want)


def test_int_matmul_checks():
    xq = torch.zeros((4, 64), dtype=torch.int8)
    wt = TRT.RNSTensor.from_int8(torch.zeros((64, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="backend"):
        TL.rns_int_matmul(xq, wt, backend="jnp")
    with pytest.raises(ValueError, match="does not match"):
        TL.rns_int_matmul(xq, wt, TR.basis_for_int8_matmul(1536))
    with pytest.raises(ValueError, match="bound"):
        TL.rns_int_matmul(xq, dataclasses.replace(wt, bound=129))
    with pytest.raises(ValueError, match="unbatched"):
        TL.rns_int_matmul(xq, dataclasses.replace(
            wt, residues=wt.residues[None]))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("encoded", [False, True], ids=["live", "encoded"])
def test_fused_raw_int8_matches_reference_oracle(encoded, scale):
    """The raw-int8 prologue of `rns_fused_matmul`, unscaled or with each
    lowered ``scale=`` form, against the reference's
    `ref.rns_fused_matmul_ref` and its own fused entry (interpret mode)."""
    M, K, N = 6, 96, 16
    rng, xq, wq = _operands(M, K, N, 7 + encoded)
    s = _scale(scale, M, N, rng)
    basis = TR.basis_for_int8_matmul(K)
    jbasis = JR.basis_for_int8_matmul(K)
    jw = JRT.RNSTensor.from_int8(jnp.asarray(wq)) if encoded \
        else jnp.asarray(wq)
    want = JREF.rns_fused_matmul_ref(jnp.asarray(xq), jw, jbasis,
                                     scale=_j(s))
    jfused = JF.rns_fused_matmul(jnp.asarray(xq), jw, jbasis, scale=_j(s),
                                 interpret=True)
    assert _bits(jfused) == _bits(want)
    tw = TRT.RNSTensor.from_int8(_t(wq)) if encoded else _t(wq)
    got = TF.rns_fused_matmul(_t(xq), tw, basis, scale=_t(s))
    assert got.numpy().tobytes() == _bits(want)
    quant = TF.rns_fused_matmul(_t(xq), tw, basis, quantize=False,
                                scale=_t(s))
    assert torch.equal(quant, got)


def test_fused_argument_checks():
    """The reference's checks of `rns_fused_matmul`'s arguments."""
    x = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((64, 8), dtype=torch.int8)
    one = torch.ones(4, 1)
    col = torch.ones(1, 8)
    cases = [(dict(quantize=True), "contradicts"),
             (dict(scale_row=one), "scale_row is the quantize-mode"),
             (dict(scale=col, scale_col=col), "either scale"),
             (dict(emit="residues", scale_row=one), "needs scale_col"),
             (dict(emit="residues", scale_col=col), "needs scale_row"),
             (dict(emit="residues", scale_row=one, scale_col=col,
                   scale=col), "either scale"),
             (dict(requant_creq=torch.tensor(1.0)), "requant_creq"),
             (dict(scale=torch.ones(3)), "broadcast")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            TF.rns_fused_matmul(x, w, **kw)
    with pytest.raises(ValueError, match="contradicts"):
        TF.rns_fused_matmul(x.float(), w, quantize=False, scale_row=one,
                            scale_col=col)


@pytest.mark.parametrize("encoded", [False, True], ids=["live", "encoded"])
@pytest.mark.parametrize("n", [1, 4])
def test_crt_raw_int8_and_live_compose(n, encoded):
    """The raw-int8 slice launches (live weights converted per slice, or
    the encoded slices) summed through `crt_finish` equal the raw-int8
    fused value, and each slice equals the reference's slice bit for
    bit."""
    M, K, N = 8, 64, 24
    rng, xq, wq = _operands(M, K, N, 17 + n)
    basis = TR.basis_for_int8_matmul(K)
    C = len(basis.moduli)
    tw = TRT.RNSTensor.from_int8(_t(wq)) if encoded else _t(wq)
    parts = TS.channel_partials(_t(xq), tw, n, basis=basis)
    plan_g = TCP.ChannelPlan.for_matmul(basis.moduli, K, signed=True)
    jlp = JS.local_plan(JCP.ChannelPlan.for_matmul(basis.moduli, K,
                                                   signed=True), n)
    v, mc, _ = TS.crt_tables(basis)
    w_res = np.stack([np.mod(wq.astype(np.int64), m)
                      for m in basis.moduli]).astype(np.int8)
    Cl = C // n
    for i, got in enumerate(parts):
        sl = slice(i * Cl, (i + 1) * Cl)
        want = JF.rns_fused_crt_partial(
            jnp.asarray(xq), jnp.asarray(w_res[sl] if encoded else wq),
            plan=jlp, conv=JConv.build(jlp.moduli), mods=plan_g.mods[sl], sched=plan_g.sched[sl], crt_v=v[sl],
            crt_mc=mc[sl], interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(want)), i
    for s in (None, _scale("m1", M, N, rng), _scale("mn", M, N, rng)):
        composed = TS.channel_sliced_matmul(_t(xq), tw, n, basis=basis,
                                            scale=_t(s))
        fused = TF.rns_fused_matmul(_t(xq), tw, basis, scale=_t(s))
        assert composed.numpy().tobytes() == fused.numpy().tobytes()


@pytest.mark.parametrize("encoded", [False, True], ids=["live", "encoded"])
def test_dense_per_channel_forward_and_gradients(encoded):
    """`rns_dense(broadcast=False)` bit-equal to the reference's on its jnp
    backend and to the port's broadcast datapath; the straight-through
    gradients within GRAD_RTOL of the reference's under `jax.grad`."""
    M, K, N = 6, 96, 16
    rng = np.random.default_rng(5 + encoded)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    gy = rng.standard_normal((M, N)).astype(np.float32)
    jw = JRT.encode(jnp.asarray(w)) if encoded else jnp.asarray(w)
    tw = TRT.encode(_t(w)) if encoded else _t(w)

    def jloss(a, b):
        return jnp.sum(JL.rns_dense(a, b, "jnp", broadcast=False) * gy)

    want = jax.jit(lambda a, b: JL.rns_dense(a, b, "jnp",
                                             broadcast=False))(
        jnp.asarray(x), jw)
    tx = _t(x).requires_grad_(True)
    if encoded:
        got = TL.rns_dense(tx, tw, "pallas", broadcast=False)
        jgx = jax.grad(lambda a: jloss(a, jw))(jnp.asarray(x))
    else:
        tw.requires_grad_(True)
        got = TL.rns_dense(tx, tw, "auto", broadcast=False)
        jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    assert got.detach().numpy().tobytes() == np.asarray(want).tobytes()
    assert torch.equal(got.detach(), TL.rns_dense(_t(x), tw, "auto").detach())
    (got * _t(gy)).sum().backward()
    for g, jg in ((tx.grad, jgx),) + (() if encoded else ((tw.grad, jgw),)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=GRAD_RTOL * np.abs(jg).max())


def test_per_channel_smoke_model_logits():
    """The smoke `rns-smollm-135m-fused` model with every linear on the
    per-channel datapath (``LinearSpec(broadcast=False)``, through
    `models/layers.linear`): prefill logits within LOGIT_ATOL of the
    reference's model (whose datapaths are bit-equal to each other)."""
    name = "rns-smollm-135m-fused"
    jcfg, tcfg = jax_smoke_config(name), get_smoke_config(name)
    tcfg.__dict__["linear_spec"] = dataclasses.replace(tcfg.linear_spec,
                                                       broadcast=False)
    assert tcfg.linear_spec.broadcast is False
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    tp = TRT.encode_params(from_jax_params(jax.tree.map(np.asarray, jp),
                                           tcfg, device="cpu"))
    jpe = JRT.encode_params(jp, backend="pallas_fused")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, (3, 16)).astype(np.int32)
    pad = np.array([0, 5, 11], np.int32)
    jl, _, _ = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, 24))(
        jpe, {"tokens": jnp.asarray(toks), "pad": jnp.asarray(pad)})
    tl, _, _ = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64)), "pad": torch.from_numpy(pad)}, 24)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl),
                               atol=LOGIT_ATOL)


def _params(fn, drop):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters
            .values() if p.name not in drop]


def test_signatures_match_reference():
    """The port's entries take the reference's arguments, in its order,
    less ``interpret``, the TPU's ``block_*`` and the crt entry's ``conv``
    (no conversion plan in the CRT epilogue)."""
    drop = {"interpret", "block_m", "block_n", "block_k", "conv"}
    for port, ref in ((TL.rns_int_matmul, JL.rns_int_matmul),
                      (TF.rns_fused_matmul, JF.rns_fused_matmul),
                      (TF.rns_fused_crt_partial, JF.rns_fused_crt_partial),
                      (TS.sharded_fused_matmul, JS.sharded_fused_matmul),
                      (TL.rns_chain_linear, JL.rns_chain_linear),
                      (TRT.RNSTensor.from_int8, JRT.RNSTensor.from_int8)):
        # the reference's from_int8 also takes a conversion backend
        want = _params(ref, drop | {"backend"} if ref ==
                       JRT.RNSTensor.from_int8 else drop)
        assert _params(port, drop) == want, port.__name__


def test_from_int8_and_dequant():
    rng = np.random.default_rng(3)
    q = _ints(rng, (2, 64, 8))
    s = rng.uniform(0.01, 1.0, (2, 1, 8)).astype(np.float32)
    jt = JRT.RNSTensor.from_int8(jnp.asarray(q), jnp.asarray(s))
    tt = TRT.RNSTensor.from_int8(_t(q), _t(s))
    assert (tt.bound, tt.k, tt.residue_dtype) == \
        (jt.bound, jt.k, torch.int8) == (128, 4, torch.int8)
    assert np.array_equal(tt.residues.numpy(), np.asarray(jt.residues))
    assert tt.dequant().numpy().tobytes() == \
        np.asarray(jt.dequant(backend="jnp")).tobytes()
    assert tt[1].bound == 128 and tt[1].scale.shape == (1, 8)
    bare = TRT.RNSTensor.from_int8(_t(q[0]))
    assert bare.scale is None
    assert np.array_equal(bare.dequant().numpy(), q[0].astype(np.float32))
    with pytest.raises(ValueError, match="dequant scale"):
        TL.rns_dense(torch.zeros(2, 64), bare)


def test_table_iii_channels_and_accumulation_bases():
    for tf, jf in ((TR.n8_channels, JR.n8_channels),
                   (TR.n11_channels, JR.n11_channels)):
        assert [(c.m, c.n, c.delta) for c in tf()] == \
            [(c.m, c.n, c.delta) for c in jf()]
    for max_abs in (1, 1000, 96 * 128 * 128, 10 ** 12):
        for int8_only in (True, False):
            assert TR.basis_for_accumulation(
                max_abs, int8_only=int8_only).moduli == \
                JR.basis_for_accumulation(max_abs,
                                          int8_only=int8_only).moduli
    wide = TR.basis_for_accumulation(64 * 128 * 128, int8_only=False)
    assert 1024 in wide.moduli
    # the plain path takes the wide basis; the kernel's datapath refuses it
    rng = np.random.default_rng(8)
    xq, wq = _ints(rng, (3, 64)), _ints(rng, (64, 5))
    want = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    got = TL.rns_int_matmul(_t(xq), _t(wq), wide, broadcast=False,
                            backend="pallas")
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="int8"):
        TF.rns_fused_matmul(_t(xq), _t(wq), wide)


def test_plan_for_channels():
    """Plans over explicit channels at the paper's forced width n = 5 (a
    power-of-two channel included) equal the reference's."""
    mods = [m for m in JR.PAPER_N5_MODULI if m != 1024] + [32]
    for bound, signed in ((46 * 46 * 64, False), (128 * 46 * 64, True)):
        tp = TCP.ChannelPlan.for_channels(
            [TTW.Modulus.from_value(m, n=5) for m in mods], bound,
            signed=signed)
        jp = JCP.ChannelPlan.for_channels(
            [JTW.Modulus.from_value(m, n=5) for m in mods], bound,
            signed=signed)
        assert (tp.moduli, tp.rungs, tp.n_sub, tp.signed) == \
            (jp.moduli, jp.rungs, jp.n_sub, jp.signed)


def test_chain_linear_scale_row():
    """`rns_chain_linear(scale_row=)` replaces the activation's row scale,
    fused and staged bit-equal to the reference's jnp twin."""
    M, K, N = 4, 64, 16
    rng = np.random.default_rng(9)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    srow = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    tb, jb = TR.basis_for_chain(K), JR.basis_for_chain(K)
    jx = JRT.encode_activation(jnp.asarray(x), jb, backend="jnp")
    want = JL.rns_chain_linear(jx, JRT.encode(jnp.asarray(w), jb),
                               scale_row=jnp.asarray(srow), backend="jnp")
    tx = TRT.encode_activation(_t(x), tb)
    assert np.array_equal(tx.residues.numpy(), np.asarray(jx.residues))
    for backend in ("pallas", "pallas_fused"):
        got = TL.rns_chain_linear(tx, TRT.encode(_t(w), tb),
                                  scale_row=_t(srow), backend=backend)
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), backend


def test_attention_kv_valid_from():
    """Keys below position ``kv_valid_from`` are masked, as in the
    reference's `layers.attention`, on both branches."""
    rng = np.random.default_rng(2)
    B, Hq, Hk, D = 2, 4, 2, 16
    for Sq, Sk, block in ((1, 24, 1024), (20, 40, 8)):
        q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
        k = rng.standard_normal((B, Sk, Hk, D)).astype(np.float32)
        v = rng.standard_normal((B, Sk, Hk, D)).astype(np.float32)
        qpos = np.arange(Sk - Sq, Sk, dtype=np.int32)
        kpos = np.arange(Sk, dtype=np.int32)
        for start in (0, 5):
            want = JLAY.attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(qpos),
                                  jnp.asarray(kpos), window=1 << 30,
                                  block_kv=block, kv_valid_from=start)
            got = TLAY.attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos),
                                 block_kv=block, kv_valid_from=start)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="kv_valid_from"):
        TLAY.attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos),
                       kv_valid_from=-1)
