"""The port's dense model against the JAX reference on the smoke
`rns-smollm-135m-fused` config, with the reference's own `make_params`
weights carried over by `from_jax_params` and encoded by each side itself.

Tolerance.  Op by op the port is bit-equal to the reference (each reference
op jitted alone); the one exception is RoPE's cos/sin, where XLA's and
torch's float32 polynomials differ by an ulp.  Whole-model outputs are not
bit-equal: the reference jits the whole prefill/decode, and XLA then fuses
ops and skips intermediate bfloat16 roundings (excess precision), which no
op-by-op program reproduces.  Those last-bit differences cross int8
quantization boundaries in the next RNS linear and grow layer by layer.
The tests below print what they measure: on these weights logits differ by
at most 0.011 (|logits| <= 0.7) over four token batches, hidden states by
at most 1.8% of the layer's largest value.  The tolerances are about 2.5
times that: LOGIT_ATOL = 0.03, HIDDEN_RTOL = 0.04 of the layer's max |h|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.rns_tensor import encode_params as jax_encode_params
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.rns_tensor import encode_params
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.weights import from_jax_params

NAME = "rns-smollm-135m-fused"
LOGIT_ATOL = 0.03
HIDDEN_RTOL = 0.04


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_smoke_config(NAME), get_smoke_config(NAME)
    jp = JT.make_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (jcfg, jax_encode_params(jp, backend="pallas_fused"),
            tcfg, encode_params(tp))


def _batch(cfg, B=3, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    pad = np.array([0, 5, 11][:B], np.int32)
    return ({"tokens": jnp.asarray(toks), "pad": jnp.asarray(pad)},
            {"tokens": torch.from_numpy(toks.astype(np.int64)),
             "pad": torch.from_numpy(pad)})


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    """Reference array → torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_layer_ops_bit_equal(models):
    """Each op of layer 0, jitted alone in the reference, equals the port's
    op on the same inputs bit for bit (RoPE to float32 ulps)."""
    jcfg, jpe, tcfg, tpe = models
    jb, tb = _batch(jcfg)
    jh, jpos = JT._embed(jcfg, jpe, jb)
    th, tpos = TT._embed(tcfg, tpe, tb)
    assert np.array_equal(_np(jh), th.float().numpy())
    jp0 = jax.tree.map(lambda a: a[0], jpe["blocks"])["sub0"]
    tp0 = TT._layer(tpe["blocks"]["sub0"], 0)
    spec = jcfg.linear_spec

    jx = jax.jit(JL.rms_norm)(jh, jp0["norm_mix"])
    assert _np(jx).tobytes() == TL.rms_norm(th, tp0["norm_mix"]) \
        .float().numpy().tobytes()
    x = _t(jx)
    for name in ("wq", "wk", "wv"):
        want = jax.jit(lambda a, w: JL.linear(a, w, spec))(jx, jp0["attn"][name])
        got = TL.linear(x, tp0["attn"][name], tcfg.linear_backend)
        assert _np(want).tobytes() == got.float().numpy().tobytes()

    H, Hk, dh = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    B, S = jb["tokens"].shape
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jcos, jsin = jax.jit(lambda p: JL.rope(p, dh))(jpos)
    tcos, tsin = TL.rope(tpos, dh)
    np.testing.assert_allclose(tcos.numpy(), _np(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), _np(jsin), atol=1e-6)
    jo = jax.jit(lambda a, b, c, p: JL.attention(a, b, c, p, p,
                                                 window=JT.FULL_WINDOW))(
        q, k, v, jpos)
    to = TL.attention(_t(q), _t(k), _t(v), tpos, tpos)
    assert _np(jo).tobytes() == to.float().numpy().tobytes()

    g = jnp.asarray(rng.standard_normal((B, S, 4 * dh)) * 3, jnp.bfloat16)
    assert _np(jax.jit(jax.nn.silu)(g)).tobytes() == \
        TL.silu(_t(g)).float().numpy().tobytes()


def test_blocked_attention_matches_reference():
    """The online-softmax branch (keys > 2·block_kv) against the
    reference's, with left-padded positions."""
    rng = np.random.default_rng(2)
    B, S, H, Hk, D = 2, 40, 4, 2, 16
    q, k, v = (jnp.asarray(rng.standard_normal((B, S, h, D)), jnp.float32)
               for h in (H, Hk, Hk))
    pad = np.array([0, 13], np.int32)
    pos = np.arange(S, dtype=np.int32)[None] - pad[:, None]
    want = jax.jit(lambda a, b, c, p: JL.attention(
        a, b, c, p, p, window=JT.FULL_WINDOW, block_kv=8))(
        q, k, v, jnp.asarray(pos))
    got = TL.attention(_t(q), _t(k), _t(v), torch.from_numpy(pos),
                       torch.from_numpy(pos), block_kv=8)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-6)


def test_hidden_states_within_tolerance(models):
    jcfg, jpe, tcfg, tpe = models
    jb, tb = _batch(jcfg)
    jh, jpos = JT._embed(jcfg, jpe, jb)
    th, tpos = TT._embed(tcfg, tpe, tb)

    @jax.jit
    def jlayer(p, h, pos):
        o, _ = JT._attn_full(p, h, jcfg, JT.FULL_WINDOW, pos)
        h = h + o
        return h + JT._mlp(p, h, jcfg)

    S = jb["tokens"].shape[1]
    valid = np.arange(S)[None] >= np.asarray(jb["pad"])[:, None]
    for b in range(jcfg.n_blocks):
        jh = jlayer(jax.tree.map(lambda a: a[b], jpe["blocks"])["sub0"],
                    jh, jpos)
        p = TT._layer(tpe["blocks"]["sub0"], b)
        o, _ = TT._attn_full(p, th, tcfg, TL.FULL_WINDOW, tpos)
        th = th + o
        th = th + TT._mlp(p, th, tcfg)
        ref, got = _np(jh)[valid], th.float().numpy()[valid]
        err = np.abs(ref - got).max() / np.abs(ref).max()
        assert err <= HIDDEN_RTOL, (b, err)
        print(f"layer {b}: hidden-state difference {err:.4f} of max |h|")


def test_prefill_and_decode_logits_within_tolerance(models):
    """Prefill and one decode step on four token batches of the same
    shapes; prints the largest logit difference seen."""
    jcfg, jpe, tcfg, tpe = models
    smax = 24
    jprefill = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, smax))
    jdecode = jax.jit(lambda p, c, t, pos, ps: JT.decode_step(
        jcfg, p, c, {"tokens": t}, pos, positions=ps))
    worst = 0.0
    for seed in range(4):
        jb, tb = _batch(jcfg, seed=seed)
        S = jb["tokens"].shape[1]
        jl, jc, _ = jprefill(jpe, jb)
        tl, tc, s = TT.prefill(tcfg, tpe, tb, smax)
        assert s == S and tl.shape == (3, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        positions = S - np.asarray(jb["pad"])
        jdl, _ = jdecode(jpe, jc, jnp.asarray(cur)[:, None], S,
                         jnp.asarray(positions))
        tdl, _ = TT.decode_step(
            tcfg, tpe, tc,
            {"tokens": torch.from_numpy(cur.astype(np.int64))[:, None]}, S,
            positions=torch.from_numpy(positions))
        np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl),
                                   atol=LOGIT_ATOL)
        worst = max(worst, np.abs(tl.numpy() - np.asarray(jl)).max(),
                    np.abs(tdl.numpy() - np.asarray(jdl)).max())
    print(f"largest logit difference {worst:.4f} (tolerance {LOGIT_ATOL})")


def test_from_jax_params_checks_layout(models):
    jcfg, _, tcfg, _ = models
    jp = jax.tree.map(np.asarray, JT.make_params(jcfg, jax.random.PRNGKey(1)))
    tp = from_jax_params(jp, tcfg, device="cpu")
    assert tp["blocks"]["sub0"]["attn"]["wq"].dtype == torch.bfloat16
    assert np.array_equal(
        tp["embed"].float().numpy(), jp["embed"].astype(np.float32))
    bad = dict(jp, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        from_jax_params(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        from_jax_params({k: v for k, v in jp.items() if k != "embed"}, tcfg,
                        device="cpu")
