"""The residency pass (`repro_torch.analysis.residency`) against the
reference's (`repro.analysis.residency`): kernel calls of `rns_dense` (1
fused, 3 staged, as `tests/test_kernels.py` asserts of ``pallas_call``);
each served smoke config's decode step and prefill calling exactly what
`residency.expected_*` says, and what the reference's jaxpr holds in
``pallas_call``s (each scanned layer's counted once a trip); no modular
reduction outside a kernel on the resident path; stray `torch.remainder`,
``.item()`` and ``nonzero`` flagged by name; `assert_clean(fn, cfg, …)`
over the resident decode step, as `tests/test_chain.py` runs it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.analysis as tan
from repro.configs.base import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.serve.engine import Engine as RefEngine
from repro_torch.analysis import AnalysisError, residency
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.rns_linear import rns_dense
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine
from repro_torch.weights import from_jax_params

SERVED = ["rns-smollm-135m-fused", "rns-smollm-135m-resident",
          "rns-smollm-135m-pallas", "rns-smollm-135m",
          "rns-smollm-135m-encoded"]
# configs whose reference backend is a Pallas kernel on any platform (the
# reference's "auto" takes plain jnp off a TPU, the port's the fused kernel)
EXPLICIT = ["rns-smollm-135m-fused", "rns-smollm-135m-resident",
            "rns-smollm-135m-pallas"]
PROMPTS = [[1, 2, 3], [4, 5]]


def _messages(report):
    return " | ".join(str(f) for f in report.findings)


def test_rns_dense_kernel_calls():
    """The whole quantize → forward → matmul → fold → reverse → dequant
    pipeline is ONE kernel call fused, three staged."""
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((6, 96)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((96, 10)).astype(np.float32))
    fused = residency.summarize_fn(lambda a, b: rns_dense(a, b,
                                                          "pallas_fused"),
                                   x, w)
    staged = residency.summarize_fn(lambda a, b: rns_dense(a, b, "pallas"),
                                    x, w)
    assert dict(fused.kernel_calls) == {"rns_fused_matmul": 1}
    assert dict(staged.kernel_calls) == {"rns_forward": 1, "rns_matmul": 1,
                                         "rns_reverse": 1}
    # the plain versions' ops run inside the regions; nothing modular
    # outside
    for s in (fused, staged):
        assert s.count_outside(residency.MODULAR_OPS) == 0
        assert s.count_outside(["aten.mm", "aten.bmm"]) == 0
        assert sum(s.inside.values()) > 0
    tan.assert_clean(lambda a, b: rns_dense(a, b, "pallas_fused"), None, x,
                     w, expect_kernel_calls=1, subject="fused")
    tan.assert_clean(lambda a, b: rns_dense(a, b, "pallas"), None, x, w,
                     expect_kernel_calls=3, subject="staged")
    with pytest.raises(AnalysisError, match="expected exactly 1"):
        tan.assert_clean(lambda a, b: rns_dense(a, b, "pallas"), None, x,
                         w, expect_kernel_calls=1)


def _ref_pallas_calls(closed) -> int:
    """``pallas_call`` sites of a jaxpr, each inside a scan counted once a
    trip (the reference scans its layers)."""
    def walk(jx, mult):
        n = 0
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                n += mult
                continue
            inner = mult * (eqn.params["length"]
                            if eqn.primitive.name == "scan" else 1)
            for v in eqn.params.values():
                for j in (v if isinstance(v, (list, tuple)) else [v]):
                    core = getattr(j, "jaxpr", None)
                    sub = core if core is not None and hasattr(core, "eqns") \
                        else (j if hasattr(j, "eqns") else None)
                    if sub is not None:
                        n += walk(sub, inner)
        return n
    return walk(closed.jaxpr, 1)


@pytest.fixture(scope="module")
def served():
    """(cfg, engine, prefill cache, packed batch, plen) of each served
    smoke config on the CPU, weights from the reference's generator."""
    out = {}
    for arch in SERVED:
        cfg = get_smoke_config(arch)
        params = from_jax_params(RT.make_params(ref_smoke(arch),
                                                jax.random.PRNGKey(0)), cfg,
                                 device="cpu")
        eng = Engine(cfg, params, smax=32, device="cpu")
        batch, plen = eng._pack(PROMPTS)
        out[arch] = (cfg, eng, batch, plen)
    return out


def _decode(cfg, eng, batch, plen):
    with torch.inference_mode():
        _, cache, _ = T.prefill(cfg, eng.params, batch, eng.smax)
    tok = torch.zeros((len(PROMPTS), 1), dtype=torch.int32)
    pos = torch.full((len(PROMPTS),), plen, dtype=torch.int32)

    def step():
        with torch.inference_mode():
            return T.decode_step(cfg, eng.params, cache, {"tokens": tok},
                                 plen, positions=pos)
    return step


@pytest.mark.parametrize("arch", SERVED)
def test_decode_and_prefill_calls_match_dispatch(served, arch):
    cfg, eng, batch, plen = served[arch]
    dec = residency.summarize_fn(_decode(cfg, eng, batch, plen))
    assert dict(dec.kernel_calls) == \
        residency.kernel_calls(residency.expected_step(cfg))
    pre = residency.summarize_fn(lambda: T.prefill(cfg, eng.params, batch,
                                                   eng.smax))
    assert dict(pre.kernel_calls) == \
        residency.kernel_calls(residency.expected_prefill(cfg))
    # a decode step reads nothing back on the host
    assert not dec.syncs, dict(dec.syncs)
    tan.assert_clean(_decode(cfg, eng, batch, plen), None,
                     expect_kernel_calls=residency.expected_step(cfg),
                     require_no_sync=True, subject=f"{arch}-decode")


@pytest.mark.parametrize("arch", EXPLICIT)
def test_calls_equal_reference_pallas_calls(served, arch):
    """The port's kernel calls a step equal the reference's ``pallas_call``
    sites of the same smoke config's step, layers unrolled."""
    cfg, eng, batch, plen = served[arch]
    rcfg = ref_smoke(arch)
    rparams = RT.make_params(rcfg, jax.random.PRNGKey(0))
    reng = RefEngine(rcfg, rparams, smax=32)
    rbatch, rplen = reng._pack(PROMPTS)
    assert rplen == plen
    ref_pre = _ref_pallas_calls(jax.make_jaxpr(
        lambda p, b: RT.prefill(rcfg, p, b, 32))(reng.params, rbatch))
    _, rcache, _ = reng._prefill(reng.params, rbatch, smax=reng.smax)
    ref_dec = _ref_pallas_calls(jax.make_jaxpr(
        lambda p, c, t, pos: RT.decode_step(rcfg, p, c, {"tokens": t},
                                            jnp.int32(rplen),
                                            positions=pos))(
        reng.params, rcache, jnp.zeros((2, 1), jnp.int32),
        jnp.zeros((2,), jnp.int32)))
    dec = residency.summarize_fn(_decode(cfg, eng, batch, plen))
    pre = residency.summarize_fn(lambda: T.prefill(cfg, eng.params, batch,
                                                   eng.smax))
    assert (dec.kernel_total, pre.kernel_total) == (ref_dec, ref_pre)
    assert dec.kernel_total == sum(
        residency.kernel_calls(residency.expected_step(cfg)).values())


def test_resident_decode_zero_standalone_conversions(served):
    """The serving proof: the resident decode step runs no remainder
    outside a kernel region; and it called kernels, so the proof is not
    vacuous."""
    cfg, eng, batch, plen = served["rns-smollm-135m-resident"]
    assert cfg.linear_spec.domain == "residue"
    summ = residency.summarize_fn(_decode(cfg, eng, batch, plen))
    assert residency.check_resident(summ).ok
    assert summ.count_outside(residency.MODULAR_OPS) == 0
    assert summ.inside["aten.remainder"] > 0      # the plain versions' mods
    rep = tan.assert_clean(_decode(cfg, eng, batch, plen), cfg,
                           subject="resident-decode")
    assert rep.ok


def test_stray_remainder_and_vacuous_proof_are_flagged():
    summ = residency.summarize_fn(lambda x: torch.remainder(x, 7),
                                  torch.arange(8, dtype=torch.int32))
    rep = residency.check_resident(summ, subject="leaky")
    assert not rep.ok
    msg = _messages(rep)
    assert "outside a kernel region" in msg and "aten.remainder" in msg
    assert "vacuous" in msg
    fm = residency.summarize_fn(lambda x: torch.fmod(x, 5) + x % 3,
                                torch.arange(8, dtype=torch.int32))
    assert fm.count_outside(residency.MODULAR_OPS) == 2
    with pytest.raises(AnalysisError, match="kernel region"):
        tan.assert_clean(lambda x: torch.remainder(x, 5), None,
                         torch.arange(4, dtype=torch.int32), resident=True)


def test_stray_remainder_in_a_resident_step_is_flagged(served, monkeypatch):
    """A `torch.remainder` slipped into the resident decode step (here
    after the RMSNorm) is caught by name."""
    cfg, eng, batch, plen = served["rns-smollm-135m-resident"]
    from repro_torch.models import layers
    norm = T.rms_norm

    def leaky(x, *a, **k):
        out = norm(x, *a, **k)
        return out + 0 * torch.remainder(out, 7.0)

    monkeypatch.setattr(T, "rms_norm", leaky)
    assert layers is not None
    with pytest.raises(AnalysisError, match="modular-reduction"):
        tan.assert_clean(_decode(cfg, eng, batch, plen), cfg,
                         subject="leaky-resident")


def test_host_sync_in_a_step_is_flagged():
    def chatty(x):
        scale = x.abs().max().item()           # a host read
        idx = torch.nonzero(x > 0)             # a data-dependent shape
        return x / scale + idx.numel()

    summ = residency.summarize_fn(chatty, torch.arange(-3.0, 5.0))
    rep = residency.check_no_callbacks(summ, subject="chatty")
    assert not rep.ok
    msg = _messages(rep)
    assert "host sync" in msg and "aten._local_scalar_dense" in msg
    assert "aten.nonzero" in msg
    with pytest.raises(AnalysisError, match="_local_scalar_dense"):
        tan.assert_clean(chatty, None, torch.arange(-3.0, 5.0),
                         require_no_sync=True)
    # off by default, as the reference's require_scan
    assert tan.assert_clean(chatty, None, torch.arange(-3.0, 5.0)).ok


def test_kernel_count_mismatch_is_flagged():
    summ = residency.summarize_fn(lambda x: x * 2, torch.zeros(4))
    rep = residency.check_kernel_count(summ, 1, subject="no-kernel")
    assert not rep.ok and "expected exactly 1" in _messages(rep)
    rep = residency.check_kernel_count(summ, {"rns_forward": 2})
    assert not rep.ok and "rns_forward" in _messages(rep)


def test_regions_count_outermost_only_and_nest():
    """A wrapper reached inside another region is not a second call, and
    an observer hears only the outermost region of each call."""
    from repro_torch.kernels import _build

    calls = []

    @_build.kernel_region("outer")
    def outer(x):
        return inner(x) + 1

    @_build.kernel_region("inner")
    def inner(x):
        calls.append(_build.region_depth())
        return x * 2

    x = torch.ones(3)
    with residency.TraceMode() as mode:
        outer(x)
        inner(x)
    assert dict(mode.summary.kernel_calls) == {"outer": 1, "inner": 1}
    assert calls == [2, 1] and _build.region_depth() == 0
    assert mode.summary.inside == {"aten.mul": 2, "aten.add": 1}
    assert mode.summary.outside == {}


def test_expected_launches_by_config():
    from repro_torch.configs.base import get_config
    want = {"rns-smollm-135m-fused": {"rns_fused_matmul": 210},
            "rns-smollm-135m-resident": {"rns_fused_matmul": 150,
                                         "rns_forward": 60},
            "rns-smollm-135m-pallas": {"rns_forward": 210,
                                       "rns_matmul": 210,
                                       "rns_reverse": 210},
            "smollm-135m": {}}
    for arch, calls in want.items():
        cfg = get_config(arch)
        assert residency.kernel_calls(residency.expected_step(cfg)) == calls
        assert residency.kernel_calls(
            residency.expected_prefill(cfg)) == calls
    fused = get_config("rns-smollm-135m-fused")
    assert residency.expected_launches(fused, 32)["rns_forward"] == 7
    assert residency.kernel_calls(residency.expected_train_step(fused)) == \
        {"rns_fused_matmul": 420}


def test_counts_do_not_depend_on_grad_mode():
    """Inference mode hands a dispatch mode composite ops (`matmul`,
    `einsum`) whole; the trace runs their decompositions, so the ops and
    flops it counts are the same as under no_grad."""
    x, w = torch.randn(4, 8), torch.randn(8, 3)

    def f(a, b):
        return torch.matmul(a, b), torch.einsum("ab,bc->ac", a, b)

    got = []
    for ctx in (torch.no_grad, torch.inference_mode, torch.enable_grad):
        with ctx(), residency.TraceMode(flops=True) as mode:
            f(x, w)
        got.append((dict(mode.summary.outside), dict(mode.summary.flops)))
    assert got[0] == got[1] == got[2]
    assert got[0][1] == {"aten.mm": 192, "aten.bmm": 192}
