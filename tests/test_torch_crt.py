"""The port's channel-slice CRT launch and its finish against the JAX
reference, on the CPU.

`rns_fused_crt_partial` on CPU tensors runs its plain version, which must
be bit-equal, slice by slice, to the JAX entry (Pallas in interpret mode)
in the quantize, residue-in and gated forms; the slices' summed planes
through `crt_finish`, times ``s_row`` then ``s_col``
(`dist.rns_shard.channel_sliced_matmul`), must be bit-equal to
both packages' `rns_fused_matmul` on the full basis (the contract of
`tests/test_dist.py`).  Seeds are fixed per case; every comparison is exact.
The CUDA kernel is held against the plain version by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import rns_tensor as jrt
from repro.core.channel_plan import ChannelPlan as JPlan
from repro.core.conversion_plan import ConversionPlan as JConv
from repro.core.rns import RNSBasis as JBasis
from repro.dist import rns_shard as jshard
from repro.kernels.rns_fused import rns_fused_crt_partial as j_crt
from repro.kernels.rns_fused import rns_fused_matmul as j_fused
from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.core.rns_tensor import RNSTensor
from repro_torch.dist.rns_shard import (channel_partials,
                                       channel_sliced_matmul, crt_finish,
                                       crt_tables, local_plan)
from repro_torch.kernels import rns_fused_crt_partial, rns_fused_matmul

M, N = 8, 24
# (basis, K, slice counts): smoke bases C = 4 and 5, the chain basis C = 6
BASES = {"int8-64": (basis_for_int8_matmul(64), 64, (2, 4)),
         "int8-128": (basis_for_int8_matmul(128), 128, (1, 5)),
         "chain-128": (basis_for_chain(128), 128, (2, 3))}
CASES = [(name, n, form) for name, (_, _, ns) in BASES.items() for n in ns
         for form in ("quantize", "residue_in", "gated")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jbasis(basis):
    return JBasis(name=basis.name, moduli=basis.moduli)


def _operands(basis, K, form, seed):
    """The reference's encoded operands (and gate) with their torch twins."""
    rng = np.random.default_rng(seed)
    jb = _jbasis(basis)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.float32)
    x = x.at[0, :2].set(jnp.asarray([40.0, -40.0]))
    wt = jrt.encode(jnp.asarray(rng.standard_normal((K, N)) / np.sqrt(K),
                                jnp.float32), jb)
    gate = None
    if form == "quantize":
        xj, srow = x, jquant.quant_scale(x)
    else:
        xj = jrt.encode_activation(x, jb)
        srow = xj.scale
        if form == "gated":
            gate = rng.integers(-128, 128, (M, K)).astype(np.int8)
            srow = srow * 0.5
    return xj, wt, np.asarray(srow, np.float32), gate


@pytest.mark.parametrize("name,n,form", CASES)
def test_crt_slices_match_reference_and_compose(name, n, form):
    basis, K, _ = BASES[name]
    xj, wt, srow, gate = _operands(basis, K, form,
                                   sum(map(ord, name + form)))
    mods = basis.moduli
    C = len(mods)
    signed = form == "quantize"
    plan_g = ChannelPlan.for_matmul(mods, K, signed=signed)
    jlp = jshard.local_plan(JPlan.for_matmul(mods, K, signed=signed), n)
    jconv_l = JConv.build(jlp.moduli)
    v, mc, _ = crt_tables(basis)
    w_res = np.asarray(wt.residues)
    x_arr = np.asarray(xj if form == "quantize" else xj.residues)
    tw = RNSTensor(_t(w_res), _t(wt.scale), basis)
    xp = _t(x_arr) if signed else RNSTensor(_t(x_arr), _t(srow), basis)
    tgate = None if gate is None else _t(gate)
    parts = channel_partials(xp, tw, n, scale_row=_t(srow) if signed
                             else None, gate=tgate)
    assert len(parts) == n
    Cl = C // n
    for i, got in enumerate(parts):
        sl = slice(i * Cl, (i + 1) * Cl)
        xs = x_arr if form == "quantize" else x_arr[sl]
        want = j_crt(jnp.asarray(xs), jnp.asarray(w_res[sl]), plan=jlp,
                     conv=jconv_l, mods=plan_g.mods[sl],
                     sched=plan_g.sched[sl], crt_v=v[sl], crt_mc=mc[sl],
                     quantize=signed,
                     scale_row=jnp.asarray(srow) if signed else None,
                     gate=None if gate is None else jnp.asarray(gate))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), i
    composed = channel_sliced_matmul(xp, tw, n, scale_row=_t(srow),
                                     scale_col=tw.scale, gate=tgate)
    if form == "quantize":
        port = rns_fused_matmul(xp, tw, scale_row=_t(srow),
                                scale_col=tw.scale)
        ref = j_fused(xj, wt, quantize=True, scale_row=jnp.asarray(srow),
                      scale_col=wt.scale)
    else:
        port = rns_fused_matmul(xp, tw, scale_row=_t(srow),
                                scale_col=tw.scale, gate=tgate)
        ref = j_fused(xj, wt, scale_row=jnp.asarray(srow).reshape(M, 1),
                      scale_col=wt.scale,
                      gate=None if gate is None else jnp.asarray(gate))
    assert composed.numpy().tobytes() == port.numpy().tobytes()
    assert composed.numpy().tobytes() == np.asarray(ref).tobytes()


@pytest.mark.parametrize("basis", [basis_for_int8_matmul(64),
                                   basis_for_int8_matmul(576),
                                   basis_for_chain(128),
                                   basis_for_chain(1536)],
                         ids=lambda b: str(len(b.moduli)))
def test_crt_tables_match(basis):
    v, mc, L1 = crt_tables(basis)
    jv, jmc, jL1 = jshard.crt_tables(_jbasis(basis))
    assert L1 == jL1 and v.dtype == mc.dtype == np.int32
    assert np.array_equal(v, jv) and np.array_equal(mc, jmc)


@pytest.mark.parametrize("n", [1, 2, 3, 6])
@pytest.mark.parametrize("signed", [False, True])
def test_local_plan_matches(n, signed):
    mods = basis_for_chain(128).moduli
    got = local_plan(ChannelPlan.for_matmul(mods, 128, signed=signed), n)
    want = jshard.local_plan(JPlan.for_matmul(mods, 128, signed=signed), n)
    assert (got.moduli, got.rungs, got.n_sub, got.bound, got.signed) == \
        (want.moduli, want.rungs, want.n_sub, want.bound, want.signed)


def test_local_plan_rejects():
    mods = basis_for_int8_matmul(576).moduli           # C = 5
    for build, shard in ((ChannelPlan, local_plan),
                         (JPlan, jshard.local_plan)):
        with pytest.raises(ValueError, match="does not divide"):
            shard(build.for_matmul(mods, 576), 2)
        with pytest.raises(ValueError, match="residue dtype"):
            shard(build.build((47, 43, 257, 251), 2**20), 2)


def test_crt_finish_matches_reference():
    """The planes of C one-channel slices, summed unreduced, including the
    largest sum (every α_j at m_j − 1) and zero."""
    basis = basis_for_chain(1536)
    C = len(basis.moduli)
    _, _, L1 = crt_tables(basis)
    rng = np.random.default_rng(3)
    alpha = np.stack([rng.integers(0, m, (6, 7)) for m in basis.moduli])
    alpha[:, 0, 0] = [m - 1 for m in basis.moduli]    # every α_j at m_j − 1
    alpha[:, 0, 1] = 0
    total = np.zeros((L1, 6, 7), np.int64)
    for j in range(C):                 # per-slice planes, summed unreduced
        val = alpha[j].astype(object) * (basis.M // basis.moduli[j])
        for l in range(L1):
            total[l] += np.vectorize(lambda a, l=l: (a >> (15 * l)) & 32767
                                     )(val).astype(np.int64)
    total = total.astype(np.int32)
    got = crt_finish(_t(total), ConversionPlan.for_basis(basis), C)
    want = jshard._crt_finish(jnp.asarray(total),
                              JConv.for_basis(_jbasis(basis)), C)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_crt_partial_rejects():
    """The checks of the slice launch; its raw int8 x and live (K, N)
    weight forms, once refused, are held bit for bit against the JAX
    entry."""
    basis = basis_for_int8_matmul(64)
    plan = local_plan(ChannelPlan.for_matmul(basis.moduli, 64, signed=True),
                      2)
    v, mc, _ = crt_tables(basis)
    tables = dict(plan=plan, mods=plan.mods, sched=plan.sched,
                  crt_v=v[:2], crt_mc=mc[:2])
    w = torch.zeros(2, 64, 8, dtype=torch.int8)
    x = torch.zeros(4, 64)
    rng = np.random.default_rng(11)
    xi = rng.integers(-128, 128, (4, 64)).astype(np.int8)
    wi = rng.integers(-128, 128, (64, 8)).astype(np.int8)
    xf = rng.standard_normal((4, 64)).astype(np.float32)
    srow = np.full((4, 1), 0.02, np.float32)
    jplan = jshard.local_plan(JPlan.for_matmul(basis.moduli, 64,
                                               signed=True), 2)
    jtables = dict(plan=jplan, conv=JConv.build(jplan.moduli),
                   mods=plan.mods, sched=plan.sched, crt_v=v[:2],
                   crt_mc=mc[:2])
    w_res = np.stack([np.mod(wi.astype(np.int64), m)
                      for m in basis.moduli[:2]]).astype(np.int8)
    for xa, ws, kw in ((xi, w_res, {}), (xi, wi, {}),
                       (xf, wi, dict(quantize=True, scale_row=srow))):
        got = rns_fused_crt_partial(
            _t(xa), _t(ws), **{**tables, **kw,
                               **({"scale_row": _t(srow)} if kw else {})})
        want = j_crt(jnp.asarray(xa), jnp.asarray(ws), **jtables, **{
            k: jnp.asarray(a) if k == "scale_row" else a
            for k, a in kw.items()})
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="scale_row"):
        rns_fused_crt_partial(x, w, quantize=True, **tables)
    with pytest.raises(ValueError, match="channels"):
        rns_fused_crt_partial(x, w[:1], quantize=True,
                              scale_row=torch.ones(4, 1), **tables)
    with pytest.raises(ValueError, match="already quantized"):
        rns_fused_crt_partial(torch.zeros(2, 4, 64, dtype=torch.int8), w,
                              quantize=True, **tables)
