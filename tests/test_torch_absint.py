"""The interval pass over traced calls (`repro_torch.analysis.absint`)
against the reference's jaxpr pass (`repro.analysis.absint`): the
reference test's ``resid`` pipeline proven with nothing unproven; the int8
narrowing flagged by dtype; kernel regions not entered, with one warning;
output intervals equal to the reference's `check_fn_bounds` on the same
functions wherever the reference proves them (its floored mod is a
``rem`` with select fix-ups, so there the port's interval lies inside);
the port's own integer paths (the plain forward conversion, the fold
ladder) checked the same way; writes through views widen their base."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis as ran
from repro_torch.analysis import Interval, check_fn_bounds
from repro_torch.analysis.absint import interpret
from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.rns_linear import rns_dense
from repro_torch.kernels import ref, rns_forward


def _messages(report):
    return " | ".join(str(f) for f in report.findings)


def _resid(x, w):
    mods = torch.tensor([251, 509], dtype=torch.int32)[:, None, None]
    acc = torch.einsum("mk,kn->mn", x.to(torch.int32), w.to(torch.int32))
    return torch.remainder(acc[None], mods)


def _ref_resid(x, w):
    mods = jnp.array([251, 509], jnp.int32)[:, None, None]
    acc = jnp.einsum("mk,kn->mn", x.astype(jnp.int32), w.astype(jnp.int32))
    return jnp.mod(acc[None], mods)


def test_proves_mod_pipeline_and_flags_narrowing():
    res = check_fn_bounds(_resid, torch.zeros((4, 64), dtype=torch.int8),
                          torch.zeros((64, 8), dtype=torch.int8))
    assert res.report.ok, _messages(res.report)
    assert res.unproven == 0
    (out,) = res.out_intervals
    assert not out.is_top and out.max_abs < 2 * 509
    assert out == Interval(0, 508)           # floored: [0, max m − 1]
    rref = ran.check_fn_bounds(_ref_resid, jnp.zeros((4, 64), jnp.int8),
                               jnp.zeros((64, 8), jnp.int8))
    (rout,) = rref.out_intervals
    if not rout.is_top:
        assert rout.lo <= out.lo and out.hi <= rout.hi

    def bad(x):
        return (x.to(torch.int32) * 300).to(torch.int8)

    res2 = check_fn_bounds(bad, torch.zeros((4,), dtype=torch.int8))
    assert not res2.report.ok
    assert "int8 overflow" in _messages(res2.report)
    assert "'_to_copy'" in _messages(res2.report)


def test_accumulator_overflow_named_by_dtype():
    """A K-deep int32 dot escapes int32 once its operands grow; the same
    dot of int8 operands is proven, its interval the exact corner."""
    x = torch.zeros((2, 4096), dtype=torch.int8)
    w = torch.zeros((4096, 2), dtype=torch.int8)
    res = check_fn_bounds(
        lambda a, b: a.to(torch.int32) @ (b.to(torch.int32) * 40000), x, w)
    assert "int32 overflow" in _messages(res.report)
    assert "'mm'" in _messages(res.report)
    ok = check_fn_bounds(lambda a, b: a.to(torch.int32) @ b.to(torch.int32),
                         x, w)
    assert ok.report.ok and ok.out_intervals == [
        Interval(-128 * 127 * 4096, 128 * 128 * 4096)]


def test_kernel_regions_are_not_entered_with_one_warning():
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((6, 96)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((96, 10)).astype(np.float32))

    def two_linears(a, b):
        return rns_dense(rns_dense(a, b, "pallas_fused") @ b.T, b, "pallas")

    res = check_fn_bounds(two_linears, x, w)
    warns = [f for f in res.report.findings if f.where == "kernel region"]
    assert len(warns) == 1 and warns[0].severity == "warning"
    assert res.report.ok
    # the staged path's int32 residues come out of regions: unknown
    staged = check_fn_bounds(
        lambda q: rns_forward(q, (251, 509)),
        torch.zeros((4, 8), dtype=torch.int8))
    assert staged.unproven == 1 and staged.out_intervals[0].is_top
    # the same conversion's plain version, traced op by op, is proven
    plain = check_fn_bounds(lambda q: ref.rns_forward_ref(q, (251, 509)),
                            torch.zeros((4, 8), dtype=torch.int8))
    assert plain.unproven == 0 and plain.out_intervals == [Interval(0, 508)]


# functions the reference proves, written once per package
def _ring(x, w, np_):
    return (np_["i32"](x) @ np_["i32"](w)) * 3 - 7


def _shift_mask(x, w, np_):
    v = np_["i32"](x) + 128
    return (v >> 3) + (v & 15) + (v << 2)


def _reduce_cat(x, w, np_):
    v = np_["i32"](x)
    return np_["cat"]([np_["sum"](v, 1), np_["max"](v, 1) - 1000])


TORCH = {"i32": lambda t: t.to(torch.int32),
         "clip": lambda t, lo, hi: torch.clamp(t, lo, hi),
         "cat": lambda ts: torch.cat(ts), "sum": lambda t, d: t.sum(d),
         "max": lambda t, d: t.amax(d), "where": torch.where}
JNP = {"i32": lambda t: t.astype(jnp.int32),
       "clip": lambda t, lo, hi: jnp.clip(t, lo, hi),
       "cat": lambda ts: jnp.concatenate(ts), "sum": lambda t, d: t.sum(d),
       "max": lambda t, d: t.max(d), "where": jnp.where}


@pytest.mark.parametrize("fn", [_ring, _shift_mask, _reduce_cat],
                         ids=lambda f: f.__name__)
def test_intervals_equal_reference(fn):
    x, w = np.zeros((3, 16), np.int8), np.zeros((16, 5), np.int8)
    got = check_fn_bounds(lambda a, b: fn(a, b, TORCH),
                          torch.from_numpy(x), torch.from_numpy(w))
    want = ran.check_fn_bounds(lambda a, b: fn(a, b, JNP),
                               jnp.asarray(x), jnp.asarray(w))
    assert got.report.ok and got.unproven == 0, _messages(got.report)
    proven = [iv for iv in want.out_intervals if not iv.is_top]
    assert proven, "the reference proves nothing here"
    assert [(iv.lo, iv.hi) for iv in got.out_intervals] == \
        [(iv.lo, iv.hi) for iv in want.out_intervals]


def test_clamp_and_select():
    """Where the reference (under the installed JAX) proves nothing: a
    clamp to constant bounds and a select are the exact hulls."""
    x = torch.zeros((3, 16), dtype=torch.int8)
    got = check_fn_bounds(
        lambda a: (torch.clamp(a.to(torch.int32) * 5, -100, 100),
                   torch.where(a > 0, a.to(torch.int32) * 2,
                               -a.to(torch.int32)),
                   torch.clamp(a.to(torch.float32) / 3.0, -127, 127)
                   .round().to(torch.int8)), x)
    assert got.report.ok and got.unproven == 0, _messages(got.report)
    assert got.out_intervals == [Interval(-100, 100), Interval(-256, 254),
                                 Interval(-127, 127)]


def test_fold_ladder_of_a_real_plan():
    """The plain fold ladder of smollm's (47, 43, 41, 39, 37) plan at K =
    576 (5 rungs, conditional subtracts) on [0, bound): each rung's
    interval is `Interval.rung`, each subtract the union of its branches,
    which holds the canonical range."""
    mods, bound = (47, 43, 41, 39, 37), 576 * 46 * 46
    plan = ChannelPlan.build(mods, bound)
    for c, m in enumerate(mods):
        got = check_fn_bounds(lambda v: plan.apply_ladder(v, c),
                              torch.zeros(8, dtype=torch.int32),
                              bounds=[(0, bound - 1)])
        want = Interval(0, bound - 1)
        for s, cc in plan.rungs[c]:
            want = want.rung(int(s), int(cc))
        for _ in range(plan.n_sub):
            want = (want - Interval.point(m)).union(want)
        assert got.report.ok and got.unproven == 0
        assert got.out_intervals == [want]
        assert want.lo <= 0 and m - 1 <= want.hi


def test_constants_are_read_from_values_and_writes_widen_views():
    def f(x):
        table = torch.tensor([3, 1000], dtype=torch.int32)   # a constant
        buf = torch.zeros(4, dtype=torch.int32)
        buf[1:3] = x.to(torch.int32) * table[1]             # a view write
        return buf, table
    res = interpret(f, torch.zeros(2, dtype=torch.int8),
                    in_intervals=[Interval(-2, 5)])
    assert res.report.ok and res.unproven == 0
    assert res.out_intervals == [Interval(-2000, 5000), Interval(3, 1000)]
    with pytest.raises(ValueError, match="intervals"):
        interpret(f, torch.zeros(2, dtype=torch.int8), in_intervals=[])


def test_unknown_op_is_unproven_and_warned_once():
    res = check_fn_bounds(
        lambda x: torch.bitwise_not(x.to(torch.int32)) + torch.bitwise_not(
            x.to(torch.int32)), torch.zeros(4, dtype=torch.int8))
    warns = [f for f in res.report.findings if "no interval rule" in
             f.message]
    assert len(warns) == 1 and "bitwise_not" in warns[0].message
    assert res.unproven == 3 and res.out_intervals[0].is_top
