"""The port's circuit models and baseline multipliers
(`repro_torch.core.{analytical,baselines}`) against the reference's: the
delay/cost table of the paper's Fig. 4 (n = 3..16, the 5-, 8- and 11-bit
claims among them) and the Hiasat, Matutino and binary multiply-then-reduce
models with their reduction traces."""
import dataclasses

import numpy as np
import pytest

from repro.core import analytical as ran
from repro.core import baselines as rbl
from repro.core import twit as rtw
from repro_torch.core import analytical as tan
from repro_torch.core import baselines as tbl
from repro_torch.core import twit as ttw


def _rows(table):
    return {n: {k: (v.delay, v.cost) for k, v in row.items()}
            for n, row in table.items()}


@pytest.mark.parametrize("delta_fn", [None, lambda n: 1,
                                      lambda n: 2 ** (n - 1) - 1],
                         ids=["delta3", "delta1", "delta_max"])
def test_analytical_table_equals_reference(delta_fn):
    kw = {} if delta_fn is None else {"delta_fn": delta_fn}
    assert _rows(tan.analytical_table(**kw)) == \
        _rows(ran.analytical_table(**kw))


@pytest.mark.parametrize("n", [5, 8, 11])
@pytest.mark.parametrize("sign", [+1, -1])
def test_design_models_equal_reference(n, sign):
    """Each design's delay and cost at the paper's channel widths, for
    every admissible δ."""
    for d in range(0, 2 ** (n - 1)):
        for name in ("hiasat_model", "matutino_model"):
            got = getattr(tan, name)(n, d, sign)
            want = getattr(ran, name)(n, d, sign)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.delay, got.cost) == (want.delay, want.cost)
    got, want = tan.proposed_model(n, sign), ran.proposed_model(n, sign)
    assert (got.delay, got.cost) == (want.delay, want.cost)


def test_primitives_equal_reference():
    for k in range(1, 40):
        for name in ("cpa_delay", "cpa_cost", "cl_delay", "cl_cost",
                     "csa_levels"):
            assert getattr(tan, name)(k) == getattr(ran, name)(k)
        got, want = tan.mulbin(k), ran.mulbin(k)
        assert (got.delay, got.cost) == (want.delay, want.cost)
        got, want = tan.constmul(k, k // 2), ran.constmul(k, k // 2)
        assert (got.delay, got.cost) == (want.delay, want.cost)
    assert (tan.XOR_DELAY, tan.CSA_DELAY, tan.CSA_COST_PER_BIT) == \
        (ran.XOR_DELAY, ran.CSA_DELAY, ran.CSA_COST_PER_BIT)


@pytest.mark.parametrize("n", [5, 8, 11])
@pytest.mark.parametrize("sign", [+1, -1])
def test_baselines_equal_reference(n, sign):
    """Results and reduction traces of both baselines on seeded pairs of
    every δ that each admits."""
    rng = np.random.default_rng(n * 10 + (sign > 0))
    for d in range(0, 2 ** (n - 1), max(1, 2 ** (n - 1) // 24)):
        rm = rtw.Modulus(n=n, delta=d, sign=sign)
        tm = ttw.Modulus(n=n, delta=d, sign=sign)
        assert tbl.hiasat_effective_width(tm) == \
            rbl.hiasat_effective_width(rm)
        assert tbl.matutino_applicable(tm) == rbl.matutino_applicable(rm)
        for a, b in rng.integers(0, rm.m, (16, 2)):
            a, b = int(a), int(b)
            for name in ("mulmod_hiasat", "mulmod_matutino"):
                if name == "mulmod_matutino" and \
                        not rbl.matutino_applicable(rm):
                    with pytest.raises(ValueError):
                        tbl.mulmod_matutino(a, b, tm)
                    continue
                rt, tt = rbl.ReduceTrace(), tbl.ReduceTrace()
                got = getattr(tbl, name)(a, b, tm, tt)
                assert got == getattr(rbl, name)(a, b, rm, rt) == \
                    (a * b) % rm.m
                assert dataclasses.astuple(tt) == dataclasses.astuple(rt)
            assert tbl.mulmod_binary(a, b, rm.m) == \
                rbl.mulmod_binary(a, b, rm.m)
