"""The port's twit arithmetic (`repro_torch.core.{twit,modadd,modmul}`)
against the reference's (`repro.core`): the codec, the twit adder and the
generic multiplier (Algorithm 1).  The scalar models' stage traces are
equal; the tensor forms equal the reference's numpy forms exhaustively at
n = 5 (both signs, every δ) and on seeded pairs at n = 8 and 11."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import modadd as rad
from repro.core import modmul as rmm
from repro.core import twit as rtw
from repro_torch.core import modadd as tad
from repro_torch.core import modmul as tmm
from repro_torch.core import twit as ttw

N5 = [(d, s) for s in (+1, -1) for d in rtw.admissible_deltas(5)]
# seeded samples of the wider widths: the extreme offsets and a spread
WIDE = [(n, d, s) for n in (8, 11) for s in (+1, -1)
        for d in (0, 1, 3, 2 ** (n - 2) + 1, 2 ** (n - 1) - 1)]


def _mods(n, delta, sign):
    return (rtw.Modulus(n=n, delta=delta, sign=sign),
            ttw.Modulus(n=n, delta=delta, sign=sign))


def _pairs(m, count=None, seed=0):
    """Every (a, b) residue pair, or ``count`` seeded ones."""
    if count is None:
        a, b = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        return a.ravel().astype(np.int64), b.ravel().astype(np.int64)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, m, count, dtype=np.int64),
            rng.integers(0, m, count, dtype=np.int64))


# ---------------------------------------------------------------- codec ----
@pytest.mark.parametrize("delta,sign", N5)
def test_codec_exhaustive_n5(delta, sign):
    rm, tm = _mods(5, delta, sign)
    assert (tm.m, tm.twit_value, tm.fold_value, tm.mask, tm.is_pow2,
            str(tm)) == (rm.m, rm.twit_value, rm.fold_value, rm.mask,
                         rm.is_pow2, str(rm))
    vals = np.arange(-2 * rm.m, 3 * rm.m, dtype=np.int64)
    rb, rt = rtw.encode(vals, rm)
    tb, tt = ttw.encode(torch.from_numpy(vals), tm)
    assert np.array_equal(tb.numpy(), rb) and np.array_equal(tt.numpy(), rt)
    assert np.array_equal(ttw.decode(tb, tt, tm).numpy(),
                          rtw.decode(rb, rt, rm))
    for v in range(-3, rm.m + 3):
        assert ttw.encode(v, tm) == rtw.encode(v, rm)
        assert ttw.encode_all_forms(v, tm) == rtw.encode_all_forms(v, rm)
    # every codeword, scalar and tensor decode
    words = [(w.bin, w.twit) for w in rtw.all_codewords(rm)]
    assert words == [(w.bin, w.twit) for w in ttw.all_codewords(tm)]
    b = torch.tensor([w[0] for w in words])
    t = torch.tensor([w[1] for w in words])
    assert ttw.decode(b, t, tm).tolist() == [rtw.decode(*w, rm)
                                             for w in words]
    assert all(ttw.decode(*w, tm) == rtw.decode(*w, rm) for w in words)


def test_codec_negative_twit_uses_floored_mod():
    """2^n − δ: a set twit subtracts δ, so bin < δ decodes through a
    negative sum; the floored mod keeps it in [0, m)."""
    rm, tm = _mods(5, 15, -1)
    b = torch.arange(0, 32)
    t = torch.ones_like(b)
    got = ttw.decode(b, t, tm)
    assert got.min().item() >= 0
    assert got.tolist() == rtw.decode(b.numpy(), t.numpy(), rm).tolist()


def test_codec_surface_and_operand():
    assert list(ttw.admissible_deltas(8)) == list(rtw.admissible_deltas(8))
    for v in (0, 16, 36):
        mod = ttw.Modulus(n=5, delta=5, sign=+1)
        op = ttw.TwitOperand.from_value(v, mod)
        ref = rtw.TwitOperand.from_value(v, rtw.Modulus(5, 5, +1))
        assert (op.bin, op.twit, op.value) == (ref.bin, ref.twit, ref.value)
        assert [op.bit(i) for i in range(5)] == [ref.bit(i)
                                                for i in range(5)]
    with pytest.raises(ValueError):
        ttw.TwitOperand(bin=32, twit=0, mod=ttw.Modulus(5, 1, -1))
    with pytest.raises(ValueError):
        ttw.Modulus(n=5, delta=16, sign=1)


# ---------------------------------------------------------------- adder ----
@pytest.mark.parametrize("delta,sign", N5)
def test_addmod_exhaustive_n5(delta, sign):
    rm, tm = _mods(5, delta, sign)
    a, b = _pairs(rm.m)
    want = rad.addmod_twit_np(a, b, rm)
    got = tad.addmod_twit_tensor(torch.from_numpy(a), torch.from_numpy(b),
                                 tm)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, (a + b) % rm.m)
    # the scalar model and its trace on every codeword pair of one row
    for wa in rtw.all_codewords(rm)[::7]:
        for wb in rtw.all_codewords(rm):
            rt, tt = rad.AddTrace(), tad.AddTrace()
            r = rad.addmod_twit(wa, wb, rm, rt)
            t = tad.addmod_twit(ttw.TwitOperand(wa.bin, wa.twit, tm),
                                ttw.TwitOperand(wb.bin, wb.twit, tm), tm, tt)
            assert t == r and dataclasses.astuple(tt) == \
                dataclasses.astuple(rt)


@pytest.mark.parametrize("n,delta,sign", WIDE)
def test_addmod_seeded_wide(n, delta, sign):
    rm, tm = _mods(n, delta, sign)
    a, b = _pairs(rm.m, 4096, seed=n * 1000 + delta)
    want = rad.addmod_twit_np(a, b, rm)
    got = tad.addmod_twit_tensor(torch.from_numpy(a), torch.from_numpy(b),
                                 tm)
    assert np.array_equal(got.numpy(), want)
    for x, y in zip(a[:64], b[:64]):
        assert tad.addmod_twit(int(x), int(y), tm) == \
            rad.addmod_twit(int(x), int(y), rm)
        assert tad.submod_twit(int(x), int(y), tm) == \
            rad.submod_twit(int(x), int(y), rm)
        na, nr = tad.negate_twit(int(x), tm), rad.negate_twit(int(x), rm)
        assert (na.bin, na.twit) == (nr.bin, nr.twit)


# ----------------------------------------------------------- multiplier ----
@pytest.mark.parametrize("delta,sign", N5)
def test_mulmod_tensor_exhaustive_n5(delta, sign):
    rm, tm = _mods(5, delta, sign)
    a, b = _pairs(rm.m)
    want = rmm.mulmod_twit_np(a, b, rm)
    got = tmm.mulmod_twit_tensor(torch.from_numpy(a), torch.from_numpy(b),
                                 tm)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, (a * b) % rm.m)


@pytest.mark.parametrize("delta,sign", N5)
def test_mulmod_stage_traces_n5(delta, sign):
    """The scalar model's every stage equals the reference's on a spread
    of codeword pairs (all twit combinations)."""
    rm, tm = _mods(5, delta, sign)
    words = rtw.all_codewords(rm)
    for wa in words[::5]:
        for wb in words[::3]:
            rt, tt = rmm.StageTrace(), tmm.StageTrace()
            r = rmm.mulmod_twit(wa, wb, rm, rt)
            t = tmm.mulmod_twit(ttw.TwitOperand(wa.bin, wa.twit, tm),
                                ttw.TwitOperand(wb.bin, wb.twit, tm), tm, tt)
            assert t == r
            assert dataclasses.astuple(tt) == dataclasses.astuple(rt)


@pytest.mark.parametrize("n,delta,sign", WIDE)
def test_mulmod_seeded_wide(n, delta, sign):
    rm, tm = _mods(n, delta, sign)
    a, b = _pairs(rm.m, 4096, seed=n * 1000 + delta)
    want = rmm.mulmod_twit_np(a, b, rm)
    got = tmm.mulmod_twit_tensor(torch.from_numpy(a).to(torch.int32),
                                 torch.from_numpy(b).to(torch.int32), tm)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, (a * b) % rm.m)
    for x, y in zip(a[:32], b[:32]):
        rt, tt = rmm.StageTrace(), tmm.StageTrace()
        assert tmm.mulmod_twit(int(x), int(y), tm, tt) == \
            rmm.mulmod_twit(int(x), int(y), rm, rt)
        assert dataclasses.astuple(tt) == dataclasses.astuple(rt)


@pytest.mark.parametrize("n", [3, 5, 8, 11, 16])
def test_multiplier_structure(n):
    """Γ, the group weights and bits, λ and the LUT6 tables equal the
    reference's."""
    assert tmm.num_groups(n) == rmm.num_groups(n)
    assert tmm.reduction_levels(n) == rmm.reduction_levels(n)
    for g in range(tmm.num_groups(n)):
        assert tmm.group_weight(g) == rmm.group_weight(g)
        if g:
            assert tmm.group_bits(g, n) == rmm.group_bits(g, n)
    rm, tm = _mods(n, 2 ** (n - 1) - 1, -1)
    rt, tt = rmm.pp_tables(rm), tmm.pp_tables(tm)
    assert tt.count == rt.count
    for key, tab in rt.tables.items():
        assert list(tt.tables[key]) == tab.tolist()
    op = rtw.TwitOperand.from_value(rm.m - 1, rm)
    assert tmm.split_operand(ttw.TwitOperand(op.bin, op.twit, tm)) == \
        rmm.split_operand(op)
    for code in range(8):
        assert tmm.group_value(code, 0, tm) == rmm.group_value(code, 0, rm)


def test_tensor_models_keep_shape_and_device_tables():
    tm = ttw.Modulus(n=5, delta=5, sign=+1)
    a = torch.arange(37).reshape(37, 1).expand(37, 37)
    b = torch.arange(37).reshape(1, 37).expand(37, 37)
    got = tmm.mulmod_twit_tensor(a, b, tm)
    assert got.shape == (37, 37)
    assert torch.equal(got, (a * b) % 37)
    tab = tmm._stacked_tables(tm, got.device)
    assert tab.shape == (2, 2, 64) and tab.device == got.device
    assert tmm._stacked_tables(tm, got.device) is tab
    # the adder's constants too are built once per (modulus, device): a
    # CUDA graph captures both models, copying nothing from the host
    add = tad.addmod_twit_tensor(a, b, tm)
    assert torch.equal(add, (a + b) % 37)
    assert tad._constants_tensor(tm, add.device) is \
        tad._constants_tensor(tm, add.device)
