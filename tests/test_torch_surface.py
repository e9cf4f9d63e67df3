"""The rest of the port's core surface and the smollm configs against the
JAX reference on the CPU: the exported names of `repro_torch.core` and
`repro_torch.serve` and `repro_torch.kernels.ops` (the kernel entries,
`flash_attention` among them); `RNSBasis`'s conversions and oracles,
`paper_n5_basis`, `tau_basis` and `dequantize` on seeded inputs;
`reconstruct_mrc` bit-equal to the reference's on its jnp backend; the
fields of `smollm-135m`, `rns-smollm-135m` and `rns-smollm-135m-encoded`;
and their smoke models' logits within 0.03 of the reference's, on the
reference's own weights carried over by `weights.from_jax_params`.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_compare as cmp
from repro.configs.base import get_config as jax_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import quant as JQ
from repro.core import rns as JR
from repro.core import rns_linear as JL
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import quant as TQ
from repro_torch.core import rns as TR
from repro_torch.core import rns_linear as TL

NEW_CONFIGS = ["smollm-135m", "rns-smollm-135m", "rns-smollm-135m-encoded"]


@pytest.mark.parametrize("module", ["core", "serve", "kernels.ops"])
def test_exported_names_equal_reference(module):
    ref = importlib.import_module(f"repro.{module}")
    mine = importlib.import_module(f"repro_torch.{module}")
    assert sorted(mine.__all__) == sorted(ref.__all__)
    for name in mine.__all__:
        assert getattr(mine, name, None) is not None, name


def _bases():
    return [(TR.paper_n5_basis(), JR.paper_n5_basis())] + [
        (TR.tau_basis(n), JR.tau_basis(n)) for n in (5, 8, 22)] + [
        (TR.basis_for_chain(1536), JR.basis_for_chain(1536))]


def test_ops_flash_attention_entry():
    """The reference's last kernel entry: `ops.flash_attention` takes the
    window and softcap as any integer and real (numpy scalars too) and
    gives the wrapper's result."""
    from repro_torch.kernels import flash_attention, ops

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16))
                                .astype(np.float32)) for _ in range(3))
    got = ops.flash_attention(q, k, v, window=np.int64(4),
                              softcap=np.float32(20.0))
    assert torch.equal(got, flash_attention(q, k, v, window=4,
                                            softcap=20.0))


@pytest.mark.parametrize("i", range(5))
def test_basis_fields_and_channels_equal_reference(i):
    mine, ref = _bases()[i]
    assert (mine.name, mine.moduli, mine.channel_n, mine.M, mine.k) == \
        (ref.name, ref.moduli, ref.channel_n, ref.M, ref.k)
    assert mine.mrc_inverses == ref.mrc_inverses
    assert [None if c is None else (c.n, c.delta, c.sign, c.m)
            for c in mine.channels] == \
        [None if c is None else (c.n, c.delta, c.sign, c.m)
         for c in ref.channels]
    assert TR.PAPER_N5_DYNAMIC_RANGE == JR.PAPER_N5_DYNAMIC_RANGE \
        == TR.paper_n5_basis().M


@pytest.mark.parametrize("i", range(5))
def test_basis_oracles_equal_reference(i):
    """to_int, to_signed, mrc_digits and from_mrc on seeded residues, and
    the big-int forward of Python ints beyond 64 bits."""
    mine, ref = _bases()[i]
    rng = np.random.default_rng(i)
    for _ in range(50):
        res = [int(rng.integers(0, m)) for m in mine.moduli]
        assert mine.to_int(res) == ref.to_int(res)
        assert mine.to_signed(res) == ref.to_signed(res)
        assert mine.mrc_digits(res) == ref.mrc_digits(res)
        assert mine.from_mrc(mine.mrc_digits(res)) == mine.to_int(res)
    xs = [0, -1, 7, -(mine.M // 2), mine.M // 2 - 1, 3 * 2**70 + 5]
    assert np.array_equal(mine.forward(xs), ref.forward(xs))
    assert [mine.to_signed(r) for r in mine.forward(xs[:5]).T] == xs[:5]
    with pytest.raises(ValueError, match="residues"):
        mine.to_int([1])


@pytest.mark.parametrize("i", range(5))
def test_basis_forward_of_tensors_equals_reference(i):
    mine, ref = _bases()[i]
    x = np.random.default_rng(i).integers(-2**31, 2**31, (3, 17),
                                          dtype=np.int64).astype(np.int32)
    got = mine.forward(torch.from_numpy(x))
    want = np.asarray(ref.forward(jnp.asarray(x)))
    assert got.dtype == cmp.t(want).dtype
    assert np.array_equal(got.numpy(), want)


def test_dequantize_equals_reference():
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (5, 33)).astype(np.int8)
    s = (rng.random((5, 1)) + 0.01).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = JQ.dequantize(jnp.asarray(q), jnp.asarray(s), jd)
        got = TQ.dequantize(torch.from_numpy(q), torch.from_numpy(s), td)
        assert got.dtype == td
        assert torch.equal(got, cmp.t(want))


@pytest.mark.parametrize("k", [576, 1536])
@pytest.mark.parametrize("with_scale", [False, True])
def test_reconstruct_mrc_bit_equal_reference(k, with_scale):
    rng = np.random.default_rng(k)
    for mine, ref in ((TR.basis_for_int8_matmul(k),
                       JR.basis_for_int8_matmul(k)),
                      (TR.basis_for_chain(k), JR.basis_for_chain(k))):
        res = np.stack([rng.integers(0, m, (4, 9)) for m in mine.moduli]
                       ).astype(np.int32)
        scale = (rng.random((4, 1)).astype(np.float32)
                 if with_scale else None)
        want = JL.reconstruct_mrc(
            jnp.asarray(res), ref, backend="jnp",
            scale=None if scale is None else jnp.asarray(scale))
        got = TL.reconstruct_mrc(
            torch.from_numpy(res), mine,
            scale=None if scale is None else torch.from_numpy(scale))
        assert torch.equal(got, cmp.t(want))


@pytest.mark.parametrize("name", NEW_CONFIGS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_equal_reference(name, smoke):
    mine = (get_smoke_config if smoke else get_config)(name)
    ref = (jax_smoke_config if smoke else jax_config)(name)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.linear_spec.is_rns == ref.linear_spec.is_rns
    assert mine.linear_spec.encode_weights == ref.linear_spec.encode_weights


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_smoke_logits_match_reference(name):
    jeng, teng = cmp.engines(jax_smoke_config(name), get_smoke_config(name))
    worst = cmp.max_logit_diff(jeng, teng)
    print(f"{name}: largest logit difference {worst:.4f} "
          f"(tolerance {cmp.LOGIT_ATOL})")
    assert worst <= cmp.LOGIT_ATOL
