"""The port's Mamba2 mixer (`models/ssm.py` and the transformer's
`_ssm_prefill`) against the reference's, on the CPU, on the reference's
own `make_ssm_params` weights: the chunked SSD forward, the prefill's
decode cache (state and conv tail) and the one-token recurrence, on the
smoke mamba2 (chunk 8) and hymba (chunk 8, 4 states) configs, with and
without a left-pad mask; and the chunked dual form against the
step-by-step recurrence (the reference's `tests/test_models.py` oracle).

Tolerances.  In float32 both sides compute the same float32 ops in another
order (a Python loop over chunks against `lax.scan`; torch's einsums
against XLA's): outputs agree to 1e-6 of values up to 3.8, SSM states to
1.4e-8 of values up to 0.02.  ATOL = RTOL = 1e-5 is ten times the largest
output difference measured.  The chunked-against-sequential oracle keeps
the reference's own bound (atol 2e-4, rtol 2e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

ATOL, RTOL = 1e-5, 1e-5
NAMES = ["mamba2-1.3b", "hymba-1.5b"]
B, S = 2, 24


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference cfg, port cfg, reference params, port params, x, valid)
    in float32; valid masks 5 left-pad slots of row 1."""
    jcfg = dataclasses.replace(jax_smoke_config(name), param_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(name), param_dtype="float32")
    jp = JS.make_ssm_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32) * 0.5
    valid = np.ones((B, S), bool)
    valid[1, :5] = False
    return jcfg, tcfg, jp, tp, x, valid


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("masked", [False, True])
def test_ssm_apply_matches_reference(name, masked):
    jcfg, tcfg, jp, tp, x, valid = _setup(name)
    jv, tv = ((jnp.asarray(valid), torch.from_numpy(valid)) if masked
              else (None, None))
    want = JS.ssm_apply(jp, jnp.asarray(x), jcfg, valid=jv)
    got = TS.ssm_apply(tp, torch.from_numpy(x), tcfg, valid=tv)
    if masked:                      # pad rows are not meaningful outputs
        want, got = np.asarray(want)[valid], got[torch.from_numpy(valid)]
    _close(got, want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("masked", [False, True])
def test_ssm_prefill_matches_reference(name, masked):
    """`_ssm_prefill`: the output, the state after the last token and the
    conv's raw input tail (zeros where masked)."""
    jcfg, tcfg, jp, tp, x, valid = _setup(name)
    jv, tv = ((jnp.asarray(valid), torch.from_numpy(valid)) if masked
              else (None, None))
    wy, wc = JT._ssm_prefill(jp, jnp.asarray(x), jcfg, valid=jv)
    gy, gc = TT._ssm_prefill(tp, torch.from_numpy(x), tcfg, valid=tv)
    if masked:
        wy, gy = np.asarray(wy)[valid], gy[torch.from_numpy(valid)]
    _close(gy, wy)
    _close(gc["state"], wc["state"])
    _close(gc["conv"], wc["conv"])


@pytest.mark.parametrize("name", NAMES)
def test_ssm_decode_steps_match_reference(name):
    """Eight recurrence steps from a prefill's cache: outputs equal, and the
    port's cache (updated in place) equals the reference's returned one."""
    jcfg, tcfg, jp, tp, x, _ = _setup(name)
    _, jc = JT._ssm_prefill(jp, jnp.asarray(x[:, :16]), jcfg)
    _, tc = TT._ssm_prefill(tp, torch.from_numpy(x[:, :16]), tcfg)
    for t in range(16, S):
        wy, jc = JS.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        gy, tc2 = TS.ssm_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                     tcfg)
        assert tc2 is tc
        _close(gy, wy)
        _close(tc["state"], jc["state"])
        _close(tc["conv"], jc["conv"])


def test_pad_never_reaches_the_state():
    """A left-padded row's prefill cache equals the same tokens' unpadded
    prefill cache: the masked inputs and gates make pad steps identity
    steps of the recurrence."""
    _, tcfg, _, tp, x, valid = _setup("mamba2-1.3b")
    xs = torch.from_numpy(x)
    _, padded = TT._ssm_prefill(tp, xs, tcfg, valid=torch.from_numpy(valid))
    # the 19 real tokens alone, as one chunk
    _, alone = TT._ssm_prefill(tp, xs[1:, 5:],
                               dataclasses.replace(tcfg, ssm_chunk=S - 5))
    np.testing.assert_allclose(padded["state"][1].numpy(),
                               alone["state"][0].numpy(), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(padded["conv"][1], alone["conv"][0])


def test_ssd_chunked_vs_sequential():
    """Mamba2 SSD chunked dual form == step-by-step recurrence (the
    reference's oracle, with its bound)."""
    _, tcfg, _, tp, x, _ = _setup("mamba2-1.3b")
    xs = torch.from_numpy(x)
    y_chunked = TS.ssm_apply(tp, xs, tcfg)
    cache = TS.init_ssm_cache(tcfg, B, "cpu", torch.float32)
    ys = [TS.ssm_decode_step(tp, xs[:, t:t + 1], cache, tcfg)[0]
          for t in range(S)]
    np.testing.assert_allclose(y_chunked.numpy(),
                               torch.cat(ys, dim=1).numpy(), atol=2e-4,
                               rtol=2e-3)


def test_ssm_apply_refuses_partial_chunks():
    _, tcfg, _, tp, x, _ = _setup("mamba2-1.3b")
    with pytest.raises(ValueError, match="divisible"):
        TS.ssm_apply(tp, torch.from_numpy(x[:, :12]), tcfg)
