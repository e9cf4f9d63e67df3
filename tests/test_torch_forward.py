"""`models.transformer.forward`, the full-sequence training forward, against
the reference's `forward` on every smoke config the port serves, on the
CPU: logits (B, S, vocab) float32 and the MoE aux, on the reference's
`make_params` weights, encoded as each config's `Engine` encodes them
(`encode_weights` configs run the encoded-weight datapath, the resident
config its residue-domain chains), for a pipeline batch (seeded embeds for
the embeddings frontend).

Tolerance.  bf16 as published: the reference's jitted program skips
intermediate bf16 roundings the port's op-by-op program takes; measured
up to 1.7% of the reference's largest |logit| (0.0547 of 3.30, llama4;
0.0103 of 0.594 on the RNS configs, where a last-bit difference can move
an int8 quantization step): LOGIT_RTOL = 0.08 of it, the families tests'
bound.  The resident config's in-domain requantizes turn such drift into
int8 steps between launches: measured 0.0586, held to
RESIDENT_LOGIT_ATOL = 0.15, the bound `tests/test_torch_chain.py` holds its
served logits to.  The MoE aux within 1e-3 (measured 1.4e-5 on 2.20).
"""
import jax
import numpy as np
import pytest
import torch

import _train_compare as tc
from repro.core.rns import basis_for_chain as jax_chain_basis
from repro.core.rns_tensor import encode_params as jax_encode
from repro.models import transformer as JT
from repro_torch.configs.base import list_archs
from repro_torch.core.rns import basis_for_chain
from repro_torch.core.rns_tensor import encode_params
from repro_torch.models import transformer as TT

LOGIT_RTOL = 0.08
RESIDENT_LOGIT_ATOL = 0.15


def _encoded(jcfg, tcfg, jp, tp):
    """Both sides' parameters as their engines serve them."""
    spec = tcfg.linear_spec
    if not (spec.is_rns and spec.encode_weights):
        return jp, tp
    chain = spec.domain == "residue" and tcfg.glu and tcfg.d_ff > 0
    jp = jax_encode(jp, backend="jnp", group_basis=(
        {"mlp": jax_chain_basis(jcfg.d_ff)} if chain else None))
    with torch.no_grad():
        tp = encode_params(tp, group_basis=(
            {"mlp": basis_for_chain(tcfg.d_ff)} if chain else None))
    return jp, tp


@pytest.mark.parametrize("arch", list_archs())
def test_forward_matches_reference(arch):
    jcfg, tcfg = tc.configs(arch)
    jp, tp = _encoded(jcfg, tcfg, *tc.params(jcfg, tcfg))
    jb, tb = tc.batches(jcfg)
    jlog, jaux = jax.jit(lambda p, b: JT.forward(jcfg, p, b))(jp, jb)
    with torch.no_grad():
        tlog, taux = TT.forward(tcfg, tp, tb)
    jlog = tc.f32(jlog)
    assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
    assert torch.isfinite(tlog).all()
    err = np.abs(tlog.numpy() - jlog).max()
    print(f"{arch}: max |logit diff| {err:.5f} of {np.abs(jlog).max():.3f}")
    if tcfg.linear_domain == "residue":
        assert err <= RESIDENT_LOGIT_ATOL
    else:
        assert err <= LOGIT_RTOL * np.abs(jlog).max()
    assert abs(float(taux) - float(jaux)) <= 1e-3 * max(1.0, float(jaux))
