"""The straight-through backward of the port's `rns_dense` against the
reference's `custom_vjp`s (`repro/core/rns_linear.py` `_rns_dense`,
`_rns_dense_enc`), on the CPU (the plain versions stand in for the
kernels; the backward is a dense float32 matmul on any device).

Live float weight: gx = gy·wᵀ and gw = xᵀ·gy in float32, cast back to
the operands' dtypes.  Encoded weight: gx = gy·ŵᵀ with ŵ = reverse(residues)
·scale, and no gradient reaches the residues or the scale.  Before the
port had the estimator, autograd ran through the plain version's round and
clip (gradients only through the quantization scales) and a kernel launch
returned a tensor with no history.

Tolerances.  Both sides compute the same float32 products; only the
summation order of the two libraries' matmuls differs (measured: 5.1e-7
of the largest |gradient| in float32, 2.1e-4 with bfloat16 operands,
whose gradients both sides round to bfloat16): GRAD_RTOL = 1e-5 relative
to the largest |gradient| in float32, one bfloat16 ulp (2^-8) for
bfloat16.  Against ``x @ ŵ`` in torch itself the encoded gx is bit-equal
(the same matmul).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rns_linear as JL
from repro.core import rns_tensor as JRT
from repro_torch.core import rns_linear as TL
from repro_torch.core import rns_tensor as TRT
from repro_torch.models import layers

GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
SHAPES = [(4, 64, 32), (16, 576, 192), (8, 1536, 576)]


def _inputs(M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32)   # the cotangent
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    return ((jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
             jnp.asarray(c).astype(jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
             torch.from_numpy(c).to(td)))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype):
    got = got.to(torch.float32).numpy()
    tol = GRAD_RTOL[dtype] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_live_grads_match_reference(M, K, N, dtype, backend):
    (jx, jw, jc), (x, w, c) = _inputs(M, K, N, dtype)
    gx_j, gw_j = jax.grad(
        lambda a, b: jnp.sum((JL.rns_dense(a, b, backend="jnp")
                              * jc).astype(jnp.float32)),
        argnums=(0, 1))(jx, jw)
    x.requires_grad_()
    w.requires_grad_()
    y = TL.rns_dense(x, w, backend)
    (y * c).to(torch.float32).sum().backward()
    assert x.grad.dtype == x.dtype and w.grad.dtype == w.dtype
    _close(x.grad, _np(gx_j), dtype)
    _close(w.grad, _np(gw_j), dtype)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_encoded_grad_matches_reference(M, K, N, backend):
    (jx, jw, jc), (x, w, c) = _inputs(M, K, N, "float32", seed=1)
    jt = JRT.encode(jw)
    gx_j = jax.grad(lambda a: jnp.sum(JL.rns_dense(a, jt, backend="jnp")
                                      * jc))(jx)
    wt = TRT.encode(w)
    scale = wt.scale.clone().requires_grad_()
    x.requires_grad_()
    y = TL.rns_dense(x, TRT.RNSTensor(wt.residues, scale, wt.basis), backend)
    (y * c).sum().backward()
    _close(x.grad, _np(gx_j), "float32")
    assert scale.grad is None and not wt.residues.requires_grad
    # bit-equal to the gradient through x @ ŵ, ŵ from the plain reverse
    from repro_torch.core.conversion_plan import ConversionPlan
    w_hat = ConversionPlan.for_basis(wt.basis).reverse_plain(wt.residues) \
        * wt.scale
    xr = x.detach().clone().requires_grad_()
    ((xr @ w_hat) * c).sum().backward()
    assert torch.equal(x.grad, xr.grad)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_forward_unchanged_by_autograd(backend):
    """The Functions' forward is the forward: outputs with and without
    autograd bit-equal, live and encoded, and the output's node is the
    Function's."""
    _, (x, w, _) = _inputs(8, 64, 32, "bfloat16", seed=2)
    wt = TRT.encode(w)
    with torch.no_grad():
        want_live = TL.rns_dense(x, w, backend)
        want_enc = TL.rns_dense(x, wt, backend)
    xg = x.clone().requires_grad_()
    live = TL.rns_dense(xg, w.clone().requires_grad_(), backend)
    enc = TL.rns_dense(xg, wt, backend)
    assert torch.equal(live, want_live) and torch.equal(enc, want_enc)
    assert type(live.grad_fn).__name__ == "_DenseSTEBackward"
    assert type(enc.grad_fn).__name__ == "_EncodedSTEBackward"


def test_linear_grads_through_batched_activations():
    """`layers.linear` reshapes (B, S, K) activations to rows around
    `rns_dense`: its gradients are the dense matmul's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 5, 48)).astype(np.float32))
    x.requires_grad_()
    w.requires_grad_()
    (layers.linear(x, w, "rns_int8") * c).sum().backward()
    want_x = (c.reshape(10, 48) @ w.detach().T).reshape(2, 5, 64)
    want_w = x.detach().reshape(10, 64).T @ c.reshape(10, 48)
    assert torch.equal(x.grad, want_x) and torch.equal(w.grad, want_w)
