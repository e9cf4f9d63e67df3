"""The port's fused RNS linear against the JAX reference, on the CPU.

On a CPU tensor `rns_fused_matmul` runs its plain version, which must be
bit-equal to the jitted reference `rns_dense(x, encode(w), "jnp")` /
`rns_dense(x, w, "jnp")` at smollm launch shapes, and to the Pallas
megakernel itself (interpret mode, as `tests/test_kernels.py` runs it) at
smoke shapes.  The CUDA kernels themselves are held against these plain
versions on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rns_linear as jlin
from repro.core import rns_tensor as jrt
from repro_torch.core import rns_linear as tlin
from repro_torch.core import rns_tensor as trt
from repro_torch.core.rns import basis_for_int8_matmul
from repro_torch.kernels import rns_forward, rns_fused_matmul


def _operands(M, K, N, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :3] = [0.0, 40.0, -40.0]            # an outlier row: ±127 corners
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    w[:, 0] = 0.0                             # an all-zero column
    x = jnp.asarray(x).astype(dtype)
    return x, jnp.asarray(w)


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    return t.to(torch.float32).numpy().tobytes()


@pytest.mark.parametrize("K,N", [(576, 192), (576, 1536), (1536, 576)])
@pytest.mark.parametrize("encoded", [True, False])
def test_rns_dense_matches_jitted_reference_smollm(K, N, encoded):
    x, w = _operands(8, K, N, K + N)
    wt = jrt.encode(w) if encoded else w
    want = jax.jit(lambda a: jlin.rns_dense(a, wt, "jnp"))(x)
    tw = trt.encode(_torch(w)) if encoded else _torch(w)
    got = tlin.rns_dense(_torch(x), tw)
    assert _bits(got) == np.asarray(want).tobytes()


def test_rns_dense_bf16_matches_jitted_reference():
    x, w = _operands(8, 576, 576, 7, dtype=jnp.bfloat16)
    wt = jrt.encode(w.astype(jnp.bfloat16))
    want = jax.jit(lambda a: jlin.rns_dense(a, wt, "jnp"))(x)
    got = tlin.rns_dense(_torch(x), trt.encode(_torch(w).to(torch.bfloat16)))
    assert got.dtype == torch.bfloat16
    assert _bits(got) == np.asarray(want.astype(jnp.float32)).tobytes()


@pytest.mark.parametrize("M,K,N", [(8, 64, 32), (5, 128, 40), (1, 96, 8)])
@pytest.mark.parametrize("encoded", [True, False])
def test_rns_dense_matches_pallas_interpret(M, K, N, encoded):
    x, w = _operands(M, K, N, M * K + N)
    wt = jrt.encode(w) if encoded else w
    want = jax.jit(lambda a: jlin.rns_dense(a, wt, "pallas_fused"))(x)
    tw = trt.encode(_torch(w)) if encoded else _torch(w)
    got = tlin.rns_dense(_torch(x), tw)
    assert _bits(got) == np.asarray(want).tobytes()


def test_encoded_equals_live():
    x, w = _operands(6, 576, 64, 3)
    a = tlin.rns_dense(_torch(x), trt.encode(_torch(w)))
    b = tlin.rns_dense(_torch(x), _torch(w))
    assert _bits(a) == _bits(b)


def test_fused_rejects_bad_operands():
    x = torch.zeros(4, 96)
    s = torch.ones(4, 1)
    basis = basis_for_int8_matmul(96)
    with pytest.raises(ValueError, match="explicit basis"):
        rns_fused_matmul(x, torch.zeros(5, 96, 8, dtype=torch.int8),
                         scale_row=s, scale_col=torch.ones(1, 8))
    with pytest.raises(ValueError, match="channels"):
        rns_fused_matmul(x, torch.zeros(2, 96, 8, dtype=torch.int8), basis,
                         scale_row=s, scale_col=torch.ones(1, 8))
    with pytest.raises(ValueError, match="contraction"):
        rns_fused_matmul(x, torch.zeros(95, 8, dtype=torch.int8),
                         scale_row=s, scale_col=torch.ones(1, 8))
    with pytest.raises(ValueError, match="int8"):
        rns_fused_matmul(x, torch.zeros(96, 8), scale_row=s,
                         scale_col=torch.ones(1, 8))
    with pytest.raises(ValueError, match="int8 or int32"):
        rns_forward(torch.zeros(4, dtype=torch.int64), (47, 43))


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no build, no
    launch counted."""
    before = (rns_fused_matmul.launches, rns_forward.launches)
    x, w = _operands(3, 64, 16, 0)
    tlin.rns_dense(_torch(x), trt.encode(_torch(w)))
    assert (rns_fused_matmul.launches, rns_forward.launches) == before
