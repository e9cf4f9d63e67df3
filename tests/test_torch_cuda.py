"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports torch and the port only, so it also runs where JAX
is not installed: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.core import rns_tensor as trt
from repro_torch.core.quant import quant_scale, quantize_int8
from repro_torch.core.rns import basis_for_int8_matmul
from repro_torch.kernels import ref, rns_forward, rns_fused_matmul

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("M,K,N", [(8, 576, 1536), (512, 1536, 576),
                                   (1, 576, 192), (13, 200, 70),
                                   (3, 64, 33)])
@pytest.mark.parametrize("encoded", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_matches_plain(dev, M, K, N, encoded, dtype):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    x[0, :2] = torch.tensor([40.0, -40.0])       # ±127 after quantization
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    sx = quant_scale(x)
    if encoded:
        wt = trt.encode(w)
        arg, basis, scol = wt.residues, wt.basis, wt.scale
    else:
        arg, scol = quantize_int8(w, dim=0)
        basis = basis_for_int8_matmul(K)
    before = rns_fused_matmul.launches
    got = rns_fused_matmul(x, arg, basis, scale_row=sx, scale_col=scol)
    want = ref.rns_fused_matmul_ref(x, arg, basis, scale_row=sx,
                                    scale_col=scol)
    torch.cuda.synchronize()
    assert rns_fused_matmul.launches == before + 1
    assert torch.equal(got, want)


def test_forward_matches_plain(dev):
    x8 = torch.arange(-128, 128, dtype=torch.int8, device=dev).repeat(999)
    x32 = torch.randint(-2**31, 2**31 - 1, (77777,), dtype=torch.int32,
                        device=dev)
    for k in (64, 576):
        mods = basis_for_int8_matmul(k).moduli
        for x in (x8, x32):
            for dtype in (torch.int8, torch.int32):
                got = rns_forward(x, mods, dtype=dtype)
                assert torch.equal(got, ref.rns_forward_ref(x, mods, dtype))
