"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports torch and the port only, so it also runs where JAX
is not installed: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import contextlib
import os
import shutil

import pytest
import torch

import _convert_cases as cc

from repro_torch.core import rns_tensor as trt
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import quant_scale, quantize_int8, requant_const
from repro_torch.core.rns import (RNSBasis, basis_for_chain,
                                  basis_for_int8_matmul)
from repro_torch.dist.rns_shard import channel_partials, channel_sliced_matmul
from repro_torch.kernels import (flash_attention, fold, ref, rns_forward,
                                 rns_fused_crt_partial, rns_fused_matmul,
                                 rns_matmul, rns_modmul, rns_reverse)
from repro_torch.kernels import _build, tune
from repro_torch.kernels import rns_fused as tile
from repro_torch.kernels.flash_attention import _pin_route, flash_route
from repro_torch.kernels.rns_convert import REVERSE_INSTANCES

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _tune_table(tmp_path_factory):
    """The tuner reads and writes a copy of the committed H100 table."""
    path = tmp_path_factory.mktemp("tune") / "tune_torch.json"
    shutil.copy(tune.COMMITTED_TABLE, path)
    old = os.environ.get("RNS_TORCH_TUNE_CACHE")
    os.environ["RNS_TORCH_TUNE_CACHE"] = str(path)
    tune.clear_memory_cache()
    yield path
    if old is None:
        del os.environ["RNS_TORCH_TUNE_CACHE"]
    else:
        os.environ["RNS_TORCH_TUNE_CACHE"] = old
    tune.clear_memory_cache()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Shapes run on the 32-row tensor-core tile, pinned (their grids have
# fewer tiles than an H100 has SMs, so the launcher would pick 16 rows):
# ragged M (17, 65, 100), K not a multiple of 32 (200), N not a multiple
# of 64 (200), and a narrow grid (M 64, N 192: 6 tiles, K unsplit).  The
# tile takes only N and K multiples of 4; the byte-wise shapes (N 70) run
# on the 16-row tile.
TILE_MMA = [(17, 200, 200), (64, 1536, 192), (65, 200, 192),
            (100, 1536, 200)]


def _rows(M, K, N):
    """Pins the TILE_MMA shapes to the 32-row tile."""
    if (M, K, N) in TILE_MMA:
        return tile._pin_tile_rows(tile.TM_MMA)
    return contextlib.nullcontext()


# (8, 200, 192): K not a multiple of the 32-deep step, weight rows that
# stream by cp.async; N 70 and 33: rows read a step ahead in registers;
# K 5504: hymba-1.5b's down projection, the C = 6 basis
@pytest.mark.parametrize("M,K,N", [(8, 576, 1536), (512, 1536, 576),
                                   (1, 576, 192), (13, 200, 70),
                                   (3, 64, 33), (512, 64, 192),
                                   (8, 200, 192), (8, 5504, 1600),
                                   (512, 5504, 1600)] + TILE_MMA)
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
    with _rows(M, K, N):
        got = rns_fused_matmul(x, arg, basis, scale_row=sx, scale_col=scol)
    want = ref.rns_fused_matmul_ref(x, arg, basis, scale_row=sx,
                                    scale_col=scol)
    torch.cuda.synchronize()
    assert rns_fused_matmul.launches == before + 1
    assert torch.equal(got, want)


INT8_SCALES = ("none", "scalar", "n", "m1", "mn")


def _int8_scale(kind, M, N, g, dev):
    def u(*shape):
        return torch.rand(shape, generator=g, device=dev) + 0.01
    return {"none": None, "scalar": u(), "n": u(N), "m1": u(M, 1),
            "mn": u(M, N)}[kind]


@pytest.mark.parametrize("M,K,N", [(8, 576, 1536), (512, 1536, 576),
                                   (1, 576, 192), (13, 200, 70),
                                   (512, 576, 192)] + TILE_MMA)
@pytest.mark.parametrize("encoded", [True, False])
@pytest.mark.parametrize("scale", INT8_SCALES)
def test_fused_raw_int8_matches_plain(dev, M, K, N, encoded, scale):
    """The raw-int8 prologue (A_SHARED with the float epilogue), unscaled
    or with each lowered scale form: bit-equal to the plain version and to
    the float64 product of the int8 operands times the scale."""
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    x[0, :] = -128
    w[:, 0] = -128
    s = _int8_scale(scale, M, N, g, dev)
    basis = basis_for_int8_matmul(K)
    arg = trt.RNSTensor.from_int8(w) if encoded else w
    before = rns_fused_matmul.raw_launches
    with _rows(M, K, N):
        got = rns_fused_matmul(x, arg, basis, scale=s)
    want = ref.rns_fused_matmul_ref(x, arg.residues if encoded else w, basis,
                                    scale=s if scale == "mn" else None,
                                    scale_row=s if scale == "m1" else None,
                                    scale_col=None if scale in (
                                        "none", "m1", "mn") else
                                    s.reshape(1, -1).expand(1, N))
    exact = (x.double() @ w.double()).float()
    torch.cuda.synchronize()
    assert rns_fused_matmul.raw_launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, exact if s is None else exact * s)


@pytest.mark.parametrize("form", ["bf16", "f32", "residue_in"])
@pytest.mark.parametrize("M", [8, 512])
def test_fused_without_column_scale_matches_plain(dev, form, M):
    """A quantize or residue-in launch given no column scale: only the raw
    int8 instances treat a factor as optional, so these multiply by a
    column factor of ones, which is exact: bit-equal to the plain version,
    which leaves the factor out."""
    K, N = 576, 192
    g = torch.Generator(device=dev).manual_seed(M)
    basis = basis_for_int8_matmul(K)
    w = trt.encode(torch.randn(K, N, generator=g, device=dev) / K ** 0.5,
                   basis)
    x = torch.randn(M, K, generator=g, device=dev)
    if form == "residue_in":
        xa = trt.encode_activation(x, basis)
        got = rns_fused_matmul(xa, w)
        want = ref.rns_fused_matmul_ref(xa.residues, w.residues, basis,
                                        scale_row=xa.scale)
    else:
        xq = x.to(torch.bfloat16 if form == "bf16" else torch.float32)
        sx = quant_scale(xq)
        got = rns_fused_matmul(xq, w, scale_row=sx)
        want = ref.rns_fused_matmul_ref(xq, w.residues, basis, scale_row=sx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("encoded", [True, False])
@pytest.mark.parametrize("M,K,N", [(8, 576, 1536), (512, 1536, 576),
                                   (13, 64, 70)] + TILE_MMA[:2])
def test_crt_raw_int8_and_live_match_plain(dev, M, K, N, encoded):
    """The raw-int8 slice launch (A_SHARED, CRT limbs) with encoded or
    live (K, N) weights: every slice bit-equal to its plain version, the
    summed planes through crt_finish bit-equal to the raw-int8 fused
    launch, for every n that divides C; the live quantize form too."""
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    basis = basis_for_int8_matmul(K)
    arg = trt.RNSTensor.from_int8(w) if encoded else w
    full = rns_fused_matmul(x, arg, basis)
    C = len(basis.moduli)
    for n in [n for n in range(1, C + 1) if C % n == 0]:
        before = rns_fused_crt_partial.launches
        with _rows(M, K, N):
            parts = channel_partials(x, arg, n, basis=basis)
        torch.cuda.synchronize()
        assert rns_fused_crt_partial.launches == before + n
        for part, want in zip(parts, channel_partials(x, arg, n, basis=basis,
                                                      plain=True)):
            assert torch.equal(part, want)
        with _rows(M, K, N):
            got = channel_sliced_matmul(x, arg, n, basis=basis)
        assert torch.equal(got, full)
    if not encoded:
        xf = torch.randn(M, K, generator=g, device=dev)
        sx = quant_scale(xf)
        for n in (1, C):
            got = channel_sliced_matmul(xf, w, n, basis=basis, scale_row=sx,
                                        scale_col=torch.ones(1, N,
                                                             device=dev))
            assert torch.equal(got, rns_fused_matmul(
                xf, w, basis, scale_row=sx,
                scale_col=torch.ones(1, N, device=dev)))


@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("encoded", [True, False])
def test_int_matmul_routes_on_the_card(dev, broadcast, backend, encoded):
    """`rns_int_matmul`'s three routes launch their kernels (fused: one
    raw-int8 `rns_fused_matmul`; staged: forward + matmul + reverse;
    per-channel: two forwards, one when encoded, + matmul + reverse) and
    give the exact product times the scale."""
    from repro_torch.core.rns_linear import rns_int_matmul

    M, K, N = 8, 576, 192
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(M, N, generator=g, device=dev)
    wq = trt.RNSTensor.from_int8(w) if encoded else w
    fns = (rns_fused_matmul, rns_forward, rns_matmul, rns_reverse)
    before = [f.launches for f in fns]
    got = rns_int_matmul(x, wq, broadcast=broadcast, backend=backend,
                         scale=s)
    torch.cuda.synchronize()
    counts = [f.launches - b for f, b in zip(fns, before)]
    if broadcast and backend == "auto":
        assert counts == [1, 0, 0, 0]
    elif broadcast:
        assert counts == [0, 0 if encoded else 1, 1, 1]
    else:
        assert counts == [0, 1 if encoded else 2, 1, 1]
    assert torch.equal(got, (x.double() @ w.double()).float() * s)


def test_wide_basis_refuses_a_kernel_launch(dev):
    """The basis with 1024 (``int8_only=False``) is for the plain path: on
    the card the fused and the staged launches raise."""
    from repro_torch.core.rns import basis_for_accumulation
    from repro_torch.core.rns_linear import rns_int_matmul

    wide = basis_for_accumulation(64 * 128 * 128, int8_only=False)
    x = torch.zeros((4, 64), dtype=torch.int8, device=dev)
    w = torch.zeros((64, 8), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        rns_fused_matmul(x, w, wide)
    with pytest.raises(ValueError, match="int8"):
        rns_int_matmul(x, w, wide, broadcast=False, backend="pallas")


def test_forward_matches_plain(dev):
    x8 = torch.arange(-128, 128, dtype=torch.int8, device=dev).repeat(999)
    x32 = torch.randint(-2**31, 2**31 - 1, (77777,), dtype=torch.int32,
                        device=dev)
    for k in (64, 576, 5504):
        mods = basis_for_int8_matmul(k).moduli
        for x in (x8, x32):
            for dtype in (torch.int8, torch.int32):
                got = rns_forward(x, mods, dtype=dtype)
                assert torch.equal(got, ref.rns_forward_ref(x, mods, dtype))


def _chain_operands(dev, M, K, N, seed, basis=None):
    """An activation RNSTensor and a weight RNSTensor in one basis, with
    saturated ±127 corners in both."""
    g = torch.Generator(device=dev).manual_seed(seed)
    basis = basis or basis_for_chain(max(K, 128))
    x = torch.randn(M, K, generator=g, device=dev)
    x[0, :2] = torch.tensor([40.0, -40.0])
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    return trt.encode_activation(x, basis), trt.encode(w, basis), g


@pytest.mark.parametrize("M,K,N", [(8, 576, 1536), (512, 576, 1536),
                                   (8, 1536, 576), (512, 1536, 576),
                                   (8, 576, 960), (13, 200, 70),
                                   (8, 200, 192)] + TILE_MMA)
@pytest.mark.parametrize("form", ["float", "residues", "gated"])
def test_residue_in_matches_plain(dev, M, K, N, form):
    xa, wt, g = _chain_operands(dev, M, K, N, M + K + N)
    gate = None
    srow = xa.scale
    if form == "gated":
        gate = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                             dtype=torch.int8)
        gate[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
        srow = xa.scale * 0.5
    emit = "residues" if form == "residues" else "float"
    before = (rns_fused_matmul.launches, rns_fused_matmul.residue_in_launches)
    with _rows(M, K, N):
        got = rns_fused_matmul(xa, wt, scale_row=srow, scale_col=wt.scale,
                               gate=gate, emit=emit)
    creq = requant_const(wt.scale, K) if emit == "residues" else None
    want = ref.rns_fused_matmul_ref(xa.residues, wt.residues, wt.basis,
                                    scale_row=srow, scale_col=wt.scale,
                                    gate=gate, creq=creq)
    torch.cuda.synchronize()
    assert (rns_fused_matmul.launches,
            rns_fused_matmul.residue_in_launches) == (before[0] + 1,
                                                      before[1] + 1)
    if emit == "residues":
        assert torch.equal(got.residues, want)
        assert torch.equal(got.scale, srow * creq)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(8, 576, 576), (512, 576, 192),
                                   (8, 1536, 576), (13, 200, 70),
                                   (8, 200, 192)] + TILE_MMA)
def test_matmul_broadcast_matches_plain(dev, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    mods = basis_for_int8_matmul(K).moduli
    x = torch.randint(-128, 128, (1, M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    w_res = rns_forward(w, mods, dtype=torch.int8)
    before = rns_matmul.launches
    with _rows(M, K, N):
        got = rns_matmul(x, w_res, mods, signed_a=True)
    torch.cuda.synchronize()
    assert rns_matmul.launches == before + 1
    assert torch.equal(got, ref.rns_matmul_ref(x, w_res, mods, signed_a=True))


@pytest.mark.parametrize("M,K,N,C", [
    (8, 576, 1536, None), (512, 1536, 576, None), (13, 200, 70, None)]
    + [(*shape, None) for shape in TILE_MMA]
    + [(*shape, c) for shape in TILE_MMA[:2] for c in range(1, 7)])
def test_matmul_canonical_matches_plain(dev, M, K, N, C):
    """The canonical emit on the chain basis, or on its first C channels
    (the fold needs only each channel's modulus)."""
    xa, wt, _ = _chain_operands(dev, M, K, N, 3 * M + K)
    sl = slice(None) if C is None else slice(0, C)
    a, w, mods = xa.residues[sl], wt.residues[sl], wt.moduli[sl]
    with _rows(M, K, N):
        got = rns_matmul(a, w, mods)
    assert torch.equal(got, ref.rns_matmul_ref(a, w, mods))


@pytest.mark.parametrize("form", ["quantize", "float", "residues", "gated",
                                  "broadcast", "canonical", "crt"])
def test_tile_heights_agree(dev, form):
    """At M = 512 the 32-row tensor-core tile and the 16-row __dp4a tile
    (each pinned) give the same bits, each launch at the height asked
    for."""
    M, K, N = 512, 1536, 576
    xa, wt, g = _chain_operands(dev, M, K, N, 21)
    gate = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                         dtype=torch.int8)
    xf = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    w8 = trt.encode(torch.randn(K, N, generator=g, device=dev) / K ** 0.5)
    kw = dict(scale_row=xa.scale, scale_col=wt.scale)
    run = {
        "quantize": lambda: rns_fused_matmul(xf, w8, scale_row=quant_scale(xf),
                                             scale_col=w8.scale),
        "float": lambda: rns_fused_matmul(xa, wt, **kw),
        "residues": lambda: rns_fused_matmul(xa, wt, emit="residues",
                                             **kw).residues,
        "gated": lambda: rns_fused_matmul(xa, wt, gate=gate, **kw),
        "broadcast": lambda: rns_matmul(gate[None], w8.residues, w8.moduli,
                                        signed_a=True),
        "canonical": lambda: rns_matmul(xa.residues, wt.residues, wt.moduli),
        "crt": lambda: torch.stack(channel_partials(
            xa, wt, 1, scale_row=xa.scale, gate=gate)),
    }[form]
    before = dict(tile.tile_launches)
    with tile._pin_tile_rows(tile.TM_MMA):
        got64 = run()
    with tile._pin_tile_rows(tile.TM):
        got16 = run()
    torch.cuda.synchronize()
    assert tile.tile_launches == {tile.TM: before[tile.TM] + 1,
                                  tile.TM_MMA: before[tile.TM_MMA] + 1,
                                  tile.TM_WG: before[tile.TM_WG]}
    assert torch.equal(got64, got16)


# The 64-row wgmma + TMA tile (raw int8 A, csrc/rns_tile_wg.cuh), pinned:
# ragged M; N not a multiple of its 32 columns (200) and rows read word by
# word (N 36: not a multiple of 16); a K tail past the last full 128-deep
# stage (208, 576); K % 16 != 0 (200) routes to the 32-row tile.
WG_M = (17, 64, 100, 512, 2048)
WG_SHAPES = ((576, 200), (208, 36), (1536, 64))


def _wg_pinned(fn, routed=False):
    """``fn()`` pinned to 64 rows, with the launches it made at 64 rows
    (0 for a ``routed`` shape, which runs at 32)."""
    before = dict(tile.tile_launches)
    with tile._pin_tile_rows(tile.TM_WG):
        out = fn()
    torch.cuda.synchronize()
    n = tile.tile_launches[tile.TM_WG] - before[tile.TM_WG]
    m = tile.tile_launches[tile.TM_MMA] - before[tile.TM_MMA]
    assert (n == 0 and m > 0) if routed else (n > 0 and m == 0)
    return out


def _wg_fused_case(dev, M, K, N, encoded, basis, seed):
    """Raw int8 x on the 64-row tile in ``basis``: every scale form of the
    float emit, the in-domain residue emit, and the CRT limbs of
    one-channel and whole-basis slices, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    x[0, :] = -128
    w[:, 0] = -128
    arg = trt.RNSTensor.from_int8(w, basis=basis) if encoded else w
    routed = K % 16 != 0
    wres = arg.residues if encoded else w
    C = len(basis.moduli)
    for kind in INT8_SCALES:
        s = _int8_scale(kind, M, N, g, dev)
        got = _wg_pinned(lambda: rns_fused_matmul(x, arg, basis, scale=s),
                         routed)
        want = ref.rns_fused_matmul_ref(
            x, wres, basis, scale=s if kind == "mn" else None,
            scale_row=s if kind == "m1" else None,
            scale_col=None if kind in ("none", "m1", "mn") else
            s.reshape(1, -1).expand(1, N))
        assert torch.equal(got, want), (C, K, N, kind)
    sr = torch.rand(M, 1, generator=g, device=dev) * 1e-2 + 1e-3
    sc = torch.rand(1, N, generator=g, device=dev) * 1e-2 + 1e-3
    got = _wg_pinned(lambda: rns_fused_matmul(
        x, arg, basis, emit="residues", scale_row=sr, scale_col=sc), routed)
    # an int8 operand's in-domain epilogue reads no row factor
    want = ref.rns_fused_matmul_ref(x, wres, basis, scale_col=sc,
                                    creq=requant_const(sc, K))
    assert torch.equal(got.residues, want), (C, K, N, "residues")
    for n in sorted({1, C}):
        parts = _wg_pinned(lambda: channel_partials(x, arg, n, basis=basis),
                           routed)
        for part, want in zip(parts, channel_partials(
                x, arg, n, basis=basis, plain=True)):
            assert torch.equal(part, want), (C, K, N, "crt", n)


@pytest.mark.parametrize("M", WG_M)
@pytest.mark.parametrize("encoded", [True, False])
def test_wg_tile_fused_matches_plain(dev, M, encoded):
    """Raw int8 x on the 64-row tile, C = 5 (and C = 6 at K = 5504), every
    emit and scale form (`_wg_fused_case`)."""
    shapes = WG_SHAPES + ((200, 64),) + (((5504, 40),) if M <= 100 else ())
    for K, N in shapes:
        _wg_fused_case(dev, M, K, N, encoded, basis_for_int8_matmul(K),
                       M * K + N)


@pytest.mark.parametrize("C", range(1, 8))
@pytest.mark.parametrize("encoded", [True, False])
def test_wg_tile_every_channel_count_matches_plain(dev, C, encoded):
    """The 64-row tile's C = 1..7 instances (the chain basis's first C
    moduli), encoded and live weights, every emit and scale form
    (`_wg_fused_case`), at a ragged M: N not a multiple of the tile's 32
    columns with a K tail past the last full stage (208, 36), and a
    prefill shape (576, 200)."""
    basis = RNSBasis(name=f"chain-1536-c{C}",
                     moduli=basis_for_chain(1536).moduli[:C])
    for M, K, N in ((100, 208, 36), (100, 576, 200), (512, 576, 200)):
        _wg_fused_case(dev, M, K, N, encoded, basis, 11 * C + M + K)


@pytest.mark.parametrize("M", WG_M)
def test_wg_tile_broadcast_matches_plain(dev, M):
    """The broadcast rns_matmul (canonical emit) on the 64-row tile at C =
    2..7 (the chain basis's first C channels), bit for bit."""
    mods_all = basis_for_chain(1536).moduli
    for K, N in WG_SHAPES + ((200, 64),):
        g = torch.Generator(device=dev).manual_seed(M + K * N)
        x = torch.randint(-128, 128, (1, M, K), generator=g, device=dev,
                          dtype=torch.int8)
        for C in range(2, len(mods_all) + 1):
            mods = mods_all[:C]
            w = torch.stack([torch.randint(0, m, (K, N), generator=g,
                                           device=dev) for m in mods]
                            ).to(torch.int8)
            got = _wg_pinned(lambda: rns_matmul(x, w, mods, signed_a=True),
                             K % 16 != 0)
            assert torch.equal(got, ref.rns_matmul_ref(x, w, mods,
                                                       signed_a=True)), \
                (K, N, C)


def test_wg_tile_refuses_unreadable_operands(dev):
    """Operands the 64-row tile cannot read run on the 32-row tile by the
    route rule, also as a sliced (misaligned) A plane; the launcher itself
    refuses them (cudaErrorInvalidValue) rather than reading past them."""
    g = torch.Generator(device=dev).manual_seed(7)
    base = torch.randint(-128, 128, (512 * 576 + 4,), generator=g,
                         device=dev, dtype=torch.int8)
    x = base[4:].view(512, 576)               # 4-byte, not 16-byte aligned
    w = torch.randint(-128, 128, (576, 64), generator=g, device=dev,
                      dtype=torch.int8)
    basis = basis_for_int8_matmul(576)
    got = _wg_pinned(lambda: rns_fused_matmul(x, w, basis), routed=True)
    assert torch.equal(got, ref.rns_fused_matmul_ref(x, w, basis))
    st = tile._kernel_plan(basis, 576, True)[2]
    out = torch.empty(512, 64, device=dev)
    rc = tile.run_tile(tile.A_SHARED, tile.EMIT_FLOAT, st, x=x, w=w, out=out,
                       M=512, K=576, N=64, tm=tile.TM_WG, splits=1, vec=True,
                       avec=True)
    assert rc == 1                            # cudaErrorInvalidValue


# Decode launches (M <= 16) at K = 1536 on the 16-row tile, K split over
# a cluster: every A mode and emit of the three entries at C = 1, 2, 5, 7
# and 8 channels (basis_for_int8_matmul(1536), basis_for_chain(1536) and
# basis_for_chain(65536), the widest basis a config builds).  One and two
# channels exist only as CRT slices of the 8-channel basis and as its
# sub-bases (canonical rns_matmul).
DECODE_FORMS = ("quantize-f32", "quantize-bf16", "live", "float",
                "residues", "gated", "broadcast", "canonical",
                "crt-quantize", "crt-residue", "crt-gated")
SLICE_FORMS = ("canonical", "crt-quantize", "crt-residue", "crt-gated")
DECODE_CASES = [(M, C, form) for M in (1, 8, 16) for C in (1, 2, 5, 7, 8)
                for form in DECODE_FORMS if C >= 5 or form in SLICE_FORMS]


def _decode_basis(C):
    if C == 5:
        return basis_for_int8_matmul(1536)
    return basis_for_chain(1536) if C == 7 else basis_for_chain(65536)


@pytest.mark.parametrize("M,C,form", DECODE_CASES)
def test_decode_tile_matches_plain(dev, M, C, form):
    K, N = 1536, {1: 192, 8: 576, 16: 960}[M]
    basis = _decode_basis(C)
    mods = basis.moduli
    xa, wt, g = _chain_operands(dev, M, K, N, 7 * M + C, basis)
    gate = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                         dtype=torch.int8)
    gate[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
    x = torch.randn(M, K, generator=g, device=dev)
    x[0, :2] = torch.tensor([40.0, -40.0])
    if form == "quantize-bf16" or form == "crt-quantize":
        x = x.to(torch.bfloat16)
    before = tile.tile_launches[tile.TM]
    launches = 1
    if form.startswith("crt"):
        n = len(mods) // C                        # slices of C channels
        xin, srow, g8 = xa, xa.scale, None
        if form == "crt-quantize":
            xin, srow = x, quant_scale(x)
        elif form == "crt-gated":
            srow, g8 = xa.scale * 0.5, gate
        kw = dict(scale_row=srow, gate=g8)
        got = torch.stack(channel_partials(xin, wt, n, **kw))
        want = torch.stack(channel_partials(xin, wt, n, plain=True, **kw))
        launches = n
    elif form in ("quantize-f32", "quantize-bf16", "live"):
        sx = quant_scale(x)
        arg, scol = wt.residues, wt.scale
        if form == "live":
            arg, scol = quantize_int8(torch.randn(K, N, generator=g,
                                                  device=dev) / K ** 0.5,
                                      dim=0)
        got = rns_fused_matmul(x, arg, basis, scale_row=sx, scale_col=scol)
        want = ref.rns_fused_matmul_ref(x, arg, basis, scale_row=sx,
                                        scale_col=scol)
    elif form in ("float", "residues", "gated"):
        srow = xa.scale * 0.5 if form == "gated" else xa.scale
        g8 = gate if form == "gated" else None
        emit = "residues" if form == "residues" else "float"
        got = rns_fused_matmul(xa, wt, scale_row=srow, scale_col=wt.scale,
                               gate=g8, emit=emit)
        creq = requant_const(wt.scale, K) if emit == "residues" else None
        if creq is not None:
            got = got.residues
        want = ref.rns_fused_matmul_ref(xa.residues, wt.residues, basis,
                                        scale_row=srow, scale_col=wt.scale,
                                        gate=g8, creq=creq)
    elif form == "broadcast":
        got = rns_matmul(gate[None], wt.residues, mods, signed_a=True)
        want = ref.rns_matmul_ref(gate[None], wt.residues, mods,
                                  signed_a=True)
    else:                                          # canonical, C channels
        a, w, sub = xa.residues[:C], wt.residues[:C], mods[:C]
        got = rns_matmul(a, w, sub)
        want = ref.rns_matmul_ref(a, w, sub)
    torch.cuda.synchronize()
    assert tile.tile_launches[tile.TM] == before + launches
    assert torch.equal(got, want)


def test_decode_launch_captures(dev):
    """One layer's seven decode launches (M = 8, the fused path's quantize
    form with encoded weights, each K split over a cluster) captured in
    one CUDA graph and replayed twice on new inputs copied into the
    captured buffers: each replay bit-equal to the plain versions."""
    M = 8
    shapes = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536),
              (576, 1536), (1536, 576)]
    g = torch.Generator(device=dev).manual_seed(16)
    ws = [trt.encode(torch.randn(K, N, generator=g, device=dev) / K ** 0.5)
          for K, N in shapes]
    xs = [torch.empty(M, K, device=dev, dtype=torch.bfloat16)
          for K, _ in shapes]

    def fill():
        for x in xs:
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
            x[0, :2] = torch.tensor([40.0, -40.0])
        return [quant_scale(x) for x in xs]

    ss = fill()

    def run():
        return [rns_fused_matmul(x, w, scale_row=s, scale_col=w.scale)
                for x, s, w in zip(xs, ss, ws)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()            # first launches: build, shared memory limits
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rns_fused_matmul.launches
    with torch.cuda.graph(graph):
        outs = run()
    assert rns_fused_matmul.launches == before + len(shapes)
    for _ in range(2):
        for s, new in zip(ss, fill()):
            s.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        for out, x, s, w in zip(outs, xs, ss, ws):
            want = ref.rns_fused_matmul_ref(x, w.residues, w.basis,
                                            scale_row=s, scale_col=w.scale)
            assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_modmul_matches_plain(dev, dtype):
    mods = basis_for_chain(1536).moduli
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.stack([torch.randint(0, m, (8 * 1536 + 5,), generator=g,
                                   device=dev) for m in mods]).to(dtype)
    b = torch.stack([torch.randint(0, m, (8 * 1536 + 5,), generator=g,
                                   device=dev) for m in mods]).to(dtype)
    before = rns_modmul.launches
    got = rns_modmul(a, b, mods)
    torch.cuda.synchronize()
    assert rns_modmul.launches == before + 1
    assert torch.equal(got, ref.rns_modmul_ref(a, b, mods))


MODMUL_TYPES = [(torch.int8, torch.int32), (torch.int8, torch.int8),
                (torch.int32, torch.int32), (torch.int32, torch.int8)]
# int32 residues past the two-multiply mod's reach (`direct_mod`): 46,337
# and 2^15 + 3 take the quotient estimate, 1,667 and 1,649 (just past its
# first miss) too, beside moduli that alone would not
MODMUL_LARGE = (2**15 + 3, 46337, 1667, 1649, 131, 2)


def _modmul_operands(mods, S, dtype, seed, dev, offset=0):
    """Two (C, S) canonical residue planes of ``dtype``, each m − 1 at its
    first and last element, stored ``offset`` elements into a fresh buffer
    (an offset > 0 puts every plane off the 16-byte boundary)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(2):
        r = torch.stack([torch.randint(0, m, (S,), generator=g, device=dev)
                         for m in mods]).to(dtype)
        if S:
            top = torch.tensor([m - 1 for m in mods], device=dev)
            r[:, 0] = r[:, -1] = top.to(dtype)
        buf = torch.empty(len(mods) * S + offset, dtype=dtype, device=dev)
        view = buf[offset:].view(len(mods), S)
        view.copy_(r)
        out.append(view)
    return out


def _modmul_same(a, b, mods, otype):
    before = rns_modmul.launches
    got = rns_modmul(a, b, mods, out_dtype=otype)
    torch.cuda.synchronize()
    assert rns_modmul.launches == before + (a.numel() > 0)
    assert got.dtype == otype
    assert torch.equal(got, ref.rns_modmul_ref(a, b, mods, out_dtype=otype))


@pytest.mark.parametrize("itype,otype", MODMUL_TYPES)
def test_modmul_ragged_and_misaligned(dev, itype, otype):
    """Every length 0-33 (one element a thread); the vector body at its
    least length, with a ragged end (planes off the 16-byte boundary,
    one element a thread) and at the staged chain's decode and prefill
    shapes (7, 8·1536) and (7, 512·1536); each fresh and starting 1 or 3
    elements off a 16-byte boundary.  Bit-equal to the plain version in
    both output types, one launch."""
    mods = basis_for_chain(1536).moduli
    for S in range(34):
        _modmul_same(*_modmul_operands(mods, S, itype, S, dev), mods, otype)
    big = _vector_size(16)
    for S in (big, big + 1, big + 16, 8 * 1536, 512 * 1536):
        for off in (0, 1, 3):
            a, b = _modmul_operands(mods, S, itype, S + off, dev, off)
            _modmul_same(a, b, mods, otype)


@pytest.mark.parametrize("C", range(1, 13))
@pytest.mark.parametrize("itype,otype", MODMUL_TYPES)
def test_modmul_every_channel_count(dev, C, itype, otype):
    mods = cc.SMALL_MODULI[:C]
    for S in (8 * 1536, _vector_size(16) + 16):
        _modmul_same(*_modmul_operands(mods, S, itype, C, dev), mods, otype)


@pytest.mark.parametrize("S", [33, 12 * 1536, "vectors"])
def test_modmul_large_moduli(dev, S):
    """int32 residues of moduli where the two-multiply mod is not exact:
    the quotient estimate and its correction, at the largest products."""
    S = _vector_size(16) + 16 if S == "vectors" else S
    for off in (0, 1):
        a, b = _modmul_operands(MODMUL_LARGE, S, torch.int32, S, dev, off)
        _modmul_same(a, b, MODMUL_LARGE, torch.int32)


@pytest.mark.parametrize("basis_of", [lambda: basis_for_int8_matmul(576),
                                      lambda: basis_for_chain(1536)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_reverse_matches_plain(dev, basis_of, with_scale):
    basis = basis_of()
    conv = ConversionPlan.for_basis(basis)
    g = torch.Generator(device=dev).manual_seed(5)
    half = basis.M // 2
    vals = torch.randint(-2**62, 2**62, (8 * 1536 + 3,), generator=g,
                         device=dev) % (2 * half) - half
    vals[:4] = torch.tensor([0, -1, half - 1, -half], device=dev)
    res = torch.stack([torch.remainder(vals, m) for m in basis.moduli]) \
        .to(torch.int32)
    scale = (torch.rand(vals.shape, generator=g, device=dev)
             if with_scale else None)
    before = rns_reverse.launches
    got = rns_reverse(res, conv, scale=scale)
    torch.cuda.synchronize()
    assert rns_reverse.launches == before + 1
    assert torch.equal(got, ref.rns_reverse_ref(res, conv, scale))


def test_chain_staged_equals_fused(dev):
    """rns_chain_linear on the staged kernels equals the fused kernel bit
    for bit at the full-width MLP shapes."""
    from repro_torch.core.quant import quantize_int8 as q8
    from repro_torch.core.rns_linear import rns_chain_linear
    from repro_torch.models.layers import silu

    xa, wg, g = _chain_operands(dev, 8, 576, 1536, 11)
    wu = trt.encode(torch.randn(576, 1536, generator=g, device=dev) / 24,
                    xa.basis)
    wd = trt.encode(torch.randn(1536, 576, generator=g, device=dev) / 40,
                    xa.basis)
    outs = []
    for backend in ("pallas", "pallas_fused"):
        gf = rns_chain_linear(xa, wg, backend=backend)
        up = rns_chain_linear(xa, wu, emit="residues", backend=backend)
        gq, sg = q8(silu(gf), dim=-1)
        outs.append(rns_chain_linear(up, wd, gate=gq, gate_scale=sg,
                                     backend=backend))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_chain_staged_equals_fused_prefill(dev):
    """The staged chain at M = 512 (its gate multiply on the vector path,
    int8 out, one launch) equals the fused chain bit for bit."""
    from repro_torch.core.quant import quantize_int8 as q8
    from repro_torch.core.rns_linear import rns_chain_linear
    from repro_torch.models.layers import silu

    xa, wg, g = _chain_operands(dev, 512, 576, 1536, 12)
    wu = trt.encode(torch.randn(576, 1536, generator=g, device=dev) / 24,
                    xa.basis)
    wd = trt.encode(torch.randn(1536, 576, generator=g, device=dev) / 40,
                    xa.basis)
    outs = []
    for backend in ("pallas", "pallas_fused"):
        before = rns_modmul.launches
        gf = rns_chain_linear(xa, wg, backend=backend)
        up = rns_chain_linear(xa, wu, emit="residues", backend=backend)
        gq, sg = q8(silu(gf), dim=-1)
        outs.append(rns_chain_linear(up, wd, gate=gq, gate_scale=sg,
                                     backend=backend))
        assert rns_modmul.launches == before + (backend == "pallas")
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])



@pytest.mark.parametrize("mods,bound", [((47, 43, 41, 39, 37), 2**31 - 1),
                                        ((47, 43, 41, 39, 37, 35, 31),
                                         1536 * 46 * 46),
                                        ((1024, 47, 31), 2**31 - 1),
                                        ((2045, 2051, 2039, 2057, 1025, 3071),
                                         2**25)])
def test_fold_matches_plain(dev, mods, bound):
    g = torch.Generator(device=dev).manual_seed(len(mods))
    x = torch.randint(0, bound, (len(mods), 8 * 1536 + 3), generator=g,
                      device=dev, dtype=torch.int32)
    x[:, :2] = torch.tensor([0, bound - 1], dtype=torch.int32)
    before = fold.launches
    got = fold(x, mods, bound)
    torch.cuda.synchronize()
    assert fold.launches == before + 1
    assert torch.equal(got, ref.fold_ref(x, mods, bound))
    assert torch.equal(got.long(), x.long() % torch.tensor(
        mods, device=dev)[:, None])


@pytest.mark.parametrize("form", ["quantize", "residue_in", "gated"])
@pytest.mark.parametrize("M,K,N", [(8, 576, 960), (512, 1536, 576),
                                   (13, 64, 70), (512, 64, 192)] + TILE_MMA)
def test_crt_partial_matches_plain_and_composes(dev, form, M, K, N):
    """Every slice launch bit-equal to its plain version; the summed planes
    through crt_finish bit-equal to the fused kernel, for every n that
    divides C (slices of 1 to 7 channels)."""
    if form == "quantize":
        basis = basis_for_int8_matmul(K)
        g = torch.Generator(device=dev).manual_seed(M + K)
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        x[0, :2] = torch.tensor([40.0, -40.0])
        wt = trt.encode(torch.randn(K, N, generator=g, device=dev) / K ** .5)
        srow, gate, xin = quant_scale(x), None, x
        full = rns_fused_matmul(x, wt, scale_row=srow, scale_col=wt.scale)
    else:
        basis = basis_for_chain(K) if form == "gated" else \
            basis_for_int8_matmul(K)
        xin, wt, g = _chain_operands(dev, M, K, N, M + K, basis)
        gate = None
        srow = xin.scale
        if form == "gated":
            gate = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                                 dtype=torch.int8)
            srow = xin.scale * 0.5
        full = rns_fused_matmul(xin, wt, scale_row=srow, scale_col=wt.scale,
                                gate=gate)
    C = len(basis.moduli)
    for n in [n for n in range(1, C + 1) if C % n == 0]:
        kw = dict(scale_row=srow, gate=gate)
        before = rns_fused_crt_partial.launches
        with _rows(M, K, N):
            parts = channel_partials(xin, wt, n, **kw)
        torch.cuda.synchronize()
        assert rns_fused_crt_partial.launches == before + n
        for part, want in zip(parts, channel_partials(xin, wt, n, plain=True,
                                                      **kw)):
            assert torch.equal(part, want)
        with _rows(M, K, N):
            got = channel_sliced_matmul(xin, wt, n, scale_col=wt.scale,
                                        **kw)
        assert torch.equal(got, full)

FLASH_CASES = [
    # (B, H, Sq, Sk, D, causal, window, softcap, pad, explicit)
    (2, 3, 64, 64, 32, True, None, None, None, False),
    (2, 2, 100, 100, 16, True, 24, 50.0, None, False),
    (2, 2, 1, 100, 64, True, None, None, (0, 99), False),
    (1, 2, 100, 100, 64, False, None, None, None, False),
    (2, 2, 4, 100, 128, True, None, None, (3, 100), False),
    (2, 2, 48, 130, 64, True, 40, None, None, True),
    (3, 9, 257, 257, 64, True, None, None, (0, 17, 256), False),
]
# Every route at every head size, compiled (16-256) or padded to the next
# compiled one (8, 48): Sq 1, 4, 16 take the split route (its 1-, 4- and
# 16-row instances), Sq 17 the mma (bf16) or fma (float32) route; lane 1's
# pad leaves the last tile alone, so most cluster ranks have no key, and
# lane 2 is all padding.
FLASH_CASES += [(3, 2, Sq, Sk, D, True, None, None, (0, Sk - 10, Sk), False)
                for D in (8, 16, 32, 48, 64, 80, 96, 128, 256)
                for Sq in (1, 4, 16, 17) for Sk in (128, 2048, 4096)]
FLASH_CASES += [
    # decode with a window (and a softcap); the pad covers whole splits
    (2, 3, 1, 2048, 64, True, 300, None, (0, 1000), False),
    (2, 3, 1, 2048, 128, True, 700, 30.0, (5, 1500), False),
    # short query blocks with explicit positions, and non-causal
    (2, 2, 4, 300, 64, True, None, None, None, True),
    (2, 2, 9, 333, 32, False, None, None, (0, 200), False),
    # prefill with Sq, Sk and Sk - Sq no multiple of 64: the frontier tiles
    (2, 2, 100, 130, 16, True, None, None, (0, 7), False),
    (2, 2, 100, 130, 32, True, 50, None, (0, 70), False),
    (2, 2, 100, 130, 128, True, None, 50.0, (0, 129), False),
    (2, 2, 70, 70, 128, False, None, None, None, False),
]


def _flash_case(dev, case, dtype):
    B, H, Sq, Sk, D, causal, window, cap, pad, explicit = case
    g = torch.Generator(device=dev).manual_seed(Sq * Sk + D)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
               for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, window=window, softcap=cap)
    if pad is not None:
        kw["pad"] = torch.tensor(pad, dtype=torch.int32, device=dev)
    if explicit:
        qp = torch.arange(Sq, device=dev, dtype=torch.int32) + (Sk - Sq)
        kp = torch.arange(Sk, device=dev, dtype=torch.int32).repeat(B, 1)
        qp = qp.repeat(B, 1)
        qp[0, :5] = -1
        kp[0, 7:30] = -1
        kp[-1, :] = torch.randperm(Sk, generator=g, device=dev).int()
        kw.update(qpos=qp, kpos=kp)
    return q, k, v, kw


def _flash_close(got, want, dtype):
    # the plain version computes in float32 too: bf16 outputs agree to one
    # bf16 ulp (2^-7 relative) of the output, float32 ones to 2e-5
    rtol, atol = (2.0**-7, 1e-3) if dtype == torch.bfloat16 else (0.0, 2e-5)
    assert ((got.double() - want.double()).abs()
            <= rtol * want.double().abs() + atol).all()


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matches_plain(dev, case, dtype):
    B, H, Sq, Sk, D = case[:5]
    q, k, v, kw = _flash_case(dev, case, dtype)
    route = flash_route(Sq, dtype, D)
    before = flash_attention.launches
    routes = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.route_launches[route] == routes[route] + 1
    assert got.dtype == dtype and got.shape == q.shape
    _flash_close(got, want, dtype)
    dead = ~ref.attention_mask(B, Sq, Sk, device=dev, **{
        k_: kw.get(k_) for k_ in ("causal", "window", "pad", "qpos",
                                  "kpos")}).any(-1)
    assert (got[dead[:, None].expand(-1, H, -1)] == 0).all()


# the zoo's head sizes on their models' masks: gemma2-2b (256, window
# 4096, softcap 50), h2o-danube (80, window 4096), phi-3-vision (96), the
# yi-34b smoke twin (8, padded to 16)
FLASH_ZOO_CASES = [
    (2, 4, 1, 5000, 256, True, 4096, 50.0, (0, 900), False),
    (2, 4, 300, 300, 256, True, 128, 50.0, (0, 37), False),
    (2, 4, 12, 700, 256, True, None, None, (0, 5), False),
    (2, 4, 1, 5000, 80, True, 4096, None, (0, 900), False),
    (2, 4, 300, 300, 80, True, 128, None, (0, 37), False),
    (2, 4, 7, 500, 96, True, None, None, None, True),
    (2, 4, 300, 300, 96, True, None, None, (0, 37), False),
    (2, 4, 1, 300, 8, True, None, None, (0, 50), False),
    (2, 4, 300, 300, 8, True, None, None, (0, 37), False),
]


@pytest.mark.parametrize("case", FLASH_ZOO_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_zoo_head_sizes(dev, case, dtype):
    test_flash_matches_plain(dev, case, dtype)


def test_flash_refuses_only_above_256(dev):
    """No head size is refused any more: above 256 the wide route runs
    (D = 264 padded to 384), at and below it the compiled routes."""
    before = flash_attention.route_launches["wide"]
    for D in (1, 8, 200, 256, 264):
        q = torch.randn(1, 2, 4, D, device=dev)
        _flash_close(flash_attention(q, q, q), ref.attention_ref(q, q, q),
                     torch.float32)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["wide"] == before + 1


# the wide route (D > 256, padded to a multiple of 128): decode, short
# query blocks and prefill, every mask, D on and off the chunk
FLASH_WIDE_CASES = [
    (2, 3, Sq, Sk, D, True, None, None, (0, Sk - 10), False)
    for D in (320, 384, 512) for Sq, Sk in ((1, 2048), (16, 300),
                                            (17, 300), (100, 130))]
FLASH_WIDE_CASES += [
    (2, 2, 1, 2048, 512, True, 700, 30.0, (5, 1500), False),
    (2, 2, 300, 300, 512, True, 128, 50.0, (0, 37), False),
    (2, 2, 48, 130, 512, True, 40, None, None, True),
    (1, 2, 70, 70, 1000, False, None, None, None, False),
    (3, 2, 17, 128, 512, True, None, None, (0, 118, 128), False),
]


@pytest.mark.parametrize("case", FLASH_WIDE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_matches_plain(dev, case, dtype):
    assert flash_route(case[2], dtype, case[4]) == "wide"
    test_flash_matches_plain(dev, case, dtype)


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (1, 5, 6)]
                         + [FLASH_CASES[-3]] + FLASH_ZOO_CASES[1::3])
def test_flash_fma_route_pinned_bf16(dev, case):
    """bf16 prefill pinned to the CUDA-core route (the "before" that
    chip_smoke.py times in turns with the mma route) stays within the
    bf16 tolerance, one launch on that route."""
    q, k, v, kw = _flash_case(dev, case, torch.bfloat16)
    before = flash_attention.route_launches["fma"]
    with _pin_route("fma"):
        got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["fma"] == before + 1
    _flash_close(got, ref.attention_ref(q, k, v, **kw), torch.bfloat16)


def test_flash_decode_captures(dev):
    """A decode call (8 lanes, 9 heads, 2048 keys, ragged pad, the split
    route as one cluster launch) captured in a CUDA graph and replayed on
    new inputs copied into the captured buffers: bit-equal to the same call
    made eagerly, and within tolerance of the plain version."""
    B, H, Sk, D = 8, 9, 2048, 64
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.empty(B, H, S, D, device=dev, dtype=torch.bfloat16)
               for S in (1, Sk, Sk))
    pad = torch.tensor([0, 1, 17, 512, 1024, 2047, 2048, 5],
                       dtype=torch.int32, device=dev)

    def fill():
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=g, device=dev))

    fill()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention(q, k, v, pad=pad)     # build, shared memory limit
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = flash_attention.route_launches["split"]
    with torch.cuda.graph(graph):
        out = flash_attention(q, k, v, pad=pad)
    assert flash_attention.route_launches["split"] == before + 1
    for _ in range(2):
        fill()
        graph.replay()
        torch.cuda.synchronize()
        eager = flash_attention(q, k, v, pad=pad)
        assert torch.equal(out, eager)
        _flash_close(out, ref.attention_ref(q, k, v, pad=pad),
                     torch.bfloat16)
        assert (out[6] == 0).all()


@pytest.mark.parametrize("S", [8 * 1536 + 1, 8 * 1536 + 2, 4097, 7, 1])
@pytest.mark.parametrize("layout", ["fresh", "row-slice", "offset"])
def test_fold_ragged_and_unaligned(dev, S, layout):
    """Rows of S % 4 = 1, 2 or 3 values (ragged heads and tails), and
    inputs that start off a 16-byte boundary: the rows of a larger
    tensor after its first (row-slice), or a flat buffer read from its
    second value (offset).  Bit-equal to the plain version, one launch."""
    mods, bound = (47, 43, 41, 39, 37), 1536 * 46 * 46
    C = len(mods)
    g = torch.Generator(device=dev).manual_seed(S)
    big = torch.randint(0, bound, (C + 1, S), generator=g, device=dev,
                        dtype=torch.int32)
    x = {"fresh": big[:C].clone(), "row-slice": big[1:],
         "offset": big.reshape(-1)[1:1 + C * S].view(C, S)}[layout]
    assert x.is_contiguous()
    before = fold.launches
    got = fold(x, mods, bound)
    torch.cuda.synchronize()
    assert fold.launches == before + 1
    assert torch.equal(got, ref.fold_ref(x, mods, bound))


FWD_TYPES = [(torch.int8, torch.int8), (torch.int8, torch.int32),
             (torch.int32, torch.int8), (torch.int32, torch.int32)]


def _vector_size(V):
    """The least length the kernels take in V-element vectors (a warp of
    them for every SM, `rns_convert.vectors`); shorter ones run one
    element a thread."""
    return 32 * V * torch.cuda.get_device_properties(0).multi_processor_count


def _forward_same(x, mods, dtype):
    before = rns_forward.launches
    got = rns_forward(x, mods, dtype=dtype)
    torch.cuda.synchronize()
    assert rns_forward.launches == before + (x.numel() > 0)
    assert got.dtype == dtype
    assert torch.equal(got, ref.rns_forward_ref(x, mods, dtype))


@pytest.mark.parametrize("itype,otype", FWD_TYPES)
def test_forward_ragged_and_misaligned(dev, itype, otype):
    """Every length 0-33 (one element a thread), lengths at the vector
    body (16-value vectors, their scalar tail with int32 residues, and
    planes off the 16-byte boundary, which take one element a thread),
    each fresh and starting 1 or 3 elements off a 16-byte boundary; the
    type's extremes (INT32_MIN, INT32_MAX, -128) among the values."""
    mods = basis_for_int8_matmul(576).moduli
    for S in range(34):
        _forward_same(cc.forward_values(S, itype, S, device=dev), mods, otype)
    big = _vector_size(16)
    for S in (big, big + 1, big + 4, 8 * 576):
        for off in (0, 1, 3):
            _forward_same(cc.forward_values(S, itype, S + off, off, dev),
                          mods, otype)


@pytest.mark.parametrize("C", range(1, 13))
@pytest.mark.parametrize("itype,otype", FWD_TYPES)
def test_forward_every_channel_count(dev, C, itype, otype):
    for S in (8 * 576, _vector_size(16) + 16):
        x = cc.forward_values(S, itype, C, device=dev)
        _forward_same(x.reshape(8, -1), cc.SMALL_MODULI[:C], otype)


@pytest.mark.parametrize("itype", [torch.int8, torch.int32])
@pytest.mark.parametrize("S", [33, 12 * 1536, "vectors"])
def test_forward_large_moduli(dev, itype, S):
    """Moduli 2, 64, 2^15 + 3 and 2^31 - 1 with int32 residues: the
    reciprocal's quotient estimate at its extremes."""
    S = _vector_size(16) if S == "vectors" else S
    for off, mods in ((0, cc.LARGE_MODULI), (1, cc.LARGE_MODULI[::-1])):
        _forward_same(cc.forward_values(S, itype, S, off, dev), mods,
                      torch.int32)


def _reverse_same(r, conv, scale):
    before = rns_reverse.launches
    got = rns_reverse(r, conv, scale=scale)
    torch.cuda.synchronize()
    assert rns_reverse.launches == before + (got.numel() > 0)
    assert torch.equal(got, ref.rns_reverse_ref(r, conv, scale))


def _scales(shape, seed, device):
    """Scales that broadcast against an (M, N) output: full, per row, per
    column, one value."""
    g = torch.Generator(device=device).manual_seed(seed)
    M, N = shape
    return [torch.rand(s, generator=g, device=device)
            for s in ((M, N), (M, 1), (N,), ())]


@pytest.mark.parametrize("C,L", sorted(REVERSE_INSTANCES))
def test_reverse_every_instance(dev, C, L):
    """Each (C, L) instance of the kernel, on a basis whose plan has those
    counts: (8, 192) and ragged (13, 70) outputs (one element a thread)
    and one that the 4-element vectors take, without a scale and with
    each of four broadcast scales; the signed range's corners among the
    values."""
    basis = cc.basis_with_limbs(C, L)
    conv = ConversionPlan.for_basis(basis)
    assert (conv.k, conv.nlimbs) == (C, L)
    for shape in ((8, 192), (13, 70), (-(-_vector_size(4) // 192), 192)):
        r = cc.edge_residues(basis, shape, C * 8 + L, dev)
        for sc in [None] + _scales(shape, L, dev):
            _reverse_same(r, conv, sc)


def test_reverse_ragged_and_misaligned(dev):
    """Every length 0-33, lengths at the vector body (4-element vectors
    and their scalar tail), and residue planes that start 1 or 2 elements
    off a 16-byte boundary (with a scale off it too)."""
    basis = basis_for_int8_matmul(576)
    conv = ConversionPlan.for_basis(basis)
    for S in range(34):
        r = cc.edge_residues(basis, (S,), S, dev)
        _reverse_same(r, conv, None)
        _reverse_same(r, conv, torch.rand(S, device=dev))
    big = _vector_size(4)
    for S in (big, big + 1, big + 2, big + 3, 1538):
        r = cc.edge_residues(basis, (S,), S, dev)
        _reverse_same(r, conv, None)
        _reverse_same(r, conv, torch.rand(S, device=dev))
        _reverse_same(r, conv, torch.rand(S + 1, device=dev)[1:])
        r = cc.edge_residues(basis, (S,), S, dev)
        big = torch.empty(5 * S + 3, dtype=torch.int32, device=dev)
        for off in (1, 2):
            view = big[off:off + 5 * S].view(5, S)
            view.copy_(r)
            _reverse_same(view, conv, None)
            _reverse_same(view, conv, torch.rand(S + 1, device=dev)[1:])


def test_staged_layer_conversions_capture(dev):
    """One staged layer's conversions at decode (M = 8): the 7 weight
    conversions and the 7 reverses of the broadcast products, captured in
    one CUDA graph (counters +7 and +7) and replayed on new inputs copied
    into the captured buffers: each replay bit-equal to eager calls."""
    shapes = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536),
              (576, 1536), (1536, 576)]
    g = torch.Generator(device=dev).manual_seed(18)
    ws = [torch.empty(K, N, dtype=torch.int8, device=dev)
          for K, N in shapes]
    convs = [ConversionPlan.for_basis(basis_for_int8_matmul(K))
             for K, _ in shapes]
    rs = [torch.empty(c.k, 8 * N, dtype=torch.int32, device=dev)
          for c, (_, N) in zip(convs, shapes)]

    def fill():
        for w in ws:
            w.copy_(torch.randint(-128, 128, w.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        for r, c in zip(rs, convs):
            r.copy_(torch.stack([torch.randint(0, m, r.shape[1:],
                                               generator=g, device=dev,
                                               dtype=torch.int32)
                                 for m in c.moduli]))

    def run():
        return ([rns_forward(w, c.moduli, dtype=torch.int8)
                 for w, c in zip(ws, convs)],
                [rns_reverse(r, c) for r, c in zip(rs, convs)])

    fill()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (rns_forward.launches, rns_reverse.launches)
    with torch.cuda.graph(graph):
        fwd, rev = run()
    assert (rns_forward.launches, rns_reverse.launches) == (
        before[0] + 7, before[1] + 7)
    for _ in range(2):
        fill()
        graph.replay()
        torch.cuda.synchronize()
        eager_fwd, eager_rev = run()
        for got, want in zip(fwd + rev, eager_fwd + eager_rev):
            assert torch.equal(got, want)
        for got, w, c in zip(fwd, ws, convs):
            assert torch.equal(got, ref.rns_forward_ref(w, c.moduli,
                                                        torch.int8))


@pytest.mark.parametrize("name", ["rns-smollm-135m-fused",
                                  "rns-smollm-135m-resident",
                                  "rns-smollm-135m-pallas"])
def test_engine_scan_replays_captured_step(dev, name, monkeypatch):
    """The smoke model's decode step captured once through the engine's
    scan path and replayed: greedy and sampled tokens equal to the host
    loop's for the same seed, one capture per (lanes, smax, sampled) and
    one replay a new token after the first; once captured, the scan path
    runs no Python decode step (decode_step made to raise)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = get_smoke_config(name)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    eng = E.Engine(cfg, params, smax=64, lanes=4, device=dev)
    prompts = [[5, 6, 7], list(range(1, 12)), [9] * 14]
    host = eng.generate(prompts, 8, engine="host")
    assert eng.generate(prompts, 8, engine="scan") == host
    assert (eng.scan_captures, eng.scan_replays) == (1, 7)
    for temp, seed in ((0.8, 3), (1.3, 4)):
        want = eng.generate(prompts, 8, temperature=temp, seed=seed,
                            engine="host")
        assert eng.generate(prompts, 8, temperature=temp, seed=seed) == want
    assert (eng.scan_captures, eng.scan_replays) == (2, 21)

    def no_decode(*a, **k):
        raise AssertionError("the scan path ran a Python decode step")

    monkeypatch.setattr(E.T, "decode_step", no_decode)
    assert eng.generate(prompts, 8, engine="scan") == host
    assert eng.generate([prompts[1]], 8, engine="scan")[0] == host[1]
    assert eng.generate(prompts, 1, engine="scan") == [p + h[len(p):][:1]
                                                       for p, h in
                                                       zip(prompts, host)]
    assert (eng.scan_captures, eng.scan_replays) == (2, 35)


def _step_launch_counts():
    from repro_torch.kernels import rns_forward, rns_fused_matmul

    return (rns_fused_matmul.launches, rns_fused_matmul.residue_in_launches,
            rns_forward.launches)


@pytest.mark.parametrize("name", ["smollm-135m", "rns-smollm-135m-fused",
                                  "rns-smollm-135m-resident"])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_scheduler_replays_captured_paged_step(dev, name, temperature,
                                               monkeypatch):
    """The smoke model served by `SlotScheduler` on the card: one paged
    step captured (the warm-up's and the capture's RNS launches equal to
    one eager step's: 7 fused a layer; 5 fused, 4 of them residue-in, and
    2 `rns_forward` resident; none for bf16), one replay a step of every
    chunk; greedy and sampled outputs equal to the engine's solo generate
    under staggered arrivals; tokens and pool equal to the same serve run
    eagerly on the card (the trash block aside); once captured, no Python
    decode step runs."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, SlotScheduler
    from repro_torch.serve import scheduler as S

    cfg = get_smoke_config(name)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    kw = dict(slots=2, block_size=4, slot_tokens=24, decode_chunk=2,
              temperature=temperature, device=dev)
    sched = SlotScheduler(cfg, params, **kw)
    prompts = [[5, 6, 7], list(range(1, 10)), [9] * 6, list(range(3, 14))]
    news, seeds, arrivals = [8, 3, 6, 4], [3, 4, 3, 8], [0, 0, 3, 5]
    reqs = [Request(p, m, seed=s, arrival=a)
            for p, m, s, a in zip(prompts, news, seeds, arrivals)]
    solo = [sched.engine.generate([p], m, temperature=temperature,
                                  seed=s)[0]
            for p, m, s in zip(prompts, news, seeds)]

    counts = []
    step = sched._step

    def counted_step():
        before = _step_launch_counts()
        step()
        counts.append(tuple(a - b for a, b in
                            zip(_step_launch_counts(), before)))

    sched._step = counted_step
    out = sched.serve(reqs)
    del sched._step
    L = cfg.num_layers
    one = {"smollm-135m": (0, 0, 0), "rns-smollm-135m-fused": (7 * L, 0, 0),
           "rns-smollm-135m-resident": (5 * L, 4 * L, 2 * L)}[name]
    assert counts == [one, one]
    assert sched.chunk_captures == 1
    assert sched.chunk_replays == 2 * sched.stats["chunks"]
    assert out == solo

    eager = SlotScheduler(cfg, params, **kw)
    monkeypatch.setattr(eager, "_capture", lambda: None)
    assert eager.serve(reqs) == out
    assert eager.chunk_replays == 0
    for k in ("k", "v"):       # block 0, the trash, takes racing writes
        assert torch.equal(eager._cache["sub0"][k][:, 1:],
                           sched._cache["sub0"][k][:, 1:])

    def no_decode(*a, **k):
        raise AssertionError("the scheduler ran a Python decode step")

    monkeypatch.setattr(S.T, "decode_step", no_decode)
    assert sched.serve(reqs) == out
    assert sched.chunk_captures == 1


# ------------------------------------------------------------- the tuner --
@pytest.mark.parametrize("C", range(1, 12))
def test_smem_footprint_mirror_equals_library(dev, C):
    """`tune.smem_footprint` (the admissibility pass's number) equals the
    library's `rns_tile16_smem` for every A mode and weight form."""
    lib = _build.library()
    for amode in (tile.A_F32, tile.A_BF16, tile.A_SHARED, tile.A_PLANES):
        for enc in (0, 1):
            assert tune.smem_footprint(tile.TM, C, amode=amode,
                                       encoded=bool(enc)) == \
                lib.rns_tile16_smem(amode, C, enc), (amode, enc)


SERVED_FORMS = ["fused-wq", "fused-wdown", "fused-wk", "resident-qkv",
                "resident-gate", "resident-up", "resident-down",
                "staged-matmul"]


@pytest.mark.parametrize("form", SERVED_FORMS)
@pytest.mark.parametrize("M", [8, 512])
def test_tuned_equals_static_on_served_shapes(dev, form, M):
    """The tuner's (tm, splits) (the committed table's row at decode, a
    sweep at first use at prefill) and the static rule give the same bits
    at every served launch shape of the three paths."""
    d, F, qkv = 576, 1536, 960
    g = torch.Generator(device=dev).manual_seed(M + len(form))
    path, leaf = form.split("-")
    K, N = {"wq": (d, d), "wdown": (F, d), "wk": (d, 192), "qkv": (d, qkv),
            "gate": (d, F), "up": (d, F), "down": (F, d),
            "matmul": (d, d)}[leaf]
    if path == "resident":
        basis = basis_for_int8_matmul(d) if leaf == "qkv" else \
            basis_for_chain(F)
        xa, wt, g = _chain_operands(dev, M, K, N, M + len(form), basis)
        gate = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                             dtype=torch.int8) if leaf == "down" else None
        emit = "residues" if leaf == "up" else "float"

        def run():
            out = rns_fused_matmul(xa, wt, scale_row=xa.scale,
                                   scale_col=wt.scale, gate=gate, emit=emit)
            return out.residues if emit == "residues" else out
    else:
        w8 = trt.encode(torch.randn(K, N, generator=g, device=dev)
                        / K ** 0.5)
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        if path == "staged":
            q, _ = quantize_int8(x, dim=-1)

            def run():
                return rns_matmul(q[None], w8.residues, w8.moduli,
                                  signed_a=True)
        else:
            def run():
                return rns_fused_matmul(x, w8, scale_row=quant_scale(x),
                                        scale_col=w8.scale)
    before = sum(tile.tile_launches.values())
    tuned = run()
    with tune.static_rule():
        static = run()
    torch.cuda.synchronize()
    assert sum(tile.tile_launches.values()) == before + 2
    assert torch.equal(tuned, static)


@pytest.mark.parametrize("name", ["rns-smollm-135m", "rns-smollm-135m-fused",
                                  "rns-smollm-135m-resident",
                                  "rns-smollm-135m-pallas"])
def test_graph_kernel_nodes_equal_counted_step(dev, name):
    """The captured decode step's kernel nodes, read from the graph by
    function name (`_build.graph_kernels`), equal the launches the
    wrappers counted for that step; the engine's warmed decode shapes are
    all table hits, so its init swept nothing."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    counters = {"rns_tile_kernel": (rns_fused_matmul, rns_matmul),
                "rns_forward_kernel": (rns_forward,),
                "rns_reverse_kernel": (rns_reverse,),
                "rns_modmul_kernel": (rns_modmul,)}
    cfg = get_smoke_config(name)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    sweeps = tune.stats["sweeps"]
    eng = E.Engine(cfg, params, smax=32, lanes=2, device=dev)
    assert eng.tune_report and all(r["hit"] for r in eng.tune_report)
    assert tune.stats["sweeps"] == sweeps
    counted = []
    step = eng._step

    def counted_step(st):
        before = {k: sum(f.launches for f in fs)
                  for k, fs in counters.items()}
        step(st)
        counted.append({k: sum(f.launches for f in fs) - before[k]
                        for k, fs in counters.items()})

    eng._step = counted_step
    misses = tune.stats["capture_misses"]
    eng.generate([[5, 6, 7], [1, 2]], 4, engine="scan")
    del eng._step
    assert tune.stats["capture_misses"] == misses
    assert len(counted) == 2 and counted[0] == counted[1]
    graph = eng._scan[(2, 32, False)].graph
    nodes = _build.graph_kernels(graph)
    seen = {k: sum(c for n, c in nodes.items() if k in n)
            for k in counters}
    assert seen == counted[1]
    assert seen["rns_tile_kernel"] == 7 * cfg.num_layers - (
        2 * cfg.num_layers if cfg.linear_domain == "residue" else 0)


FAMILIES = ["h2o-danube-1.8b", "gemma2-2b", "hymba-1.5b", "mamba2-1.3b",
            "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
            "musicgen-large", "yi-34b"]


@pytest.mark.parametrize("name", FAMILIES + ["hymba-fused"])
def test_family_captured_step_equals_eager(dev, name):
    """Each family's smoke decode step captured by the scan engine and
    replayed: greedy tokens equal to the host loop's (rings wrap: 40 new
    tokens past a window of 8), one capture and one replay a token; the
    captured graph's port-kernel nodes equal one eager step's counted
    launches (hymba on the fused RNS datapath launches the tile kernel,
    the bf16 stacks none)."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = get_smoke_config(name.replace("-fused", "-1.5b"))
    if name == "hymba-fused":
        cfg = dataclasses.replace(cfg, linear_backend="rns_int8:pallas_fused",
                                  encode_weights=True)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    eng = E.Engine(cfg, params, smax=64, lanes=4, device=dev)
    prompts = [[5, 6, 7], list(range(1, 12)), [9] * 14]
    counted = []
    step = eng._step

    def counted_step(st):
        before = rns_fused_matmul.launches
        step(st)
        counted.append(rns_fused_matmul.launches - before)

    eng._step = counted_step
    scan = eng.generate(prompts, 40, engine="scan")
    del eng._step
    assert scan == eng.generate(prompts, 40, engine="host")
    assert (eng.scan_captures, eng.scan_replays) == (1, 39)
    assert len(counted) == 2 and counted[0] == counted[1]
    graph = next(iter(eng._scan.values())).graph
    nodes = _build.graph_kernels(graph)
    assert sum(c for n, c in nodes.items() if "rns_tile_kernel" in n) == \
        counted[1]
    if name == "hymba-fused":
        assert counted[1] == 7 * cfg.num_layers
    else:
        assert counted[1] == 0


def test_moe_combine_deterministic_across_replays(dev):
    """The MoE block captured in a CUDA graph: two replays give the same
    bits, equal to an eager call (the combine sums each token's picks in
    order, no atomics; the dispatch writes one slot a kept pick)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as M

    cfg = get_config("moonshot-v1-16b-a3b")
    params = M.make_moe_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    x = torch.randn((8, 64, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(torch.bfloat16)
    out = {}

    def run():
        out["y"], out["aux"] = M.moe_apply(params, x, cfg)

    eager = M.moe_apply(params, x, cfg)[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    results = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        results.append(out["y"].clone())
    assert torch.equal(results[0], results[1])
    assert torch.equal(results[0], eager)


# the training path of rns-smollm-135m-fused (B 8 × S 256 = 2048 rows): the
# live raw-int8 form of the fused launch at each linear's (K, N)
TRAIN_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


@pytest.mark.parametrize("K,N", TRAIN_SHAPES)
def test_training_shapes_match_plain(dev, K, N):
    g = torch.Generator(device=dev).manual_seed(K + N)
    x = torch.randn(2048, K, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    wq, sw = quantize_int8(w, dim=0)
    sx = quant_scale(x)
    basis = basis_for_int8_matmul(K)
    before = rns_fused_matmul.launches
    got = rns_fused_matmul(x, wq, basis, scale_row=sx, scale_col=sw)
    again = rns_fused_matmul(x, wq, basis, scale_row=sx, scale_col=sw)
    want = ref.rns_fused_matmul_ref(x, wq, basis, scale_row=sx,
                                    scale_col=sw)
    torch.cuda.synchronize()
    assert rns_fused_matmul.launches == before + 2
    assert torch.equal(got, want) and torch.equal(again, got)


def test_ste_on_the_card(dev):
    """`rns_dense`'s output on the card comes from the Function (its node
    is the estimator's), one launch; the live gradients are the dense
    float32 matmul's; the encoded gx is bit-equal to the gradient through
    x @ ŵ, ŵ from the plain reverse."""
    from repro_torch.core.rns_linear import rns_dense

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(256, 576, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(576, 192, generator=g, device=dev) / 24).to(
        torch.bfloat16)
    c = torch.randn(256, 192, generator=g, device=dev).to(torch.bfloat16)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = rns_fused_matmul.launches
    y = rns_dense(xg, wg, "pallas_fused")
    assert rns_fused_matmul.launches == before + 1
    assert type(y.grad_fn).__name__ == "_DenseSTEBackward"
    (y * c).float().sum().backward()
    c32 = c.float()
    assert torch.equal(xg.grad, (c32 @ w.float().T).to(torch.bfloat16))
    assert torch.equal(wg.grad, (x.float().T @ c32).to(torch.bfloat16))
    wt = trt.encode(w.float())
    xe = x.float().requires_grad_()
    ce = c.float()
    y = rns_dense(xe, wt, "pallas_fused")
    assert type(y.grad_fn).__name__ == "_EncodedSTEBackward"
    (y * ce).sum().backward()
    w_hat = ConversionPlan.for_basis(wt.basis).reverse_plain(wt.residues) \
        * wt.scale
    xr = x.float().requires_grad_()
    ((xr @ w_hat) * ce).sum().backward()
    assert torch.equal(xe.grad, xr.grad)


def test_embed_rows_backward_deterministic(dev):
    """The embedding lookup's backward sums each id's rows with no atomics:
    two backward passes give the same bits, within float64 rounding of
    the exact sums (ids with many repeats, bf16 table)."""
    from repro_torch.models.layers import embed_rows

    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn(49152, 576, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()
    ids = torch.randint(0, 256, (8, 256), generator=g, device=dev)
    gy = torch.randn(8, 256, 576, generator=g, device=dev).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        table.grad = None
        (embed_rows(table, ids).float() * gy.float()).sum().backward()
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros(49152, 576, dtype=torch.float64, device=dev)
    want.index_add_(0, ids.reshape(-1), gy.reshape(-1, 576).double())
    assert torch.equal(grads[0], want.to(torch.bfloat16))


def _smoke_grads(name, dev, pol="full"):
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models import transformer as T
    from repro_torch.train import trainstep as TS
    from repro_torch.train.tree import leaves

    cfg = dataclasses.replace(get_smoke_config(name), remat_policy=pol)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    b = batch_for_step(0, 0, 4, 64, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    loss, _, grads = TS._value_and_grad(cfg, params, batch)
    return loss, leaves(grads)


def test_train_step_fused_equals_staged_and_repeats(dev):
    """One smoke train step on the card: the fused and the staged datapath
    give the same loss and gradients bit for bit (both forwards obey the
    parity contract, the backward is the same), a second run the same
    bits, and each remat policy the same bits."""
    loss, grads = _smoke_grads("rns-smollm-135m-fused", dev)
    for name, pol in (("rns-smollm-135m-pallas", "full"),
                      ("rns-smollm-135m-fused", "full"),
                      ("rns-smollm-135m-fused", "save_ar"),
                      ("rns-smollm-135m-fused", "none")):
        l2, g2 = _smoke_grads(name, dev, pol)
        assert torch.equal(loss, l2), (name, pol)
        assert all(torch.equal(a, b) for a, b in zip(grads, g2)), (name, pol)


RESIDENCY_CONFIGS = ["rns-smollm-135m-fused", "rns-smollm-135m-resident",
                     "rns-smollm-135m-pallas"]


@pytest.mark.parametrize("name", RESIDENCY_CONFIGS)
def test_residency_counts_on_the_card(dev, name):
    """The residency pass on the card, at smoke size: an eager prefill and
    decode step call exactly `residency.expected_*`, each call one launch
    (the launch counters move as much), the step syncs nothing to the
    host, and the resident path runs no remainder outside a kernel."""
    from repro_torch.analysis import residency as R
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = get_smoke_config(name)
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    eng = E.Engine(cfg, params, smax=32, lanes=2, device=dev)
    batch, plen = eng._pack([[1, 2, 3], [4, 5]])
    tok = torch.ones((2, 1), dtype=torch.int32, device=dev)
    launched = [rns_fused_matmul.launches, rns_forward.launches,
                rns_matmul.launches, rns_reverse.launches]
    with torch.inference_mode(), R.TraceMode() as mode:
        _, cache, _ = T.prefill(cfg, eng.params, batch, eng.smax)
    pre = mode.summary
    with torch.inference_mode(), R.TraceMode() as mode:
        T.decode_step(cfg, eng.params, cache, {"tokens": tok}, plen,
                      positions=plen - batch["pad"])
    torch.cuda.synchronize()
    dec = mode.summary
    assert dict(pre.kernel_calls) == R.kernel_calls(R.expected_prefill(cfg))
    assert dict(dec.kernel_calls) == R.kernel_calls(R.expected_step(cfg))
    moved = [rns_fused_matmul.launches, rns_forward.launches,
             rns_matmul.launches, rns_reverse.launches]
    assert sum(moved) - sum(launched) == pre.kernel_total + dec.kernel_total
    assert R.check_no_callbacks(dec).ok, dict(dec.syncs)
    # the kernels ran as ctypes launches: no aten op inside a region but
    # the wrappers' own allocations and views
    assert dec.inside.get("aten.remainder", 0) == 0
    if cfg.linear_spec.domain == "residue":
        assert R.check_resident(dec).ok and R.check_resident(pre).ok


def test_residency_train_step_on_the_card(dev):
    """A smoke train step on the card: the forward's and the backward's
    recompute (run on autograd's device thread) both reach the trace."""
    from repro_torch.analysis import residency as R
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainstep as TS

    cfg = get_smoke_config("rns-smollm-135m-fused")
    params = T.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = O.make_optimizer(cfg, total_steps=10)
    b = batch_for_step(0, 0, 4, 64, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    step = TS.make_train_step(cfg, opt)
    with R.TraceMode() as mode:
        step(params, opt.init(params), batch, 0)
    torch.cuda.synchronize()
    assert dict(mode.summary.kernel_calls) == \
        R.kernel_calls(R.expected_train_step(cfg)) == \
        {"rns_fused_matmul": 28}


def test_host_syncs_on_the_card_are_flagged(dev):
    from repro_torch.analysis import residency as R

    x = torch.arange(8.0, device=dev)
    summ = R.summarize_fn(lambda t: (t.sum().item(), t.cpu(),
                                     torch.nonzero(t > 3)), x)
    assert dict(summ.syncs) == {"aten._local_scalar_dense": 1,
                                R.TO_HOST: 1, "aten.nonzero": 1}
    clean = R.summarize_fn(lambda t: t * 2 + 1, x)
    assert not clean.syncs
