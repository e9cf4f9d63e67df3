"""How the tile kernel's launcher picks its tile height and splits K into
thread-block clusters, on the CPU.

`kernels.rns_fused.launch_tile` is the one launcher behind
`rns_fused_matmul`, `rns_fused_crt_partial` and `rns_matmul`.  Launches
of more than 16 rows in a basis of at most 7 channels (prefill) take the
32-row tensor-core tile when it has a tile for every SM, the rest
(decode, wide bases, narrow launches) the 16-row one.
The launcher is driven here against a stand-in for the kernel library
that records the argument struct it is handed; the kernels themselves
are held against their plain versions on the card
(`tests/test_torch_cuda.py`).
"""
import ctypes
import dataclasses

import pytest
import torch

from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.kernels import _build
from repro_torch.kernels import rns_fused as tile

SMS = 132                      # an H100's SMs


@pytest.mark.parametrize("M,N,C,rows", [
    (1, 576, 5, 16), (8, 576, 5, 16), (8, 1536, 7, 16),   # decode lanes
    (16, 1536, 7, 16),
    (512, 576, 5, 32), (512, 960, 5, 32), (512, 1536, 7, 32),  # prefill
    (512, 576, 1, 32), (512, 576, 2, 32),              # CRT slices
    (512, 192, 5, 16), (64, 1536, 5, 16), (17, 200, 5, 16),  # < 132 tiles
    (512, 576, 8, 16), (512, 1536, 11, 16), (8, 576, 9, 16)])  # 8+ channels
def test_tile_rows(M, N, C, rows):
    assert tile.tile_rows(M, N, C, SMS) == rows
    # odd shapes (N or K not a multiple of 4, unaligned rows) stay on 16
    assert tile.tile_rows(M, N, C, SMS, vec=False) == tile.TM


def test_tile_rows_at_serving_shapes():
    """One smollm layer's launches: at decode (8 lanes) all on the 16-row
    tile; at prefill (8 lanes x 64) the 32-row tile except the two
    192-wide projections; 8 channels (a 65536-deep chain) never take it."""
    lanes, prefill = 8, 8 * 64
    layer = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536),
             (576, 1536), (1536, 576), (576, 960)]
    for basis_of in (basis_for_int8_matmul, basis_for_chain):
        for K, N in layer:
            C = len(basis_of(K).moduli)
            assert tile.tile_rows(lanes, N, C, SMS) == tile.TM
            assert tile.tile_rows(prefill, N, C, SMS) == (
                tile.TM if N == 192 else tile.TM_MMA)
    assert tile.tile_rows(prefill, 1536, len(basis_for_chain(65536).moduli),
                          SMS) == tile.TM


def test_pin_tile_rows():
    with tile._pin_tile_rows(tile.TM):
        assert tile.tile_rows(512, 576, 5, SMS) == tile.TM
        with tile._pin_tile_rows(tile.TM_MMA):
            assert tile.tile_rows(8, 192, 5, SMS) == tile.TM_MMA
        assert tile.tile_rows(512, 576, 5, SMS) == tile.TM
    assert tile.tile_rows(512, 576, 5, SMS) == tile.TM_MMA
    with tile._pin_tile_rows(tile.TM_WG):
        assert tile.tile_rows(512, 576, 5, SMS) == tile.TM_WG
    with pytest.raises(ValueError, match="not compiled"):
        with tile._pin_tile_rows(48):
            pass


@pytest.mark.parametrize("M,K,N,tm,want", [
    # decode: 24 column tiles, K split into clusters of 6 blocks of three
    # K steps (at most 8 blocks, at least one step each); 9 tiles
    (8, 576, 1536, 16, (6, 96)),
    (8, 1536, 576, 16, (8, 192)),
    (8, 576, 576, 16, (6, 96)),
    # prefill's 192-wide launches: 96 tiles, clusters of 3
    (512, 576, 192, 16, (3, 192)),
    # prefill on the 16-row tile: enough tiles, no split
    (512, 576, 576, 16, (1, 576)),
    (512, 1536, 576, 16, (1, 1536)),
    # the 32-row tile never splits
    (512, 576, 576, 32, (1, 576)),
    (512, 1536, 576, 32, (1, 1536)),
    (512, 576, 1536, 32, (1, 576)),
    (512, 576, 192, 32, (1, 576)),
    (512, 1536, 192, 32, (1, 1536)),
    # small and ragged
    (64, 1536, 192, 32, (1, 1536)),
    (100, 200, 70, 32, (1, 224)),
    (17, 200, 70, 32, (1, 224)),
])
def test_split_k(M, K, N, tm, want):
    splits, kps = tile._split_k(M, K, N, SMS, tm)
    assert (splits, kps) == want
    assert kps % 32 == 0 and (splits - 1) * kps < K <= splits * kps
    if tm == tile.TM_MMA:
        assert splits == 1


@pytest.mark.parametrize("M,K,N", [
    # one smollm layer at decode (8 lanes, and 1 and 16), the CRT slices
    # run the same shapes with fewer channels
    (8, 576, 576), (8, 576, 192), (8, 576, 960), (8, 576, 1536),
    (8, 1536, 576), (1, 576, 192), (16, 1536, 576), (16, 1536, 1536),
    # the 16-row prefill launches that split: the 192-wide projections
    (512, 576, 192), (512, 1536, 192), (64, 1536, 192),
    # K shorter than a cluster's worth of steps, and ragged
    (8, 64, 576), (13, 200, 70)])
def test_cluster_split(M, K, N):
    """A split 16-row launch is one cluster per output tile: at most 8
    blocks (the portable cluster size), as many as the grid's z, each
    with at least one K step; only launches with fewer tiles than SMs
    split, and the K steps are shared as evenly as whole steps allow."""
    splits, kps = tile._split_k(M, K, N, SMS, tile.TM)
    ktiles = -(-K // 32)
    assert 1 <= splits <= 8 and splits <= ktiles
    assert kps % 32 == 0 and (splits - 1) * kps < K <= splits * kps
    tiles = tile._tiles(M, N, tile.TM)
    assert (splits > 1) == (tiles < SMS and ktiles > 1)
    assert kps // 32 == -(-ktiles // min(8, -(-2 * SMS // tiles), ktiles))


class _FakeLibrary:
    """Stands in for the kernel library: records each TileArgs."""

    def __init__(self):
        self.args = []

    def rns_tile_launch(self, amode, args, plan, stream):
        a = ctypes.cast(args, ctypes.POINTER(_build.TileArgs)).contents
        self.args.append({f: getattr(a, f) for f, _ in a._fields_})
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "num_sms", lambda index: SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    return lib


@pytest.mark.parametrize("M,K,N,C", [(8, 576, 1536, 5), (512, 576, 576, 5),
                                     (512, 1536, 576, 7), (512, 576, 192, 8),
                                     (64, 1536, 192, 1)])
@pytest.mark.parametrize("pin", [None, tile.TM])
def test_launch_tile_args(fake_library, M, K, N, C, pin):
    """The struct handed to the library carries the picked height and the
    split of that height; the launch is counted under it."""
    x = torch.zeros(C, M, K, dtype=torch.int8)
    w = torch.zeros(C, K, N, dtype=torch.int8)
    out = torch.zeros(C, M, N, dtype=torch.int32)
    before = dict(tile.tile_launches)
    kw = dict(x=x, w=w, out=out, M=M, K=K, N=N, C=C, name="test")
    if pin is None:
        tile.launch_tile(tile.A_PLANES, tile.EMIT_CANONICAL, _build.Plan(),
                         **kw)
    else:
        with tile._pin_tile_rows(pin):
            tile.launch_tile(tile.A_PLANES, tile.EMIT_CANONICAL,
                             _build.Plan(), **kw)
    tm = pin or tile.tile_rows(M, N, C, SMS)
    splits, kps = tile._split_k(M, K, N, SMS, tm)
    (args,) = fake_library.args
    assert (args["tm"], args["splits"], args["k_per_split"]) == \
        (tm, splits, kps)
    assert (args["M"], args["K"], args["N"], args["encoded"]) == \
        (M, K, N, 1)
    # the cluster: grid z = cluster z = splits, at most 8, 32 rows unsplit
    assert 1 <= args["splits"] <= 8
    assert args["splits"] == 1 or tm == tile.TM
    assert args["w16"] == int(N % 16 == 0)
    assert tile.tile_launches[tm] == before[tm] + 1
    assert sum(tile.tile_launches.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("M,K,N,C,amode,emit", [
    (8, 576, 1536, 5, tile.A_BF16, tile.EMIT_FLOAT),
    (8, 1536, 576, 7, tile.A_PLANES, tile.EMIT_RESIDUES),
    (8, 576, 576, 1, tile.A_PLANES, tile.EMIT_CRT_LIMBS),
    (512, 576, 192, 5, tile.A_SHARED, tile.EMIT_CANONICAL),
    (512, 576, 576, 5, tile.A_F32, tile.EMIT_FLOAT)])
def test_launch_tile_allocates_nothing(fake_library, monkeypatch, M, K, N,
                                       C, amode, emit):
    """A launch, split or not, allocates nothing: the split-K partials
    live in the cluster's shared memory, and the caller hands over the
    output."""
    x = torch.zeros(C, M, K, dtype=torch.int8)
    w = torch.zeros(C, K, N, dtype=torch.int8)
    out = torch.zeros(C, M, N, dtype=torch.int32)

    def refuse(*args, **kwargs):
        raise AssertionError("launch_tile allocated a tensor")

    for fn in ("zeros", "empty", "zeros_like", "empty_like", "full"):
        monkeypatch.setattr(torch, fn, refuse)
    tile.launch_tile(amode, emit, _build.Plan(), x=x, w=w, out=out, M=M,
                     K=K, N=N, C=C, name="test")
    (args,) = fake_library.args
    assert args["splits"] == tile._split_k(M, K, N, SMS, args["tm"])[0]


@pytest.mark.parametrize("C,K,N", [(8, 32, 64), (5, 32, 70), (5, 30, 64)])
def test_launch_tile_refuses_what_32_rows_do_not_take(fake_library, C, K,
                                                      N):
    """Pinned to 32 rows, a basis of 8+ channels or an odd shape (N or K
    not a multiple of 4) raises before any launch."""
    x = torch.zeros(C, 64, K, dtype=torch.int8)
    w = torch.zeros(C, K, N, dtype=torch.int8)
    with tile._pin_tile_rows(tile.TM_MMA):
        with pytest.raises(ValueError, match="C <= 7 and N, K multiples"):
            tile.launch_tile(tile.A_PLANES, tile.EMIT_CANONICAL,
                             _build.Plan(), x=x, w=w, out=w, M=64, K=K,
                             N=N, C=C, name="test")
    assert fake_library.args == []


def test_plan_struct_bounds_the_subtracts():
    """The kernels' fold unrolls at most MAXSUB conditional subtracts; a
    plan needing more is refused before any launch."""
    plan = ChannelPlan.for_matmul(basis_for_chain(1536).moduli, 1536,
                                  signed=False)
    assert plan.n_sub <= _build.MAXSUB
    _build.plan_struct(plan, None)
    with pytest.raises(ValueError, match="n_sub=5"):
        _build.plan_struct(dataclasses.replace(plan, n_sub=5), None)


def _mod_u(u, m, mu):
    """`rns::mod_u` of csrc/rns_common.cuh in Python."""
    r = u - ((u * mu) >> 32) * m
    return r - m if r >= m else r


@pytest.mark.parametrize("mods", [basis_for_int8_matmul(576).moduli,
                                  basis_for_chain(65536).moduli,
                                  (2045, 2051, 2039, 2057, 1025, 3071),
                                  (1024, 47, 31), (2, 3, 1 << 15)])
def test_divide_free_mods_are_exact(mods):
    """The kernels' mods by the plan's reciprocal equal Python's floored
    mod over the operands they are given: int8 values lifted by madd, a
    residue minus another channel's times an inverse (the MRC step), and
    the extremes of the 32-bit range."""
    st = _build.Plan()
    _build.set_moduli(st, mods)
    hi = max(mods)
    rng = torch.Generator().manual_seed(len(mods))
    for j, m in enumerate(mods):
        mu, madd = st.mu[j], st.madd[j]
        assert madd % m == 0 and madd >= max(128, hi)
        for x in range(-128, 128):
            assert _mod_u(x + madd, m, mu) == x % m
        t = torch.randint(0, m, (2000,), generator=rng).tolist()
        d = torch.randint(0, hi, (2000,), generator=rng).tolist()
        inv = torch.randint(0, m, (2000,), generator=rng).tolist()
        for a, b, v in zip(t, d, inv):
            u = (a - b + madd) * v
            assert 0 <= u < 1 << 32 and _mod_u(u, m, mu) == u % m
        for u in (0, m - 1, m, (1 << 32) - 1, (1 << 31) - 1):
            assert _mod_u(u, m, mu) == u % m
    with pytest.raises(ValueError, match="outside"):
        _build.set_moduli(_build.Plan(), ((1 << 15) + 1,))


def test_wg_route_rule():
    """The 64-row wgmma + TMA tile takes the raw int8 A operand at C <= 7
    with weights read four bytes or more a load (``vec``) and A rows TMA
    can read (K a multiple of 16, a 16-byte aligned plane); a launch it
    cannot take runs on the 32-row tile, whatever chose 64."""
    ok = dict(amode=tile.A_SHARED, C=5, K=576, vec=True, tma=True)
    assert tile.wg_ok(**ok)
    assert tile.route_rows(tile.TM_WG, **ok) == tile.TM_WG
    for bad in (dict(amode=tile.A_PLANES), dict(amode=tile.A_F32),
                dict(amode=tile.A_BF16), dict(C=8), dict(K=584),
                dict(vec=False), dict(tma=False)):
        kw = {**ok, **bad}
        assert not tile.wg_ok(**kw)
        assert tile.route_rows(tile.TM_WG, **kw) == tile.TM_MMA
        for tm in (tile.TM, tile.TM_MMA):
            assert tile.route_rows(tm, **kw) == tm


def test_static_rule_heights():
    """The static rule at M = 512: the 64-row tile where it takes the
    launch, else the 32-row tile; decode stays on 16 rows, and a grid
    with fewer tiles than SMs splits K on 16 rows."""
    assert tile.static_choice(512, 576, 576, 5, SMS, True, True) == (
        tile.TM_WG, 1)
    assert tile.static_choice(512, 576, 576, 5, SMS, True, False) == (
        tile.TM_MMA, 1)
    assert tile.static_choice(8, 576, 576, 5, SMS, True, True)[0] == tile.TM
    assert tile.static_choice(512, 576, 192, 5, SMS, True, True)[0] == \
        tile.TM
    assert tile.static_choice(512, 576, 576, 8, SMS, True, True)[0] == \
        tile.TM
