"""The conversion kernels (`rns_forward`, `rns_reverse`) on the CPU: their
plain versions against the JAX reference, and the host side of the CUDA
kernels checked by emulation.

The CUDA kernels run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`), so what they read from the host is checked here: the
forward's reciprocal tables (`forward_tables`) with its divide-free
floored mod emulated in int64 torch against `torch.remainder`, over every
modulus 2..2^15 and large moduli up to 2^31 − 1; the reverse's (C, L)
instances (`REVERSE_INSTANCES`) against the plans the configs build and
the plans a basis can have; the scale map, the vector split and the grid.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _convert_cases import (INT32_EXTREMES, LARGE_MODULI, basis_with_limbs,
                            edge_residues, forward_values)
from repro.core.conversion_plan import ConversionPlan as JConv
from repro.core.rns import RNSBasis as JBasis
from repro.kernels.rns_convert import rns_forward as jforward
from repro.kernels.rns_convert import rns_reverse as jreverse
from repro_torch.configs import base as cfgbase
from repro_torch.core import multiword as mw
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.rns import (RNSBasis, basis_for_chain,
                                  basis_for_int8_matmul)
from repro_torch.kernels import rns_convert, rns_forward, rns_reverse
from repro_torch.kernels.rns_convert import (REVERSE_INSTANCES,
                                             forward_tables, launch_shape,
                                             scale_map, vectors)

M32 = (1 << 32) - 1
# moduli past 2^15, up to the largest an int32 residue holds
BIG_MODULI = (2**15 + 1, 2**15 + 3, 65535, 2**16 + 1, 1_000_003,
              2**30 - 1, 2**30, 2**30 + 3, 3 * 2**29 + 1, 2**31 - 3,
              2**31 - 2, 2**31 - 1)


def _umulhi(u, mu):
    """__umulhi(u, mu) of unsigned 32-bit values, exact in int64 (mu is
    split in 16-bit halves so that no product passes 2^48)."""
    return (u * (mu >> 16) + ((u * (mu & 0xFFFF)) >> 16)) >> 16


def _mod32(v, m, t):
    """The kernel's fwd_mod32 in int64: floored |v|_m of int32 v."""
    mu, neg = t["mu"], t["neg"]
    u = v & M32
    r = (u - _umulhi(u, mu) * m) & M32
    r = torch.minimum(r, (r + m) & M32)
    r = r + torch.where(v < 0, neg, torch.zeros_like(neg))
    return torch.minimum(r, (r - m) & M32)


def _mod8(v, m, t):
    """The kernel's fwd_mod8 in int64: floored |v|_m of int8 v, m <= 128."""
    return _umulhi((t["mu"] * v + t["mlo"]) & M32, m)


def _tables(mods):
    m = torch.tensor(mods, dtype=torch.int64)[:, None]
    t = {k: torch.tensor(v, dtype=torch.int64)[:, None]
         for k, v in forward_tables(mods).items()}
    return m, t


def _sweep(m):
    """Per modulus: the int32 extremes, a dense run around 0, multiples of
    m (±1) next to both ends of the int32 range, and random values."""
    dense = torch.arange(-300, 301, dtype=torch.int64)[None].expand(
        m.shape[0], -1)
    lo = (-2**31 + m - 1) // m * m           # least multiple >= INT32_MIN
    hi = (2**31 - 1) // m * m                # largest multiple <= INT32_MAX
    ends = torch.cat([lo - 1, lo, lo + 1, hi - 1, hi, hi + 1], 1).clamp(
        -2**31, 2**31 - 1)
    g = torch.Generator().manual_seed(int(m[0, 0]))
    rand = torch.randint(-2**31, 2**31, (m.shape[0], 32), generator=g)
    ext = torch.tensor(INT32_EXTREMES)[None].expand(m.shape[0], -1)
    return torch.cat([ext, dense, ends, rand], 1)


@pytest.mark.parametrize("chunk", range(8))
def test_divide_free_mod32_every_small_modulus(chunk):
    """fwd_mod32 with the host's tables == torch.remainder for every
    modulus 2..2^15 (in eight chunks) over the int32 extremes, a dense run
    around 0, the multiples next to the range's ends and random values."""
    mods = tuple(range(2 + chunk * 4096, min(2 + (chunk + 1) * 4096,
                                             2**15 + 1)))
    m, t = _tables(mods)
    v = _sweep(m)
    assert torch.equal(_mod32(v, m, t), torch.remainder(v, m))


def test_divide_free_mod32_large_moduli():
    m, t = _tables(BIG_MODULI + LARGE_MODULI)
    v = _sweep(m)
    assert torch.equal(_mod32(v, m, t), torch.remainder(v, m))


def test_divide_free_mod8_every_int8_modulus():
    """fwd_mod8 (int8 values, int8 residues: m <= 128), the remainder read
    from the low word of mu·(v + madd), is exact for every value
    -128..127 and modulus 2..128."""
    m, t = _tables(tuple(range(2, 129)))
    v = torch.arange(-128, 128, dtype=torch.int64)[None]
    assert torch.equal(_mod8(v, m, t), torch.remainder(v, m))


@pytest.mark.parametrize("mods", [tuple(range(2, 2**15 + 1)),
                                  BIG_MODULI + LARGE_MODULI])
def test_reciprocal_quotient_exact_or_one_over(mods):
    """mu = floor(2^32/m) + 1: __umulhi(u, mu) is floor(u/m) or one more
    for every u < 2^32 (m = 2, powers of two and m up to 2^31 − 1
    included), and exactly floor(u/m) when u·m < 2^32."""
    m, t = _tables(mods)
    mu = t["mu"]
    assert bool(((mu * m - 2**32 > 0) & (mu * m - 2**32 <= m)).all())
    u = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                     dtype=torch.int64)[None].expand(m.shape[0], -1)
    u = torch.cat([u, m - 1, m, m + 1, (M32 // m) * m, (M32 // m) * m - 1,
                   torch.minimum((M32 // m) * m + m - 1,
                                 torch.full_like(m, M32))], 1)
    over = _umulhi(u, mu) - u // m
    assert bool(((over == 0) | (over == 1)).all())
    small = torch.minimum((2**32 - 1) // m, torch.full_like(m, M32))
    exact = _umulhi(small, mu) - small // m
    assert bool((exact == 0).all())


def test_forward_tables():
    mods = tuple(range(2, 300)) + BIG_MODULI
    t = forward_tables(mods)
    for m, mu, mlo, neg in zip(mods, t["mu"], t["mlo"], t["neg"]):
        assert mu == 2**32 // m + 1 and mu < 2**32
        madd = -(-128 // m) * m               # least multiple of m >= 128
        assert madd % m == 0 and 128 <= madd < 128 + m
        assert mlo == mu * madd % 2**32
        assert neg == (-(2**32)) % m and 0 <= neg < m


FORWARD_BASES = {"dense-576": basis_for_int8_matmul(576).moduli,
                 "dense-1536": basis_for_int8_matmul(1536).moduli,
                 "chain-1536": basis_for_chain(1536).moduli,
                 "large": LARGE_MODULI}


@pytest.mark.parametrize("name", FORWARD_BASES)
@pytest.mark.parametrize("itype", [torch.int8, torch.int32])
def test_forward_plain_matches_pallas_interpret(name, itype):
    """The port's rns_forward on the CPU (its plain version) == the JAX
    Pallas rns_forward in interpret mode, int32 residues and, where the
    moduli allow, int8; values with the type's extremes."""
    mods = FORWARD_BASES[name]
    x = forward_values(2000, itype, seed=len(name)).reshape(40, 50)
    want = np.asarray(jforward(jnp.asarray(x.numpy()), mods, block=512,
                               interpret=True))
    got = rns_forward(x, mods, dtype=torch.int32)
    assert got.shape == (len(mods), 40, 50)
    assert got.numpy().tobytes() == want.tobytes()
    if max(mods) <= 128:
        got8 = rns_forward(x, mods, dtype=torch.int8)
        assert got8.dtype == torch.int8
        assert np.array_equal(got8.numpy(), want.astype(np.int8))


def _config_bases():
    """Every conversion basis the registered configs (full and smoke)
    build: basis_for_int8_matmul of each linear's K and, for the resident
    configs, basis_for_chain(d_ff)."""
    cfgbase._ensure_loaded()
    out = {}
    for name in cfgbase._REGISTRY:
        for cfg in (cfgbase.get_config(name), cfgbase.get_smoke_config(name)):
            q = cfg.num_heads * cfg.head_dim
            # a width of 0 is a linear the config does not have (mamba2
            # has no attention and no MLP)
            for k in {cfg.d_model, cfg.d_ff, q} - {0}:
                out[f"dense-{k}"] = basis_for_int8_matmul(k)
            if cfg.d_ff:
                out[f"chain-{cfg.d_ff}"] = basis_for_chain(cfg.d_ff)
    return out


def test_reverse_instances_cover_every_config_plan():
    bases = _config_bases()
    assert len(bases) >= 4
    for name, basis in bases.items():
        plan = ConversionPlan.for_basis(basis)
        assert (plan.k, plan.nlimbs) in REVERSE_INSTANCES, name


def test_reverse_instances_are_the_reachable_plans():
    """REVERSE_INSTANCES is every (C, L) of a plan of 3-11 channels with
    moduli <= 2^15 and L <= 6: each has a basis, the least L is that of
    the first C primes (the least product of C coprime moduli), and C
    moduli below 2^15 give at most C + 1 limbs."""
    for C in range(3, 12):
        ls = sorted(L for c, L in REVERSE_INSTANCES if c == C)
        primes = [p for p in range(2, 40)
                  if all(p % q for q in range(2, p))][:C]
        assert ls[0] == mw.nlimbs_for(math.prod(primes))
        assert ls[-1] == min(6, mw.nlimbs_for(2**(15 * C) - 1)) == min(6,
                                                                       C + 1)
        assert ls == list(range(ls[0], ls[-1] + 1))
        for L in ls:
            plan = ConversionPlan.for_basis(basis_with_limbs(C, L))
            assert (plan.k, plan.nlimbs) == (C, L) and plan.device_reversible
    assert len(REVERSE_INSTANCES) == 43


@pytest.mark.parametrize("C,L", sorted(REVERSE_INSTANCES))
def test_reverse_plain_matches_reference_every_instance(C, L):
    """For a basis of every (C, L) instance, the port's rns_reverse on the
    CPU (its plain version, which the kernel is held to on the card) ==
    the JAX ConversionPlan.reverse, with and without a scale; residues at
    the signed range's corners included."""
    tb = basis_with_limbs(C, L)
    jconv = JConv.for_basis(JBasis(name=tb.name, moduli=tb.moduli))
    conv = ConversionPlan.for_basis(tb)
    res = edge_residues(tb, (6, 11), seed=C * 8 + L)
    scale = torch.rand((6, 1), generator=torch.Generator().manual_seed(L))
    for sc in (None, scale):
        want = jconv.reverse(jnp.asarray(res.numpy()), backend="jnp",
                             scale=None if sc is None
                             else jnp.asarray(sc.numpy()))
        got = rns_reverse(res, conv, scale=sc)
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("C,L", [(3, 4), (5, 2), (7, 3), (11, 6)])
def test_reverse_plain_matches_pallas_interpret(C, L):
    tb = basis_with_limbs(C, L)
    jconv = JConv.for_basis(JBasis(name=tb.name, moduli=tb.moduli))
    res = edge_residues(tb, (70,), seed=L)
    scale = torch.rand(70, generator=torch.Generator().manual_seed(C))
    want = jreverse(jnp.asarray(res.numpy()), jconv,
                    scale=jnp.asarray(scale.numpy()), block=32,
                    interpret=True)
    got = rns_reverse(res, ConversionPlan.for_basis(tb), scale=scale)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _kernel_offsets(dims, S):
    """The kernel's scale_at for every element e < S."""
    e = torch.arange(S, dtype=torch.int64)
    off = torch.zeros_like(e)
    for size, stride in dims:
        off += (e % size) * stride
        e = e // size
    return off


SCALE_CASES = {            # out shape, scale shape, scale layout
    "full": ((8, 192), (8, 192), "fresh"),
    "row": ((8, 192), (8, 1), "fresh"),
    "column": ((8, 192), (192,), "fresh"),
    "one value": ((8, 192), (), "fresh"),
    "leading 1": ((8, 192), (1, 192), "fresh"),
    "batch row": ((3, 8, 70), (3, 8, 1), "fresh"),
    "middle": ((3, 8, 70), (8, 1), "fresh"),
    "transposed": ((6, 10), (6, 10), "transposed"),
    "offset": ((5, 12), (5, 12), "offset"),
    "3-d column": ((2, 3, 4, 5), (3, 1, 5), "fresh"),
}


@pytest.mark.parametrize("case", SCALE_CASES)
def test_scale_map_reads_the_broadcast(case):
    """What the reverse kernel reads for each element through scale_map ==
    torch.broadcast_to(scale, out shape), for contiguous, broadcast,
    transposed and offset scales; mode 1 (float4 loads) only for a scale
    laid out as the output and aligned."""
    shape, sshape, layout = SCALE_CASES[case]
    flat = torch.arange(4096, dtype=torch.float32)
    if layout == "transposed":
        scale = flat[:math.prod(sshape)].reshape(sshape[::-1]).t()
    elif layout == "offset":
        scale = flat[3:3 + math.prod(sshape)].reshape(sshape)
    else:
        scale = flat[:math.prod(sshape)].reshape(sshape)
    view = torch.broadcast_to(scale, shape)
    for aligned in (True, False):
        mode, dims = scale_map(shape, view.stride(), aligned)
        got = flat[view.storage_offset()
                   + _kernel_offsets(dims, math.prod(shape))]
        assert torch.equal(got, view.reshape(-1))
        assert mode == (1 if aligned and view.is_contiguous()
                        and tuple(sshape) == tuple(shape) else 2)


def test_vectors_cover_aligned_planes_of_large_launches():
    """Vectors only when every output plane is 16-byte aligned and they
    give each of 132 SMs a warp (4,224); else one element a thread."""
    S = 576 * 1536
    assert vectors(S, 16, 512, S, 132) == S // 16
    assert vectors(S, 4, 512, 0, 132) == S // 4
    assert vectors(S + 2, 4, 512, 0, 132) == S // 4     # one plane: tail 2
    assert vectors(S + 2, 16, 512, S + 2, 132) == 0     # planes off 16 bytes
    assert vectors(S + 4, 16, 512, 4 * (S + 4), 132) == S // 16  # int32 tail
    assert vectors(S, 16, 520, S, 132) == 0             # output off 16 bytes
    assert vectors(32 * 132 * 16, 16, 0, 0, 132) == 32 * 132
    assert vectors(32 * 132 * 16 - 16, 16, 0, 0, 132) == 0
    assert vectors(8 * 1536, 4, 0, 0, 132) == 0         # decode: elements


@pytest.mark.parametrize("nwork", [1, 6, 384, 6912, 55296, 622080, 10**8])
def test_launch_shape(nwork):
    """Blocks of 256 threads when every SM gets one, else 128, else 64;
    at most each kernel's threads an SM; the grid covers the work or
    strides over it."""
    sms = 132
    for per_sm in (rns_convert.FWD_PER_SM, rns_convert.REV_PER_SM):
        blocks, threads = launch_shape(nwork, sms, per_sm)
        assert threads in (64, 128, 256)
        assert blocks <= per_sm // threads * sms
        assert blocks * threads >= min(nwork, per_sm * sms)
        if threads < 256:
            assert -(-nwork // (2 * threads)) < sms
        with rns_convert._pin_launch(threads=128):
            assert launch_shape(nwork, sms, per_sm)[1] == 128
        with rns_convert._pin_launch(per_sm=2048):
            assert launch_shape(nwork, sms, per_sm)[0] <= 2048 // threads * sms
        assert launch_shape(nwork, sms, per_sm) == (blocks, threads)


def test_reverse_rejects_plans_without_an_instance():
    for mods in ((47, 43), tuple(p for p in range(3, 60)
                                 if all(p % q for q in range(2, p)))[:12]):
        plan = ConversionPlan.for_basis(RNSBasis(name="x", moduli=mods))
        with pytest.raises(ValueError, match="no rns_reverse instance"):
            rns_convert._reverse_struct(plan)


def test_forward_rejects_moduli_outside_the_kernel():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="beyond int8"):
        rns_forward(x, (129, 7), dtype=torch.int8)
    with pytest.raises(ValueError, match="moduli in"):
        rns_forward(x, (2**31, 7))
    with pytest.raises(ValueError, match="moduli in"):
        rns_forward(x, tuple(range(3, 29, 2)))
    with pytest.raises(ValueError, match="moduli in"):
        rns_forward(x, (1, 7))


def test_cpu_wrappers_launch_nothing():
    before = (rns_forward.launches, rns_reverse.launches)
    basis = basis_for_int8_matmul(576)
    x = forward_values(100, torch.int8, seed=1)
    res = rns_forward(x, basis.moduli)
    back = rns_reverse(res, ConversionPlan.for_basis(basis))
    assert torch.equal(back, x.to(torch.float32))
    assert (rns_forward.launches, rns_reverse.launches) == before
