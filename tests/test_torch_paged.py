"""The port's paged KV pool (`serve/paged_cache.py`) and paged decode step
(`models.transformer.decode_step(..., block_tables=)`) against the JAX
reference on the CPU.

  * `BlockAllocator`: the same seeded random sequences of alloc, retain,
    release, lookup and register leave both allocators in equal states and
    raise equal errors, op by op;
  * `splice_prefill`: bit-equal pools from the same prefill cache;
  * paged `decode_step` logits against the reference's over the same pool,
    block table and per-slot positions, within each config's logit
    tolerance (0.03; 0.15 for the residue-resident model, as
    `tests/test_torch_chain.py`), the reference on its jnp backend;
  * the port's paged step against its own contiguous step, bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_compare as cmp
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve import paged_cache as JP
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.serve import paged_cache as TP

LOGIT_ATOL = {"smollm-135m": 0.03, "rns-smollm-135m-fused": 0.03,
              "rns-smollm-135m-resident": 0.15}


def _jax_config(name):
    """The reference's smoke config, its RNS linears on the jnp backend
    (bit-equal to its Pallas kernels, `tests/test_chain.py`)."""
    cfg = jax_smoke_config(name)
    if cfg.linear_backend.startswith("rns_int8"):
        cfg = dataclasses.replace(cfg, linear_backend="rns_int8:jnp")
    return cfg


def _state(a):
    return (list(a._free), dict(a._refs), dict(a._by_prefix),
            dict(a._prefix_of), a.peak_used, a.prefix_hits, a.free_count,
            a.used)


def _apply(a, op, arg):
    try:
        if op == "alloc":
            return ("ok", a.alloc())
        if op == "retain":
            return ("ok", a.retain(arg))
        if op == "release":
            return ("ok", a.release(arg))
        if op == "lookup":
            return ("ok", a.lookup(arg))
        if op == "hit":
            a.prefix_hits += 1
            return ("ok", None)
        return ("ok", a.register(*arg))
    except (KeyError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(4))
def test_block_allocator_traces_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    ref, mine = JP.BlockAllocator(n), TP.BlockAllocator(n)
    prefixes = [tuple(rng.integers(1, 9, int(rng.integers(1, 4))).tolist())
                for _ in range(5)]
    ops = ["alloc", "alloc", "retain", "release", "release", "lookup",
           "register", "hit"]
    errors = 0
    for _ in range(300):
        op = ops[rng.integers(len(ops))]
        b = int(rng.integers(0, n + 1))
        pfx = prefixes[rng.integers(len(prefixes))]
        arg = {"lookup": pfx, "register": (pfx, b)}.get(op, b)
        got, want = _apply(mine, op, arg), _apply(ref, op, arg)
        assert got == want, (op, arg)
        assert _state(mine) == _state(ref), (op, arg)
        errors += got[0] != "ok"
    assert errors > 0                           # the error paths were taken


def test_block_allocator_needs_two_blocks():
    for cls in (JP.BlockAllocator, TP.BlockAllocator):
        with pytest.raises(ValueError, match="at least 2 blocks"):
            cls(1)


def test_init_paged_cache_layout_and_bytes():
    name = "smollm-135m"
    want = JP.init_paged_cache(jax_smoke_config(name), 5, 4, 2)
    got = TP.init_paged_cache(get_smoke_config(name), 5, 4, device="cpu")
    assert set(got) == set(want) == {"sub0"}
    for k in ("k", "v"):
        assert tuple(got["sub0"][k].shape) == want["sub0"][k].shape
        assert not got["sub0"][k].any()
    assert TP.paged_cache_nbytes(got) == JP.paged_cache_nbytes(want)
    ring = dataclasses.replace(get_smoke_config(name), attention="swa",
                               window=8)
    with pytest.raises(ValueError, match="sliding-window ring cache"):
        TP.init_paged_cache(ring, 5, 4, device="cpu")


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32).astype(
        jnp.bfloat16)


def test_splice_prefill_bit_equal():
    cfg = get_smoke_config("smollm-135m")
    L, Hk, dh = cfg.n_blocks, cfg.num_kv_heads, cfg.head_dim
    n_phys, bs, S, B = 6, 4, 16, 2
    rng = np.random.default_rng(3)
    pool = {"sub0": {k: _bf16(rng, (L, n_phys, bs, Hk, dh))
                     for k in ("k", "v")}}
    pf = {"sub0": {k: _bf16(rng, (L, B, S, Hk, dh)) for k in ("k", "v")}}
    # 5 pad slots and a shared first block go to the trash block 0
    phys = np.zeros(S, np.int32)
    offs = np.zeros(S, np.int32)
    for s in range(5 + bs, S):
        lp = s - 5
        phys[s], offs[s] = (3, 5, 2)[lp // bs], lp % bs
    want = JP.splice_prefill(jax.tree.map(jnp.asarray, pool),
                             jax.tree.map(jnp.asarray, pf), jnp.int32(1),
                             jnp.asarray(phys), jnp.asarray(offs))
    mine = jax.tree.map(cmp.t, pool)
    got = TP.splice_prefill(mine, jax.tree.map(cmp.t, pf),
                            torch.from_numpy(phys.astype(np.int64)),
                            torch.from_numpy(offs.astype(np.int64)))
    assert got is mine
    for k in ("k", "v"):
        assert torch.equal(got["sub0"][k], cmp.t(want["sub0"][k]))


@functools.lru_cache(maxsize=None)
def _engines(name):
    return cmp.engines(_jax_config(name), get_smoke_config(name))


def _paged_case(cfg, seed):
    """A pool of finite values, a block table with unmapped entries and a
    per-slot position for 3 slots of 4 logical blocks of 4 tokens; slot 2
    shares slot 0's first block, and its position writes to an unmapped
    block (the trash block)."""
    rng = np.random.default_rng(seed)
    L, Hk, dh = cfg.n_blocks, cfg.num_kv_heads, cfg.head_dim
    pool = {"sub0": {k: _bf16(rng, (L, 9, 4, Hk, dh)) for k in ("k", "v")}}
    bt = np.array([[3, 7, 1, -1], [2, 5, 8, 6], [3, -1, -1, -1]], np.int32)
    pos = np.array([9, 14, 5], np.int32)
    toks = rng.integers(1, cfg.vocab_size, (3, 1)).astype(np.int32)
    return pool, bt, pos, toks


@pytest.mark.parametrize("name", sorted(LOGIT_ATOL))
def test_paged_decode_logits_match_reference(name):
    jeng, teng = _engines(name)
    step = jax.jit(functools.partial(JT.decode_step, jeng.cfg))
    worst = 0.0
    for seed in range(2):
        pool, bt, pos, toks = _paged_case(teng.cfg, seed)
        want, _ = step(jeng.params, jax.tree.map(jnp.asarray, pool),
                       {"tokens": jnp.asarray(toks)}, jnp.asarray(pos),
                       block_tables=jnp.asarray(bt))
        with torch.inference_mode():
            got, _ = TT.decode_step(
                teng.cfg, teng.params, jax.tree.map(cmp.t, pool),
                {"tokens": torch.from_numpy(toks.astype(np.int64))},
                torch.from_numpy(pos.astype(np.int64)),
                block_tables=torch.from_numpy(bt.astype(np.int64)))
        assert torch.isfinite(got).all()
        worst = max(worst, np.abs(got.numpy() - np.asarray(want)).max())
    print(f"{name}: largest logit difference {worst:.4f} "
          f"(tolerance {LOGIT_ATOL[name]})")
    assert worst <= LOGIT_ATOL[name]


@pytest.mark.parametrize("name", sorted(LOGIT_ATOL))
@pytest.mark.parametrize("tail", ["mapped", "unmapped"])
def test_paged_step_equals_contiguous_step(name, tail):
    """The same keys in a contiguous cache and scattered over pool blocks
    (blocks past the position unmapped, or mapped): equal logits and equal
    written K/V, bit for bit."""
    cfg = get_smoke_config(name)
    _, teng = _engines(name)
    rng = np.random.default_rng(5)
    B, nlog, bs, pos = 3, 4, 4, 6
    L, Hk, dh = cfg.n_blocks, cfg.num_kv_heads, cfg.head_dim
    cache = {"sub0": {k: cmp.t(_bf16(rng, (L, B, nlog * bs, Hk, dh)))
                      for k in ("k", "v")}}
    perm = rng.permutation(np.arange(1, B * nlog + 1)).reshape(B, nlog)
    pool = {"sub0": {}}
    for k, c in cache["sub0"].items():
        p = torch.zeros((L, B * nlog + 1, bs, Hk, dh), dtype=c.dtype)
        p[:, perm.reshape(-1)] = c.reshape(L, B * nlog, bs, Hk, dh)
        pool["sub0"][k] = p
    bt = torch.from_numpy(perm.astype(np.int64))
    if tail == "unmapped":
        bt[:, pos // bs + 1:] = -1
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 1)))
    with torch.inference_mode():
        want, _ = TT.decode_step(cfg, teng.params, cache, {"tokens": toks},
                                 pos)
        got, _ = TT.decode_step(cfg, teng.params, pool, {"tokens": toks},
                                torch.full((B,), pos), block_tables=bt)
    assert torch.equal(got, want)
    for k in ("k", "v"):
        written = pool["sub0"][k][:, perm[:, pos // bs], pos % bs]
        assert torch.equal(written, cache["sub0"][k][:, :, pos])


def test_per_slot_positions_need_block_tables():
    cfg = get_smoke_config("smollm-135m")
    _, teng = _engines("smollm-135m")
    cache = TT.init_cache(cfg, 2, 8, "cpu")
    with pytest.raises(ValueError, match="block_tables"):
        TT.decode_step(cfg, teng.params, cache,
                       {"tokens": torch.ones((2, 1), dtype=torch.int64)},
                       torch.tensor([3, 4]))
