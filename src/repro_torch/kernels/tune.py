"""Block autotuner of the tile kernel, port of `repro/kernels/tune.py`.

The tile kernel behind `rns_fused_matmul`, `rns_matmul` and
`rns_fused_crt_partial` has a fixed width and K step (64 columns, 32 deep);
its free choices are the tile height (``TM`` = 16, the ``__dp4a`` tile,
``TM_MMA`` = 32, the ``mma.sync`` tile, or ``TM_WG`` = 64, the wgmma + TMA
tile of the raw int8 A mode) and the cluster K split of a 16-row launch (1
to ``MAX_SPLITS`` = 8 blocks; the taller tiles never split).  So
a "block" here is ``(tm, splits)``, a table row ``[tm, splits]``.
`blocks_for` resolves it:

  1. a persisted JSON table keyed by (variant, device, dtype, C, M, K, N):
     one sweep per distinct shape, shared across processes;
  2. on a miss on a CUDA device: a best-of-reps sweep of the admissible
     candidates, each a CUDA graph of launches on seeded operands timed
     with CUDA events, persisted;
  3. on the CPU, on a miss while a CUDA graph is being captured (counted in
     ``stats["capture_misses"]``; a capture never sweeps or writes), and
     where a stored row is not admissible for the call (the 32- and
     64-row tiles need aligned operand rows, which the key does not hold):
     the static rule, `rns_fused.static_choice`.  A chosen 64-row tile that
     the call's operands rule out runs on the 32-row tile
     (`rns_fused.route_rows`).

Outputs are bit-equal for every choice (the integer stages are exact and
the float epilogue runs per element), so the tuner changes when blocks
run, never what they compute.  ``sweep=`` is injectable, so the cache and
selection logic is tested on the CPU.  The table is
``$RNS_TORCH_TUNE_CACHE`` or ``~/.cache/repro-rns/tune_torch.json``; an
H100 table for the ported configs is committed beside this module
(`COMMITTED_TABLE`), written on the card by
``python -m repro_torch.kernels.tune --prepopulate --out PATH``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import rns_fused as rf

__all__ = ["CANDIDATES", "DECODE_CANDIDATES", "SMEM_BUDGET_BYTES",
           "COMMITTED_TABLE", "ZOO_BATCH_SIZES", "blocks_for", "choose",
           "cache_path", "clear_memory_cache", "smem_footprint",
           "inadmissible", "amode_for", "decode_shapes_for",
           "warm_for_config", "prepopulate", "shape_key", "parse_shape_key",
           "device_kind", "static_rule", "stats", "launcher_for"]

Blocks = Tuple[int, int]

MAX_SPLITS = rf._MAX_SPLITS
# Sweep candidates: the 64-row tile (raw int8 A only: `inadmissible` drops
# it for the other modes), the 32-row tile, and the 16-row tile at every
# cluster size.  Decode shapes (M <= 16 rows) sweep only the 16-row tile: a
# taller tile there computes at least half padding.
DECODE_CANDIDATES: Tuple[Blocks, ...] = tuple(
    (rf.TM, s) for s in range(1, MAX_SPLITS + 1))
CANDIDATES: Tuple[Blocks, ...] = ((rf.TM_WG, 1), (rf.TM_MMA, 1)) + \
    DECODE_CANDIDATES

# An H100 block may hold 227 KB of dynamic shared memory.
SMEM_BUDGET_BYTES = 227 * 1024
# csrc/rns_common.cuh: K step, the 36-byte padded weight rows, the 16-row
# tile's weight ring and the widest basis compiled
_TK, _KPAD, _STAGES, _MAXC = rf._TK, rf._TK + 4, 3, 11
# csrc/rns_tile_wg.cuh: the 64-row tile's K bytes a stage and columns (A
# stage 64 x 128, a channel's weights 32 x 128)
_WG_TK, _WG_TN = 128, 32

COMMITTED_TABLE = Path(__file__).resolve().with_name("tune_table_h100.json")
# Decode batch sizes of the serving paths: the static engine decodes at
# its generate() batch, the slot scheduler at its slot count.
ZOO_BATCH_SIZES = (1, 2, 4, 8)

# sweeps run and misses met while a graph was being captured
stats = {"sweeps": 0, "capture_misses": 0}
_MEMORY_CACHE: dict = {}
_RESOLVED: dict = {}
_static_only = False


def cache_path() -> Path:
    """The persisted table: ``$RNS_TORCH_TUNE_CACHE`` or a user-cache
    default (never the reference's ``RNS_TUNE_CACHE`` file, whose rows are
    ``[bm, bn, bk]``)."""
    return _path(os.environ.get("RNS_TORCH_TUNE_CACHE"))


@functools.lru_cache(maxsize=16)
def _path(env: Optional[str]) -> Path:
    return Path(env or os.path.join("~", ".cache", "repro-rns",
                                    "tune_torch.json")).expanduser()


def clear_memory_cache() -> None:
    """Drop the in-process tables (after re-pointing the cache)."""
    _MEMORY_CACHE.clear()
    _RESOLVED.clear()


@contextlib.contextmanager
def static_rule():
    """Resolve every launch inside the block by the static rule, as before
    the tuner: to hold tuned against static outputs (tests and
    ``chip_smoke.py``; no served path pins)."""
    global _static_only
    prev, _static_only = _static_only, True
    try:
        yield
    finally:
        _static_only = prev


# -------------------------------------------------------- admissibility ----
def amode_for(dtype: str, x_channels: bool) -> int:
    """The tile kernel's A mode of a launch with A operand ``dtype`` and,
    for int8, a (C, M, K) residue-plane (``x_channels``) or a shared
    signed (1, M, K) operand."""
    if dtype == "float32":
        return rf.A_F32
    if dtype == "bfloat16":
        return rf.A_BF16
    return rf.A_PLANES if x_channels else rf.A_SHARED


def smem_footprint(tm: int, C: int, *, amode: int = rf.A_PLANES,
                   encoded: bool = True) -> int:
    """Shared memory of one block of the tile instance (height, C, A mode,
    encoded): the 16-row tile's dynamic bytes (``Tile16<C, AM,
    ENCODED>::BYTES``, as the library's ``rns_tile16_smem`` reports), the
    32-row tile's static operand stages, the 64-row tile's dynamic ring
    (``WgSmem<C>::BYTES``); 0 for an instance not compiled."""
    if tm == rf.TM_WG:
        if not 1 <= C <= rf._MMA_MAXC or amode != rf.A_SHARED:
            return 0
        stages = 4 if C <= 4 else 3
        return 1024 + stages * (rf.TM_WG + C * _WG_TN) * _WG_TK + \
            16 * stages
    ap = C if amode == rf.A_PLANES else 1
    # the instances `launch_tile` (csrc/rns_common.cuh) compiles: live
    # weights with every A mode but the residue planes, the 32-row tile up
    # to _MMA_MAXC
    if not 1 <= C <= (rf._MMA_MAXC if tm == rf.TM_MMA else _MAXC) \
            or tm not in (rf.TM, rf.TM_MMA) \
            or (not encoded and amode == rf.A_PLANES):
        return 0
    if tm == rf.TM_MMA:
        return ap * rf.TM_MMA * _TK + C * rf._TN * _TK
    ring = _STAGES * (C if encoded else 1) * _TK * rf._TN if encoded else 0
    wsm = C * rf._TN * _KPAD
    xs = ap * rf.TM * _TK
    recv = C * (rf.TM * rf._TN + 4 * MAX_SPLITS) * 4
    return ring + 2 * wsm + 2 * xs + recv + 16


def inadmissible(blocks, M: int, K: int, N: int, C: int, *,
                 amode: int = rf.A_PLANES, encoded: bool = True,
                 vec: Optional[bool] = None,
                 avec: Optional[bool] = None,
                 tma: Optional[bool] = None) -> List[str]:
    """Why the launch cannot run at ``blocks`` = (tm, splits), as the
    launchers and ``prepare_tile16`` (`csrc/rns_common.cuh`,
    `rns_tile_wg.cuh`) require; empty when it can.  ``vec``/``avec``
    (operand rows four values apart and aligned) default to N and K
    multiples of 4, ``tma`` (A rows TMA can read) to K a multiple of 16."""
    tm, splits = (int(b) for b in blocks)
    vec = N % 4 == 0 if vec is None else vec
    avec = K % 4 == 0 if avec is None else avec
    tma = K % 16 == 0 if tma is None else tma
    why = []
    if tm not in (rf.TM, rf.TM_MMA, rf.TM_WG):
        why.append(f"tile height {tm} is not compiled (only {rf.TM}, "
                   f"{rf.TM_MMA} and {rf.TM_WG})")
        return why
    if tm == rf.TM_WG and not rf.wg_ok(amode, C, K, vec, tma):
        why.append(f"the {tm}-row tile takes the raw int8 A operand at C <= "
                   f"{rf._MMA_MAXC}, N a multiple of 4 and K of 16 with "
                   f"aligned rows (A mode {amode}, C={C}, N={N}, K={K})")
    if not 1 <= splits <= (MAX_SPLITS if tm == rf.TM else 1):
        why.append(f"{splits} K splits: the {tm}-row tile takes 1"
                   + (f" to {MAX_SPLITS}" if tm == rf.TM else
                      " (it never splits)"))
    elif (splits - 1) * rf.k_per_split(K, splits) >= K:
        why.append(f"{splits} K splits of K={K} leave a split block "
                   "without a K step")
    if tm == rf.TM_MMA and C > rf._MMA_MAXC:
        why.append(f"the {tm}-row tile is compiled for C <= "
                   f"{rf._MMA_MAXC}, not C={C}")
    if tm == rf.TM_MMA and not (vec and avec):
        why.append(f"the {tm}-row tile needs N and K multiples of 4 with "
                   f"aligned rows (N={N}, K={K})")
    smem = smem_footprint(tm, C, amode=amode, encoded=encoded)
    if smem == 0 and not why:
        why.append(f"no {tm}-row instance for C={C}, A mode {amode}, "
                   f"encoded={encoded}")
    if smem > SMEM_BUDGET_BYTES:
        why.append(f"shared memory footprint {smem} bytes exceeds the "
                   f"{SMEM_BUDGET_BYTES}-byte budget of a block")
    return why


def _normalized(blocks: Blocks, K: int) -> Blocks:
    """The split count a launch really makes: ``splits`` blocks of
    `k_per_split` K steps each cover K with ceil(K / k_per_split)."""
    tm, splits = blocks
    return tm, -(-K // rf.k_per_split(K, splits))


# ------------------------------------------------------------------ table --
def _load_table() -> dict:
    path = cache_path()
    key = str(path)
    if key not in _MEMORY_CACHE:
        try:
            table = json.loads(path.read_text())
            if not isinstance(table, dict):
                table = {}
        except (OSError, ValueError):
            table = {}
        _MEMORY_CACHE[key] = table
    return _MEMORY_CACHE[key]


def _save_table(table: dict) -> None:
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(table[k])}"
            for k in sorted(table)) + "\n}\n")
        os.replace(tmp, path)
    except OSError:
        pass                     # read-only file system: keep it in memory


@functools.lru_cache(maxsize=16)
def _kind(index: int) -> str:
    return torch.cuda.get_device_name(index).replace(" ", "-")


def device_kind(device=None) -> str:
    """The device segment of a key: the CUDA device's name with spaces
    dashed (a table swept on one card is no hit on another), else "cpu"."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return _kind(device.index if device.index is not None
                 else torch.cuda.current_device())


def shape_key(M: int, K: int, N: int, C: int, dtype: str = "int8",
              backend: str = "fused", kind: Optional[str] = None) -> str:
    """The table key of a launch: ``backend/device/dtype/C{C}/M{M}xK{K}xN{N}``
    (``kind`` defaults to this process's device, `device_kind`)."""
    kind = device_kind() if kind is None else kind
    return f"{backend}/{kind}/{dtype}/C{C}/M{M}xK{K}xN{N}"


def parse_shape_key(key: str) -> dict:
    """Invert the key format.  Returns ``{backend, device, dtype, C, M, K,
    N, x_channels, emit, gate, encoded, amode}``: the variant suffixes are
    read from the backend (``_res`` a (C, M, K) residue-plane operand,
    ``_emit`` the in-domain residue epilogue, ``_gate`` a gated prologue,
    ``_live`` a raw (K, N) weight).  Raises ``ValueError`` naming the
    malformed segment."""
    parts = key.split("/")
    if len(parts) != 5:
        raise ValueError(f"tune-table key {key!r}: expected 5 segments "
                         f"backend/device/dtype/C.../M...xK...xN..., "
                         f"got {len(parts)}")
    backend, device, dtype, c_part, shape_part = parts
    if not c_part.startswith("C") or not c_part[1:].isdigit():
        raise ValueError(f"tune-table key {key!r}: channel segment "
                         f"{c_part!r} is not of the form C<int>")
    m = re.fullmatch(r"M(\d+)xK(\d+)xN(\d+)", shape_part)
    if m is None:
        raise ValueError(f"tune-table key {key!r}: shape segment "
                         f"{shape_part!r} is not of the form M<i>xK<i>xN<i>")
    if dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"tune-table key {key!r}: dtype segment {dtype!r} "
                         "is not float32, bfloat16 or int8")
    x_channels = "_res" in backend
    return {"backend": backend, "device": device, "dtype": dtype,
            "C": int(c_part[1:]), "M": int(m.group(1)),
            "K": int(m.group(2)), "N": int(m.group(3)),
            "x_channels": x_channels, "emit": "_emit" in backend,
            "gate": "_gate" in backend, "encoded": "_live" not in backend,
            "amode": amode_for(dtype, x_channels)}


# ------------------------------------------------------------------ sweep --
def _basis(C: int, moduli=None):
    """The basis of a synthetic sweep: the given moduli, or the C largest
    odd moduli of the paper set (what `basis_for_accumulation` picks)."""
    from repro_torch.core.rns import PAPER_N5_MODULI, RNSBasis

    if moduli is None:
        moduli = sorted((m for m in PAPER_N5_MODULI if m != 1024),
                        reverse=True)[:C]
    return RNSBasis(name=f"sweep-C{C}", moduli=tuple(int(m)
                                                     for m in moduli))


def _plan_for(backend: str, amode: int, K: int, C: int, moduli=None):
    """The kernel's plan tables of a launch the key describes."""
    from repro_torch.core.channel_plan import ChannelPlan
    from repro_torch.dist.rns_shard import crt_tables

    basis = _basis(C, moduli)
    signed = amode != rf.A_PLANES
    if backend.startswith("fused"):
        return rf._kernel_plan(basis, K, signed)[2]
    plan = ChannelPlan.for_matmul(basis.moduli, K, signed=signed)
    if backend.startswith("crt"):
        v, mc, _ = crt_tables(basis)
        return rf._crt_plan_struct(plan, rf._table(plan.mods),
                                   rf._table(plan.sched), rf._table(v),
                                   rf._table(mc))
    from .rns_matmul import _plan_struct

    return _plan_struct(plan)


def launcher_for(M: int, K: int, N: int, C: int, dtype: str, backend: str,
                 device, launch=None,
                 moduli=None) -> Callable[[Blocks], None]:
    """One launch of the tile kernel at a given (tm, splits), uncounted, on
    seeded operands of the shape and variant the key names (the sweep's,
    and ``chip_smoke.py``'s tuned-against-static timing).  ``launch`` = (A
    mode, epilogue, plan tables) of a call being resolved; without it they
    follow the key (with ``moduli``, else the C-channel synthetic
    basis)."""
    v = parse_shape_key(shape_key(M, K, N, C, dtype, backend, kind="-"))
    if launch is None:
        amode = v["amode"]
        emit = (rf.EMIT_RESIDUES if v["emit"] else
                rf.EMIT_CRT_LIMBS if backend.startswith("crt") else
                rf.EMIT_CANONICAL if backend.startswith("matmul") else
                rf.EMIT_FLOAT)
        st = _plan_for(backend, amode, K, C, moduli)
    else:
        amode, emit, st = launch
    g = torch.Generator(device=device).manual_seed(0)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int8)

    if amode in (rf.A_F32, rf.A_BF16):
        x = torch.randn(M, K, generator=g, device=device).to(
            torch.float32 if amode == rf.A_F32 else torch.bfloat16)
    else:
        x = ints(-127, 128, (1, M, K)) if amode == rf.A_SHARED else \
            ints(0, 17, (C, M, K))
    w = ints(0, 17, (C, K, N)) if v["encoded"] else ints(-127, 128, (K, N))
    gate = ints(-127, 128, (M, K)) if v["gate"] else None
    srow = torch.full((M, 1), 1e-3, device=device)
    scol = torch.full((1, N), 1e-3, device=device)
    creq = torch.ones(1, device=device) if emit == rf.EMIT_RESIDUES \
        else None
    out_shape, out_dtype = {
        rf.EMIT_FLOAT: ((M, N), torch.float32),
        rf.EMIT_RESIDUES: ((C, M, N), torch.int8),
        rf.EMIT_CANONICAL: ((C, M, N), torch.int32),
        rf.EMIT_CRT_LIMBS: ((max(1, st.L1), M, N), torch.int32)}[emit]
    out = torch.empty(out_shape, dtype=out_dtype, device=device)

    def launch_once(blocks: Blocks) -> None:
        from . import _build

        rc = rf.run_tile(amode, emit, st, x=x, w=w, out=out, M=M, K=K, N=N,
                         tm=blocks[0], splits=blocks[1], vec=N % 4 == 0,
                         avec=K % 4 == 0, srow=srow, scol=scol, gate=gate,
                         creq=creq)
        _build.check(rc, f"tune launch {backend}")

    return launch_once


def _default_sweep(M: int, K: int, N: int, C: int, dtype: str, backend: str,
                   device, launch=None, moduli=None,
                   reps: int = 5, n: int = 20) -> Callable[[Blocks], float]:
    """Time the real tile kernel at each candidate (`launcher_for`): up to
    ``n`` launches captured in a CUDA graph, the graph replayed between two
    CUDA events, best of ``reps``, in ms a launch.  The graph keeps the
    host out of the time: a decode launch takes a few µs on the device,
    less than issuing it from Python, so launches timed back to back from
    the host measure the host.  A launch that takes a millisecond or more
    alone (a long prefill) fills the graph with fewer, about 2 ms of
    launches and no fewer than 2: the host is no part of such a time."""
    launch_once = launcher_for(M, K, N, C, dtype, backend, device, launch,
                               moduli)

    def run(blocks: Blocks) -> float:
        launch_once(blocks)           # first launch: the instance's set-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch_once(blocks)
        b.record()
        b.synchronize()
        once = a.elapsed_time(b)
        count = n if once < 1.0 else max(2, min(n, int(2.0 / once)))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(count):
                launch_once(blocks)
        graph.replay()
        best = float("inf")
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / count)
        return best

    return run


# ---------------------------------------------------------------- resolve --
def _static(M, K, N, C, device, sms, vec, wg=False) -> Blocks:
    if sms is None:
        sms = (_sms(device) if device.type == "cuda" else 132)
    return rf.static_choice(M, K, N, C, sms, vec, wg)


def _sms(device) -> int:
    from . import _build

    return _build.num_sms(device.index if device.index is not None
                          else torch.cuda.current_device())


def _resolve(M: int, K: int, N: int, C: int, *, dtype: str, backend: str,
             device, vec, avec, sweep, candidates, persist: bool, launch,
             sms, moduli, tma=None) -> Tuple[Blocks, bool]:
    """(choice, whether it is the same on every later call)."""
    v = parse_shape_key(shape_key(M, K, N, C, dtype, backend, kind="-"))
    amode, encoded = v["amode"], v["encoded"]
    vec = N % 4 == 0 if vec is None else vec
    avec = K % 4 == 0 if avec is None else avec
    tma = K % 16 == 0 if tma is None else tma
    wg = rf.wg_ok(amode, C, K, vec, tma)
    device = torch.device(device if device is not None else
                          "cuda" if torch.cuda.is_available() else "cpu")
    table = _load_table()
    key = shape_key(M, K, N, C, dtype, backend, kind=device_kind(device))
    hit = table.get(key)
    if hit is not None:
        row = tuple(int(b) for b in hit)
        if len(row) == 2 and not inadmissible(
                row, M, K, N, C, amode=amode, encoded=encoded, vec=vec,
                avec=avec, tma=tma):
            return row, True
        return _static(M, K, N, C, device, sms, vec and avec, wg), True

    if sweep is None or sweep is False:
        if sweep is False or device.type != "cuda":
            return _static(M, K, N, C, device, sms, vec and avec, wg), True
        if torch.cuda.is_current_stream_capturing():
            stats["capture_misses"] += 1
            return _static(M, K, N, C, device, sms, vec and avec, wg), False
        sweep = _default_sweep(M, K, N, C, dtype, backend, device, launch,
                               moduli)
    if candidates is None:
        candidates = DECODE_CANDIDATES if M <= rf.TM else CANDIDATES
    pool, seen = [], set()
    for c in candidates:
        if not 1 <= int(c[1]) <= MAX_SPLITS:
            continue
        c = _normalized((int(c[0]), int(c[1])), K)
        if c not in seen and not inadmissible(
                c, M, K, N, C, amode=amode, encoded=encoded, vec=vec,
                avec=avec, tma=tma):
            seen.add(c)
            pool.append(c)
    if not pool:
        pool = [_static(M, K, N, C, device, sms, vec and avec, wg)]
    best = min(pool, key=sweep)
    stats["sweeps"] += 1
    if persist:
        # persist=False leaves BOTH tables untouched: an experimental
        # sweep must not reach the shared dict, where a later persisting
        # call would write it to disk as a tuned row
        table[key] = list(best)
        _save_table(table)
    return best, persist


def blocks_for(M: int, K: int, N: int, C: int, *, dtype: str = "int8",
               backend: str = "fused", device=None,
               vec: Optional[bool] = None, avec: Optional[bool] = None,
               sweep=None, candidates: Optional[Sequence[Blocks]] = None,
               persist: bool = True, launch=None, sms: Optional[int] = None,
               moduli=None, tma: Optional[bool] = None) -> Blocks:
    """Resolve (tile height, K splits) for one tile-kernel launch.

    Table hit → the stored row (the static rule if it is not admissible
    for this call).  Miss on a CUDA ``device`` (default: CUDA when present)
    or with an injected ``sweep`` → sweep the admissible candidates
    (`DECODE_CANDIDATES` for M <= 16, else `CANDIDATES`) and persist the
    winner.  Miss on the CPU, with ``sweep=False``, or while a graph is
    being captured → the static rule, nothing written.  ``backend`` and
    ``dtype`` name the variant (`rns_fused.launch_variant`)."""
    return _resolve(M, K, N, C, dtype=dtype, backend=backend, device=device,
                    vec=vec, avec=avec, sweep=sweep, candidates=candidates,
                    persist=persist, launch=launch, sms=sms,
                    moduli=moduli, tma=tma)[0]


def choose(backend: str, dtype: str, M: int, K: int, N: int, C: int, *,
           device, sms: int, vec: bool, avec: bool, launch,
           tma: bool = False) -> Blocks:
    """`blocks_for` on the launch path (`rns_fused.launch_tile`), memoized
    per table and call signature, so a hit costs one dict lookup."""
    if _static_only or device.type != "cuda":
        wg = rf.wg_ok(amode_for(dtype, "_res" in backend), C, K, vec, tma)
        return rf.static_choice(M, K, N, C, sms, vec and avec, wg)
    resolved = _RESOLVED.setdefault(cache_path(), {})
    sig = (backend, dtype, C, M, K, N, device.index, vec, avec, tma)
    got = resolved.get(sig)
    if got is None:
        got, stable = _resolve(M, K, N, C, dtype=dtype, backend=backend,
                               device=device, vec=vec, avec=avec, sweep=None,
                               candidates=None, persist=True, launch=launch,
                               sms=sms, moduli=None, tma=tma)
        if stable:
            resolved[sig] = got
    return got


# -------------------------------------------------- serving prepopulation --
def decode_shapes_for(cfg, batch_sizes=ZOO_BATCH_SIZES) -> list:
    """The tile-kernel launches of ONE decode step of ``cfg`` at each batch
    size, mirroring the dispatch in `models/{transformer,layers}.py`: per
    linear for ``linear_domain="float"`` (the fused kernel, or
    `rns_matmul` on the staged backend); the stacked-QKV residue-in
    launch, the quantize ``wo`` and the GLU chain (gate, up with the
    residue epilogue, gated down) for ``"residue"``.  A deduped list of
    dicts ``{backend, C, M, K, N, dtype, x_channels, emit, gate, encoded,
    moduli}``; empty for a config that launches no tile kernel."""
    spec = cfg.linear_spec
    if not spec.is_rns:
        return []
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul

    d, F = cfg.d_model, cfg.d_ff
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    act = str(cfg.param_dtype)
    shapes, seen = [], set()

    def add(backend, basis, M, K, N, dtype):
        v = parse_shape_key(shape_key(M, K, N, 1, dtype, backend, kind="-"))
        s = dict(backend=backend, C=len(basis.moduli), M=M, K=K, N=N,
                 dtype=dtype, x_channels=v["x_channels"], emit=v["emit"],
                 gate=v["gate"], encoded=v["encoded"],
                 moduli=tuple(basis.moduli))
        sig = (backend, s["C"], M, K, N, dtype)
        if sig not in seen:
            seen.add(sig)
            shapes.append(s)

    has_attn = cfg.attention != "none" or cfg.hybrid
    for M in batch_sizes:
        if spec.domain == "residue":
            if has_attn:
                add("fused_res", basis_for_int8_matmul(d), M, d,
                    (H + 2 * Hk) * dh, "int8")
                add("fused", basis_for_int8_matmul(H * dh), M, H * dh, d,
                    act)
            if cfg.glu and F > 0:
                cb = basis_for_chain(F)
                add("fused_res", cb, M, d, F, "int8")
                add("fused_res_emit", cb, M, d, F, "int8")
                add("fused_res_gate", cb, M, F, d, "int8")
            continue
        pairs = set()
        if has_attn:
            pairs |= {(d, H * dh), (d, Hk * dh), (H * dh, d)}
        if F > 0:
            pairs |= {(d, F), (F, d)}
        for K, N in sorted(pairs):
            basis = basis_for_int8_matmul(K)
            if spec.backend == "pallas":
                add("matmul", basis, M, K, N, "int8")
            else:
                add("fused" if spec.encode_weights else "fused_live", basis,
                    M, K, N, act)
    return shapes


def warm_for_config(cfg, batch_sizes=ZOO_BATCH_SIZES, device=None) -> list:
    """Resolve every decode shape of ``cfg`` through `blocks_for` (called
    by `serve.Engine.__init__`): with a populated table every lookup is a
    hit and cold-start serving sweeps nothing.  Returns ``[{key, hit,
    blocks}, …]`` (empty for a config with no tile launch)."""
    report = []
    table = _load_table()
    kind = device_kind(device)
    for s in decode_shapes_for(cfg, batch_sizes):
        key = shape_key(s["M"], s["K"], s["N"], s["C"], s["dtype"],
                        s["backend"], kind=kind)
        hit = key in table
        blocks = blocks_for(s["M"], s["K"], s["N"], s["C"], dtype=s["dtype"],
                            backend=s["backend"], device=device,
                            moduli=s["moduli"])
        report.append({"key": key, "hit": hit, "blocks": tuple(blocks)})
    return report


def _tuned_archs() -> list:
    from repro_torch.configs.base import _REGISTRY, _ensure_loaded, \
        get_config

    _ensure_loaded()
    return [name for name in sorted(_REGISTRY)
            if decode_shapes_for(get_config(name), (1,))]


def prepopulate(archs=None, batch_sizes=ZOO_BATCH_SIZES,
                device=None) -> int:
    """Fill the table for the decode shapes of ``archs`` (default: every
    registered config with a tile launch), full and smoke: on a CUDA
    device a sweep per missing shape; on the CPU the static rule written
    explicitly under the "cpu" key (a card sweeps its own rows).  Returns
    the number of new entries."""
    from repro_torch.configs.base import get_config, get_smoke_config

    device = torch.device(device if device is not None else
                          "cuda" if torch.cuda.is_available() else "cpu")
    names = list(archs) if archs is not None else _tuned_archs()
    cfgs = [c for name in names
            for c in (get_config(name), get_smoke_config(name))]
    table = _load_table()
    kind = device_kind(device)
    new = 0
    for cfg in cfgs:
        for s in decode_shapes_for(cfg, batch_sizes):
            key = shape_key(s["M"], s["K"], s["N"], s["C"], s["dtype"],
                            s["backend"], kind=kind)
            if key in table:
                continue
            if device.type == "cuda":
                blocks_for(s["M"], s["K"], s["N"], s["C"], dtype=s["dtype"],
                           backend=s["backend"], device=device,
                           moduli=s["moduli"])
            else:
                table[key] = list(_static(s["M"], s["K"], s["N"], s["C"],
                                          device, None, True))
            new += 1
    _save_table(table)
    return new


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Autotuner table maintenance for the tile kernel")
    ap.add_argument("--prepopulate", action="store_true",
                    help="fill the table for the registered configs' decode "
                         "shapes (CUDA: swept; CPU: the static rule)")
    ap.add_argument("--out", default=None,
                    help="table path (default: $RNS_TORCH_TUNE_CACHE or the "
                         "user-cache default)")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch names (default: every "
                         "registered config with a tile launch)")
    args = ap.parse_args(argv)
    if args.out:
        os.environ["RNS_TORCH_TUNE_CACHE"] = args.out
        clear_memory_cache()
    if args.prepopulate:
        archs = args.archs.split(",") if args.archs else None
        n = prepopulate(archs=archs)
        print(f"# prepopulate: {n} new entries -> {cache_path()} "
              f"({len(_load_table())} total, {stats['sweeps']} sweeps)")
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(_main())
