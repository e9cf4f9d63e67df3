"""The fused RNS linear kernel wrapper: port of
`repro/kernels/rns_fused.py::rns_fused_matmul`.

One launch does Stage ②–⑤.  The A operand is float activations, which
the kernel rounds/clips by the row scale itself (the quantize form of
``rns_dense``), raw signed int8 activations streamed to every channel as
they are (the exact-int8 form of ``rns_int_matmul``), or an activation
:class:`RNSTensor` whose (C, M, K) canonical residues are used as they are
(the residue-in form of the residue-resident chain), optionally multiplied
per channel by ``|gate|_m`` of a raw int8 gate.  Then C per-channel int8
products into int32, the fold ladder (signed for the quantize and raw
forms, unsigned for canonical residues), MRC digits, 15-bit limb Horner,
the signed fix and the float32 recombination.  The epilogue writes
``((y·s_row)·s_col)·scale``, each factor optional (``emit="float"``), or
requantizes in the domain, clip(round(y·s_col / c), ±127) with c =
`quant.requant_const`, and writes the C residue planes of the result
(``emit="residues"``).  The CUDA source is `csrc/rns_common.cuh`; its
header says what bounds the kernel on an H100 and how the design answers
it.

`rns_fused_crt_partial` is the same tile kernel on a channel slice of the
basis, for the channel-sharded layout (`repro_torch.dist.rns_shard`): its
epilogue writes the slice's CRT partial sum as 15-bit limb planes instead
of running the MRC reverse, which needs every channel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import requant_const
from repro_torch.core.rns import basis_for_int8_matmul
from repro_torch.core.rns_tensor import RNSTensor

from . import _build
from .ref import rns_fused_crt_partial_ref, rns_fused_matmul_ref

__all__ = ["rns_fused_matmul", "rns_fused_crt_partial"]

_TN, _TK = 64, 32                   # tile width and K step of the kernel
# The three tile heights (rns::TM, rns::TM_MMA, rns::TM_WG): the 16-row
# __dp4a tile, the 32-row mma.sync tile and the 64-row wgmma + TMA tile of
# the raw int8 A mode (csrc/rns_tile_wg.cuh), the last two compiled for
# bases of up to _MMA_MAXC channels.
TM, TM_MMA, TM_WG, _MMA_MAXC = 16, 32, 64, 7
_MAX_SPLITS = 8                     # rns::MAX_SPLITS: the portable cluster
_pinned_rows: int | None = None
# launches of the tile kernel by tile height, over every entry
tile_launches = {TM: 0, TM_MMA: 0, TM_WG: 0}
# rns::AMode and rns::Emit of csrc/rns_common.cuh
A_F32, A_BF16, A_SHARED, A_PLANES = 0, 1, 2, 3
EMIT_FLOAT, EMIT_RESIDUES, EMIT_CANONICAL, EMIT_CRT_LIMBS = 0, 1, 2, 3


@functools.lru_cache(maxsize=256)
def _kernel_plan(basis, K: int, signed: bool):
    """(plan, conv, argument struct) of the K-deep launch in ``basis`` with
    a signed or unsigned fold plan, built once: the hot path does no plan
    work."""
    moduli = tuple(int(m) for m in basis.moduli)
    plan = ChannelPlan.for_matmul(moduli, K, signed=signed)
    conv = ConversionPlan.for_basis(basis)
    if plan.residue_dtype != torch.int8 or not conv.device_reversible:
        raise ValueError(f"basis {moduli} needs residues or Horner steps "
                         "beyond the kernel's int8/int32 datapath")
    return plan, conv, _build.plan_struct(plan, conv)


def wg_ok(amode: int, C: int, K: int, vec: bool, tma: bool) -> bool:
    """Whether the 64-row wgmma + TMA tile takes a launch: the raw int8 A
    operand (``A_SHARED``), C <= 7, ``vec`` weights (N a multiple of 4,
    aligned rows: its producer reads them four bytes or more a load) and
    ``tma``: A rows TMA can read, K a multiple of 16 and the plane 16-byte
    aligned."""
    return amode == A_SHARED and C <= _MMA_MAXC and vec and tma \
        and K % 16 == 0


def route_rows(tm: int, amode: int, C: int, K: int, vec: bool,
               tma: bool) -> int:
    """The route rule of the 64-row tile: a launch it cannot take
    (`wg_ok` false) runs on the 32-row ``mma.sync`` tile instead, whatever
    chose 64 (the static rule, a table row or a pin)."""
    if tm == TM_WG and not wg_ok(amode, C, K, vec, tma):
        return TM_MMA
    return tm


def tile_rows(M: int, N: int, C: int, sms: int, vec: bool = True,
              wg: bool = False) -> int:
    """Tile height of an (M, N) launch in a C-channel basis on ``sms`` SMs:
    for M > 16 (prefill) with the tensor-core tiles compiled for C, the
    operands ``vec`` (N and K multiples of 4, aligned rows: the tiles read
    four values a load) and a grid with a tile for every SM, the 64-row
    wgmma tile where it takes the launch (``wg``: `wg_ok`), else the 32-row
    ``mma.sync`` tile; the 16-row ``__dp4a`` tile otherwise (decode, bases
    of 8+ channels, odd shapes, and narrow launches, whose few tiles would
    leave SMs idle: only the 16-row tile splits K)."""
    if _pinned_rows is not None:
        return _pinned_rows
    if M > TM and C <= _MMA_MAXC and vec and _tiles(M, N, TM_MMA) >= sms:
        return TM_WG if wg else TM_MMA
    return TM


@contextlib.contextmanager
def _pin_tile_rows(rows: int):
    """Run every tile launch inside the block at height ``rows``, to hold
    the two heights against each other (the card's tests and
    ``chip_smoke.py``; no served path pins)."""
    global _pinned_rows
    if rows not in (TM, TM_MMA, TM_WG):
        raise ValueError(f"tile height {rows} is not compiled")
    prev, _pinned_rows = _pinned_rows, rows
    try:
        yield
    finally:
        _pinned_rows = prev


def _tiles(M: int, N: int, tm: int) -> int:
    return -(-N // _TN) * -(-M // tm)


def _split_k(M: int, K: int, N: int, sms: int,
             tm: int = TM) -> tuple[int, int]:
    """(splits, k_per_split) for a launch with ``tm``-row tiles.  The
    16-row tile splits the K loop only when its output tiles alone would
    leave SMs idle: into S <= 8 parts, the blocks of one output tile
    launched as one thread-block cluster, aiming at two blocks per SM, with
    at least one K step per block.  The 32-row tile never splits:
    `tile_rows` picks it only when its grid has a tile for every SM."""
    tiles = _tiles(M, N, tm)
    ktiles = -(-K // _TK)
    splits = 1
    if tm == TM and tiles < sms:
        splits = min(_MAX_SPLITS, -(-2 * sms // tiles), ktiles)
    k_per_split = -(-ktiles // splits) * _TK
    return -(-K // k_per_split), k_per_split


def static_choice(M: int, K: int, N: int, C: int, sms: int,
                  vec: bool = True, wg: bool = False) -> tuple[int, int]:
    """(tile height, K splits) of the static rule, `tile_rows` and
    `_split_k`: the tuner's fallback (`tune.blocks_for`)."""
    tm = tile_rows(M, N, C, sms, vec, wg)
    return tm, _split_k(M, K, N, sms, tm)[0]


def k_per_split(K: int, splits: int) -> int:
    """K depth of each of ``splits`` blocks, in whole K steps."""
    return -(-(-(-K // _TK)) // splits) * _TK


# the tuner's table key of a launch: its entry, suffixed by the variant
# (`tune.parse_shape_key` reads the suffixes), and the A operand's dtype
_ENTRY_BACKEND = {"rns_fused_matmul": "fused", "rns_matmul": "matmul",
                  "rns_fused_crt_partial": "crt"}
_AMODE_DTYPE = {A_F32: "float32", A_BF16: "bfloat16", A_SHARED: "int8",
                A_PLANES: "int8"}


def launch_variant(name: str, amode: int, emit: int, gated: bool,
                   encoded: bool) -> tuple[str, str]:
    """(backend, dtype) segments of a launch's tuner key: ``_res`` for a
    (C, M, K) residue-plane operand, ``_emit`` for the in-domain residue
    epilogue, ``_gate`` for a gated prologue, ``_live`` for a raw (K, N)
    weight."""
    backend = _ENTRY_BACKEND.get(name, name)
    backend += ("_res" if amode == A_PLANES else "") + \
        ("_emit" if emit == EMIT_RESIDUES else "") + \
        ("_gate" if gated else "") + ("" if encoded else "_live")
    return backend, _AMODE_DTYPE[amode]


def run_tile(amode: int, emit: int, st: _build.Plan, *, x, w, out, M: int,
             K: int, N: int, tm: int, splits: int, vec: bool, avec: bool,
             srow=None, scol=None, scale=None, gate=None,
             creq=None) -> int:
    """One launch of the tile kernel at an explicit (tile height, K
    splits) on the current stream; returns the library's code.  Counts
    nothing: `launch_tile` counts, the tuner's sweep does not."""
    args = _build.TileArgs()
    for field, t in (("x", x), ("w", w), ("out", out), ("srow", srow),
                     ("scol", scol), ("scale", scale), ("gate", gate),
                     ("creq", creq)):
        if t is not None:
            setattr(args, field, t.data_ptr())
    args.M, args.K, args.N, args.splits = M, K, N, splits
    args.k_per_split = k_per_split(K, splits)
    args.vec, args.avec = int(vec), int(avec)
    # weight rows in 16-byte pieces: the 16-row tile streams encoded
    # weights by cp.async (every serving shape), else reads them a step
    # ahead in registers
    args.w16 = int(N % 16 == 0 and w.data_ptr() % 16 == 0)
    args.encoded, args.emit, args.tm = int(w.ndim == 3), emit, tm
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return _build.library().rns_tile_launch(amode, ctypes.byref(args),
                                            ctypes.byref(st), stream)


def launch_tile(amode: int, emit: int, st: _build.Plan, *, x, w, out,
                M: int, K: int, N: int, C: int, srow=None, scol=None,
                scale=None, gate=None, creq=None, name: str) -> None:
    """One launch of the tile kernel on contiguous CUDA tensors, at the
    (tile height, K splits) the tuner resolves for its shape
    (`tune.choose`: the table's row, a sweep on a miss, the static rule
    `static_choice` as the fallback), or at a height pinned by
    `_pin_tile_rows` with its static split (a split 16-row launch is one
    cluster per output tile).  It allocates nothing: the caller hands it
    the output."""
    from . import tune

    vec = N % 4 == 0 and w.data_ptr() % 4 == 0
    # A (and the gate) four k values at a time
    avec = K % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                              for t in (x, gate) if t is not None)
    # A's rows by TMA (the 64-row tile): 16-byte rows and plane
    tma = K % 16 == 0 and x.data_ptr() % 16 == 0
    sms = _build.num_sms(x.device.index or 0)
    if _pinned_rows is not None:
        tm = route_rows(_pinned_rows, amode, C, K, vec, tma)
        splits = _split_k(M, K, N, sms, tm)[0]
    else:
        backend, dtype = launch_variant(name, amode, emit, gate is not None,
                                        w.ndim == 3)
        tm, splits = tune.choose(backend, dtype, M, K, N, C,
                                 device=x.device, sms=sms, vec=vec,
                                 avec=avec, tma=tma,
                                 launch=(amode, emit, st))
        tm = route_rows(tm, amode, C, K, vec, tma)
    if tm == TM_MMA and (C > _MMA_MAXC or not (vec and avec)):
        raise ValueError(f"{name}: the {TM_MMA}-row tile is compiled for "
                         f"C <= {_MMA_MAXC} and N, K multiples of 4 with "
                         f"aligned rows, not C={C}, N={N}, K={K}")
    rc = run_tile(amode, emit, st, x=x, w=w, out=out, M=M, K=K, N=N, tm=tm,
                  splits=splits, vec=vec, avec=avec, srow=srow, scol=scol,
                  scale=scale, gate=gate, creq=creq)
    _build.check(rc, name)
    tile_launches[tm] += 1


@_build.kernel_region("rns_fused_matmul")
def rns_fused_matmul(x, w, basis=None, *, quantize: bool | None = None,
                     gate: torch.Tensor | None = None, emit: str = "float",
                     scale_row: torch.Tensor | None = None,
                     scale_col: torch.Tensor | None = None,
                     scale: torch.Tensor | None = None,
                     requant_creq: torch.Tensor | None = None):
    """One-launch Stage ②–⑤ pipeline: (M, K) × weight → (M, N).

    ``x`` is one of three prologues.  (M, K) float32/bfloat16 activations
    are quantized in the kernel by ``scale_row`` (M, 1).  (M, K) raw
    signed int8 activations are streamed to every channel as they are (the
    broadcast operand; the fold plan's bound is K·128·(m−1)).  An
    activation :class:`RNSTensor` brings (C, M, K) canonical residues in
    the weight's basis (residue-in; ``scale_row`` defaults to its scale,
    the reference's ``x.scale·gate_scale`` when gated), and ``gate`` (M,
    K) raw int8 multiplies it per channel.  ``quantize`` is the reference's
    keyword: None lets x's dtype decide, and a value that contradicts the
    dtype raises.  ``w`` is an encoded :class:`RNSTensor`, its raw (C, K,
    N) residue stack (then ``basis`` is required), or a raw (K, N) int8
    weight converted per tile.

    ``emit="float"`` returns (M, N) float32: the exact product times
    ``scale_row`` (M, 1), then ``scale_col`` (1, N), each optional, or
    times a generic ``scale`` broadcast against (M, N), lowered as the
    reference lowers it (a scalar, (N,) or (1, N) scale rides as the column
    factor, an (M, 1) one as the row factor, any other streams as an (M,
    N) operand); with no scale the output is the exact integer product.
    ``emit="residues"`` returns the activation :class:`RNSTensor` of the
    in-domain requantized product, scale ``s_row·requant_const(s_col, K)``;
    ``requant_creq`` (0-d) overrides that constant (a column slice of a
    sharded launch requantizes by its full column scale's).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel;
    a meta tensor gets an empty output of the plain version's shape and
    dtype (a dry run).  On DTensor arguments (a mesh run) it runs on
    the local shards (`dtensor_rules`): x's rows and the weight's columns
    stay sharded, K and the channels are gathered, and an
    ``emit="residues"`` exit gathers the columns too (its requantize
    constant is the largest column scale).
    """
    if emit not in ("float", "residues"):
        raise ValueError(f"emit must be 'float' or 'residues', got {emit!r}")
    emit_res = emit == "residues"
    xin = x
    if isinstance(w, RNSTensor):
        if w.residues.ndim != 3:
            raise ValueError("rns_fused_matmul needs an unbatched (C, K, N) "
                             f"encoded weight, got {tuple(w.residues.shape)}")
        if w.bound > 128:
            raise ValueError(f"encoded weight bound {w.bound} exceeds the "
                             "int8 operand range the basis is sized for")
        if basis is not None and tuple(basis.moduli) != w.moduli:
            raise ValueError(f"basis {basis.moduli} does not match encoded "
                             f"weight channels {w.moduli}")
        basis, w = w.basis, w.residues
    residue_in = isinstance(x, RNSTensor)
    if residue_in:
        if x.residues.ndim != 3:
            raise ValueError("rns_fused_matmul needs an unbatched (C, M, K) "
                             "activation RNSTensor, got "
                             f"{tuple(x.residues.shape)}")
        if x.bound > 128:
            raise ValueError(f"activation bound {x.bound} exceeds the int8 "
                             "operand range the basis is sized for")
        if basis is not None and tuple(basis.moduli) != x.moduli:
            raise ValueError(f"basis {basis.moduli} does not match activation"
                             f" channels {x.moduli}")
        basis, x = x.basis, x.residues
        if x.dtype != torch.int8:
            raise ValueError(f"activation residues must be int8, got "
                             f"{x.dtype}")
    elif x.ndim != 2:
        raise ValueError(f"need x (M, K), got {tuple(x.shape)}")
    elif x.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"x must be float32, bfloat16 or int8, got "
                         f"{x.dtype}")
    if gate is not None:
        if not residue_in:
            raise ValueError("gate= fuses into the residue-in prologue; "
                             "float/int8 activations gate before quantize")
        if emit_res:
            raise ValueError("gate= with emit='residues' is unsupported: the "
                             "requantize bound is sized for K·127², not the "
                             "gated K·127³ product")
        if gate.shape != x.shape[-2:] or gate.dtype != torch.int8:
            raise ValueError(f"gate must be int8 {tuple(x.shape[-2:])}, got "
                             f"{gate.dtype} {tuple(gate.shape)}")
    if w.ndim not in (2, 3):
        raise ValueError(f"need w (K, N) or (C, K, N), got {tuple(w.shape)}")
    if w.dtype != torch.int8:
        raise ValueError(f"weights must be int8 (residues), got {w.dtype}")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if w.shape[-2] != K or K == 0:
        raise ValueError(f"contraction mismatch: x K={K}, w K={w.shape[-2]}")
    if basis is None:
        if w.ndim == 3:
            raise ValueError("raw (C, K, N) residues need an explicit basis")
        basis = basis_for_int8_matmul(K)
    plan, conv, st = _kernel_plan(basis, K, not residue_in)
    for name, t in (("residue stack", w), ("activation", x)):
        if t.ndim == 3 and t.shape[0] != plan.k:
            raise ValueError(f"{name} has {t.shape[0]} channels, basis has "
                             f"{plan.k}")
    if residue_in and w.ndim != 3:
        raise ValueError("a residue-in launch needs encoded weights")
    quant, srow, scol, sc = resolve_epilogue(
        xin, M, N, quantize=quantize, emit_res=emit_res, scale_row=scale_row,
        scale_col=scale_col, scale=scale, requant_creq=requant_creq)
    creq = None
    if emit_res:
        creq = (requant_const(scol, K) if requant_creq is None else
                requant_creq.to(torch.float32).reshape(()))
    # the row factor is read by the quantize prologue and by a float
    # epilogue; an in-domain epilogue of int8 operands does not read it
    ksrow = srow if (quant or not emit_res) else None
    if x.device.type == "cpu":
        out = rns_fused_matmul_ref(x, w, basis, scale_row=ksrow,
                                   scale_col=scol, scale=sc, gate=gate,
                                   creq=creq)
    elif x.device.type == "meta":
        out = (torch.empty((plan.k, M, N), dtype=torch.int8, device="meta")
               if creq is not None else
               torch.empty((M, N), dtype=torch.float32, device="meta"))
    elif x.device.type != "cuda":
        raise ValueError(f"rns_fused_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    else:
        out = _launch(x, w, ksrow, scol, sc, gate, creq, plan.k, st,
                      residue_in)
    if creq is not None:
        return RNSTensor(residues=out, scale=srow * creq, basis=basis)
    return out


def resolve_epilogue(x, M: int, N: int, *, quantize: bool | None = None,
                     emit_res: bool = False, scale_row=None, scale_col=None,
                     scale=None, requant_creq=None):
    """The prologue's form and the epilogue's factors of one (M, K) × (K,
    N) launch on ``x`` (float, raw int8 or an activation `RNSTensor`),
    resolved as `rns_fused_matmul` resolves them: ``quantize`` checked
    against x (float x quantizes, the other two do not), a residue-in
    launch's ``scale_row`` defaulted to its carried scale, the reference's
    checks (`check_scales`), the row and column factors as float32 (M, 1)
    and (1, N), and ``scale`` lowered by `lower_scale`.  Returns (quant,
    srow, scol, scale); a sharded launch resolves its operands here too, so
    that every rank lowers them as the whole launch does."""
    residue_in = isinstance(x, RNSTensor)
    if residue_in:
        if quantize:
            raise ValueError("quantize=True is the float-activation "
                             "prologue; a residue-in RNSTensor is already "
                             "quantized")
        if scale_row is None:
            scale_row = x.scale
        quant = False
    else:
        quant = x.dtype != torch.int8
        if quantize is not None and bool(quantize) != quant:
            raise ValueError(f"quantize={quantize} contradicts x's dtype "
                             f"{x.dtype}: float activations quantize, int8 "
                             "ones are the raw operand")
    check_scales(quant, residue_in, emit_res, scale_row, scale_col, scale,
                 requant_creq)
    srow = (None if scale_row is None else
            scale_row.to(torch.float32).reshape(M, 1))
    scol = (None if scale_col is None else
            scale_col.to(torch.float32).reshape(1, N))
    dev = (x.residues if residue_in else x).device
    return (quant, *lower_scale(scale, M, N, srow, scol, dev))


def check_scales(quant: bool, residue_in: bool, emit_res: bool, scale_row,
                 scale_col, scale, requant_creq=None) -> None:
    """The reference's checks of the epilogue's scale arguments (a
    residue-in launch's ``scale_row`` already defaulted to its carried
    scale)."""
    if quant and scale_row is None:
        raise ValueError("quantize=True needs the per-row quant scale_row")
    if scale_row is not None and not (quant or residue_in or emit_res):
        raise ValueError("scale_row is the quantize-mode row scale; int8 "
                         "inputs fuse dequant via scale= instead")
    if scale is not None and (scale_row is not None or scale_col is not None):
        raise ValueError("pass either scale or scale_row/scale_col, not both")
    if emit_res:
        if scale_col is None:
            raise ValueError("emit='residues' needs scale_col: the in-domain "
                             "requantize constant is max(scale_col)·K·127")
        if scale_row is None:
            raise ValueError("emit='residues' needs scale_row (or a carried "
                             "activation scale) to form the output scale")
        if scale is not None:
            raise ValueError("emit='residues' uses scale_row/scale_col; "
                             "generic scale= has no in-domain meaning")
    if requant_creq is not None and not emit_res:
        raise ValueError("requant_creq= overrides the in-domain requantize "
                         "constant and only means something with "
                         "emit='residues'")


def lower_scale(scale, M: int, N: int, srow, scol, device):
    """(row, column, full) factors of the float epilogue with a generic
    ``scale`` lowered as the reference lowers it: a scalar, (N,) or (1, N)
    scale becomes the (1, N) column factor, an (M, 1) one the (M, 1) row
    factor, any other (M, N) operand; raises for a scale that does not
    broadcast against the output."""
    if scale is None:
        return srow, scol, None
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.ndim > 2 or any(a not in (1, b) for a, b in zip(
            s.shape[::-1], (N, M))):
        raise ValueError(f"scale {tuple(s.shape)} does not broadcast against "
                         f"the ({M}, {N}) output")
    s2 = s.reshape((1,) * (2 - s.ndim) + tuple(s.shape)) if s.ndim < 2 else s
    if s2.shape[0] == 1:
        return srow, s2.expand(1, N), None
    if s2.shape[1] == 1:
        return s2.expand(M, 1), scol, None
    return srow, scol, s2


def _amode(x, residue_in: bool) -> int:
    """The tile kernel's A mode of an operand: residue planes, the raw int8
    block shared by every channel, or float activations to quantize."""
    if residue_in:
        return A_PLANES
    return {torch.int8: A_SHARED, torch.bfloat16: A_BF16}.get(x.dtype, A_F32)


def _launch(x, w, srow, scol, sc, gate, creq, C, st, residue_in):
    for name, t in (("w", w), ("scale_row", srow), ("scale_col", scol),
                    ("scale", sc), ("gate", gate)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    x, w = x.contiguous(), w.contiguous()
    gate = gate.contiguous() if gate is not None else None
    if creq is not None:
        out = torch.empty((C, M, N), dtype=torch.int8, device=x.device)
    else:
        out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    amode = _amode(x, residue_in)
    if creq is None and amode != A_SHARED and scol is None:
        # only the raw int8 epilogue's factors are optional in the kernel;
        # the others multiply by both, and a column factor of ones is exact
        scol = torch.ones((1, N), dtype=torch.float32, device=x.device)
    launch_tile(amode, EMIT_RESIDUES if creq is not None else EMIT_FLOAT, st,
                x=x, w=w, out=out, M=M, K=K, N=N, C=C,
                srow=srow.contiguous() if srow is not None else None,
                scol=scol.contiguous() if scol is not None else None,
                scale=sc.contiguous() if sc is not None else None, gate=gate,
                creq=creq.reshape(1) if creq is not None else None,
                name="rns_fused_matmul")
    rns_fused_matmul.launches += 1
    if residue_in:
        rns_fused_matmul.residue_in_launches += 1
    elif amode == A_SHARED:
        rns_fused_matmul.raw_launches += 1
    return out


rns_fused_matmul.launches = 0              # every launch
rns_fused_matmul.residue_in_launches = 0   # of which residue-in
rns_fused_matmul.raw_launches = 0          # of which raw int8


def _table(t) -> tuple:
    """A small host table (numpy array, nested sequence or tensor) as
    nested tuples of Python ints."""
    def tup(e):
        return tuple(map(tup, e)) if isinstance(e, list) else int(e)

    if isinstance(t, torch.Tensor):
        t = t.cpu()
    return tup(np.asarray(t).tolist())


@functools.lru_cache(maxsize=256)
def _crt_plan_struct(plan: ChannelPlan, mods: tuple, sched: tuple,
                     crt_v: tuple, crt_mc: tuple) -> _build.Plan:
    """The kernel's plan tables of one slice launch: the local plan's rung
    count, ``n_sub`` and signedness with the slice's own moduli, rung rows
    and CRT constants."""
    st = _build.plan_struct(plan, None)
    L1 = len(crt_mc[0])
    if L1 > _build.MAXL:
        raise ValueError(f"{L1} CRT limbs exceed the kernel's {_build.MAXL}")
    st.L1 = L1
    _build.set_moduli(st, mods)
    for j in range(len(mods)):
        st.crt_v[j] = crt_v[j]
        for r, (sh, c) in enumerate(sched[j]):
            st.sched_s[j][r], st.sched_c[j][r] = sh, c
        for l, limb in enumerate(crt_mc[j]):
            st.crt_mc[j][l] = limb
    return st


@_build.kernel_region("rns_fused_crt_partial")
def rns_fused_crt_partial(x, w, *, plan: ChannelPlan, mods, sched, crt_v,
                          crt_mc, quantize: bool = False,
                          scale_row: torch.Tensor | None = None,
                          gate: torch.Tensor | None = None) -> torch.Tensor:
    """Channel-slice launch: Stage ②–④ on C_l channels, then the CRT
    partial sum Σ_j |r_j·v_j|_{m_j}·(M/m_j) over them as ``(L1, M, N)``
    int32 15-bit limb planes (``L1 = crt_mc.shape[-1]``).  Summing the
    planes of every slice and `repro_torch.dist.rns_shard.crt_finish`
    recover the fused kernel's value exactly.

    ``plan`` is the local-shaped plan (`rns_shard.local_plan`: global bound,
    rung count and ``n_sub``); ``mods`` (C_l,), ``sched`` (C_l, R, 2),
    ``crt_v`` (C_l,) and ``crt_mc`` (C_l, L1) are this slice's tables, as
    host arrays.  The JAX entry's ``conv`` has no counterpart: the CRT
    epilogue does not read a conversion plan.

    ``x`` is (M, K) float32/bfloat16 with ``quantize=True`` and
    ``scale_row`` (M, 1), (M, K) raw signed int8 with ``quantize=False``
    (shared by every channel of the slice), or the (C_l, M, K) int8
    canonical residue slice, optionally gated by a raw int8 (M, K)
    ``gate``.  ``w`` is the (C_l, K, N) int8 residue slice, or the raw
    (K, N) int8 weight, converted per tile against the slice's own moduli
    (not with residue-in x, as `rns_fused_matmul`).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel; a meta tensor gets an
    empty output of the plain version's shape and dtype (a dry run).  On
    DTensor arguments it runs on the local shards (`dtensor_rules`): x's
    rows and the weight's columns stay sharded, K and the slice's
    channels are gathered.
    """
    residue_in = x.ndim == 3
    if residue_in:
        if x.shape[0] != plan.k:
            raise ValueError(f"residue slice has {x.shape[0]} channels, "
                             f"local plan has {plan.k}")
        if quantize:
            raise ValueError("quantize=True is the float prologue; residue "
                             "slices are already quantized")
        if x.dtype != torch.int8:
            raise ValueError(f"residue slice must be int8, got {x.dtype}")
    elif x.ndim != 2:
        raise ValueError(f"need x (M, K) or (C_l, M, K), got "
                         f"{tuple(x.shape)}")
    elif quantize and x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize=True needs float32/bfloat16 x, got "
                         f"{x.dtype}")
    elif not quantize and x.dtype != torch.int8:
        raise ValueError(f"quantize=False needs raw int8 x, got {x.dtype}")
    if w.ndim == 3:
        if w.shape[0] != plan.k:
            raise ValueError(f"weight slice has {w.shape[0]} channels, local "
                             f"plan has {plan.k}")
    elif w.ndim != 2:
        raise ValueError(f"need w (K, N) or (C_l, K, N), got "
                         f"{tuple(w.shape)}")
    elif residue_in:
        raise ValueError("a residue-in launch needs encoded weights")
    if w.dtype != torch.int8:
        raise ValueError(f"weights must be int8, got {w.dtype}")
    if quantize and scale_row is None:
        raise ValueError("quantize=True needs the per-row quant scale_row")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if w.shape[-2] != K or K == 0:
        raise ValueError(f"contraction mismatch: x K={K}, w K={w.shape[-2]}")
    if gate is not None:
        if not residue_in:
            raise ValueError("gate= fuses into the residue-in prologue")
        if gate.shape != x.shape[-2:] or gate.dtype != torch.int8:
            raise ValueError(f"gate must be int8 {tuple(x.shape[-2:])}, got "
                             f"{gate.dtype} {tuple(gate.shape)}")
    mods, sched = _table(mods), _table(sched)
    crt_v, crt_mc = _table(crt_v), _table(crt_mc)
    if not (len(mods) == len(sched) == len(crt_v) == len(crt_mc) == plan.k) \
            or any(len(r) != plan.num_rungs for r in sched):
        raise ValueError(f"slice tables must have {plan.k} channels and "
                         f"{plan.num_rungs} rungs")
    srow = (scale_row.to(torch.float32).reshape(M, 1) if quantize else None)
    if x.device.type == "cpu":
        return rns_fused_crt_partial_ref(x, w, plan=plan, mods=mods,
                                         sched=sched, crt_v=crt_v,
                                         crt_mc=crt_mc, scale_row=srow,
                                         gate=gate)
    if x.device.type == "meta":
        return torch.empty((len(crt_mc[0]), M, N), dtype=torch.int32,
                           device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"rns_fused_crt_partial runs on cuda or cpu, not "
                         f"{x.device}")
    for name, t in (("w", w), ("scale_row", srow), ("gate", gate)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    st = _crt_plan_struct(plan, mods, sched, crt_v, crt_mc)
    out = torch.empty((len(crt_mc[0]), M, N), dtype=torch.int32,
                      device=x.device)
    if M == 0 or N == 0:
        return out
    amode = _amode(x, residue_in)
    launch_tile(amode, EMIT_CRT_LIMBS, st, x=x.contiguous(),
                w=w.contiguous(), out=out, M=M, K=K, N=N, C=plan.k,
                srow=srow.contiguous() if srow is not None else None,
                gate=gate.contiguous() if gate is not None else None,
                name="rns_fused_crt_partial")
    rns_fused_crt_partial.launches += 1
    if amode == A_SHARED:
        rns_fused_crt_partial.raw_launches += 1
    return out


rns_fused_crt_partial.launches = 0         # every launch
rns_fused_crt_partial.raw_launches = 0     # of which raw int8
