"""The flash attention wrapper: port of
`repro/kernels/flash_attention.py::flash_attention`.

Blocked online-softmax attention over (B, H, S, D) tensors with equal head
counts for q, k and v (a caller with fewer KV heads repeats them): causal
with the frontier aligned to the end of the keys, a sliding window, a tanh
softcap, a per-sequence left ``pad``, or explicit ``qpos``/``kpos``
positions with −1 marking an invalid row.  The plain version is
`ref.attention_ref`.

Each call is one launch of one of four CUDA kernels (`flash_route`):

- ``split`` (`csrc/flash_split.cu`), Sq ≤ 16 in either type: decode.
  The keys of each (b, h) are split over a thread-block cluster of
  `split_count` blocks, each taking a contiguous run of key tiles
  (`ref.split_key_ranges`), merged through distributed shared memory.
- ``mma`` (`csrc/flash_mma.cu`), Sq > 16 in bf16: prefill on the bf16
  tensor cores (``mma.sync`` m16n8k16), 64 query rows a block.
- ``fma`` (`csrc/flash_attention.cu`), Sq > 16 in float32: float32 FMAs on
  the CUDA cores, which the float32 tolerance needs.
- ``wide`` (`csrc/flash_wide.cu`), D above 256, any Sq, either type: D
  padded to a multiple of ``WIDE_CHUNK`` (128) columns, the scores summed
  over the chunks and P·V computed per output chunk, float32 FMAs.

Each source's header says what bounds its route on an H100 and how the
design answers it.

The Pallas kernel's ``block_q``/``block_k`` (its TPU grid) and
``interpret`` have no counterpart: the CUDA kernel's tiles are fixed.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from . import _build
from .ref import SPLIT_TILE, _positions, attention_ref

__all__ = ["flash_attention", "flash_route", "split_count", "padded_head",
           "ROUTES", "HEAD_SIZES", "WIDE_CHUNK"]

# D values compiled into the first three routes; any other D up to the
# last runs on the next one with zero columns appended, and any D above it
# on the wide route at the next multiple of WIDE_CHUNK (`padded_head`)
HEAD_SIZES = (16, 32, 64, 80, 96, 128, 256)
WIDE_CHUNK = 128                     # csrc/flash_common.cuh: WIDE_CHUNK
# csrc/flash_common.cuh: flash::Route
ROUTES = ("split", "mma", "fma", "wide")
SPLIT_MAX_ROWS = 16                  # query rows the split route takes
MAX_SPLITS = 8                       # the portable cluster size
_PINNED: list[str] = []


def flash_route(Sq: int, dtype: torch.dtype, D: int = 0) -> str:
    """The kernel a call with Sq query rows of ``dtype`` at head size D
    launches (or the route pinned by `_pin_route`)."""
    if _PINNED:
        return _PINNED[-1]
    if D > HEAD_SIZES[-1]:
        return "wide"
    if Sq <= SPLIT_MAX_ROWS:
        return "split"
    return "mma" if dtype == torch.bfloat16 else "fma"


def split_count(bh: int, Sk: int, sms: int) -> int:
    """Cluster size S of the split route: enough blocks for four an SM
    over the B·H heads (72 heads on 132 SMs: 8, 576 blocks), at most 8 and
    at most the key tiles of Sk."""
    return max(1, min(MAX_SPLITS, -(-4 * sms // bh), -(-Sk // SPLIT_TILE)))


@contextlib.contextmanager
def _pin_route(route: str):
    """Every launch inside takes ``route`` (tests and `chip_smoke.py`,
    which time bf16 prefill on ``fma`` in turns with ``mma``)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    _PINNED.append(route)
    try:
        yield
    finally:
        _PINNED.pop()


def padded_head(D: int) -> int:
    """The head size a call of head size D runs at: D itself, or the next
    compiled size (above 256: the next multiple of `WIDE_CHUNK`, the wide
    route's), whose extra columns are zeros in q, k and v (a zero column
    adds an exact +0 to every score, and the output's extra columns are
    dropped)."""
    if D < 1:
        raise ValueError(f"head size must be positive, got {D}")
    for size in HEAD_SIZES:
        if D <= size:
            return size
    return -(-D // WIDE_CHUNK) * WIDE_CHUNK


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows by 16-byte copies: a view that starts off a
    16-byte boundary is copied first."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@_build.kernel_region("flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, pad=None, qpos=None,
                    kpos=None) -> torch.Tensor:
    """(B, H, Sq, D) × (B, H, Sk, D)² → (B, H, Sq, D) in q's dtype.

    Sq may differ from Sk (decode: Sq = 1 against the cached keys); query i
    sits at position ``i + Sk − Sq``.  ``pad`` (B,) masks the first
    ``pad[b]`` keys of sequence b.  ``qpos``/``kpos`` ((S,) or (B, S) int,
    −1 = invalid row) switch to explicit positions and exclude ``pad``.
    Fully masked rows are 0.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel of `flash_route` at the head size
    `padded_head` gives (the scale stays 1/√D of the true D; any D, the
    wide route above 256); a meta tensor gets an empty output of the plain
    version's shape and dtype (a dry run).  On DTensor arguments it runs
    on the local shards (`dtensor_rules`): q's batch and head shardings
    kept on q, k, v (and ``pad`` / 2-D positions), the sequences and D
    gathered.
    """
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, H, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32,
                                                            torch.bfloat16):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    explicit = qpos is not None or kpos is not None
    if pad is not None and explicit:
        raise ValueError("pad= and explicit qpos/kpos= are mutually "
                         "exclusive")
    kw = dict(causal=causal, window=window, softcap=softcap, pad=pad,
              qpos=qpos, kpos=kpos)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    Dk = padded_head(D)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    route = flash_route(Sq, q.dtype, D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :D]
    args = _build.FlashArgs()
    args.route = ROUTES.index(route)
    args.splits = (split_count(B * H, Sk, _build.num_sms(q.device.index or 0))
                   if route == "split" else 1)
    if explicit:
        ar = torch.arange(max(Sq, Sk), dtype=torch.int32, device=q.device)
        qp = _positions(qpos, ar[:Sq] + (Sk - Sq), B).contiguous()
        kp = _positions(kpos, ar[:Sk], B).contiguous()
        args.qpos, args.kpos = qp.data_ptr(), kp.data_ptr()
    if pad is not None:
        pd = torch.as_tensor(pad, dtype=torch.int32,
                             device=q.device).reshape(B).contiguous()
        args.pad = pd.data_ptr()
    args.q, args.k, args.v, args.out = (q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), out.data_ptr())
    args.B, args.H, args.Sq, args.Sk, args.D = B, H, Sq, Sk, Dk
    args.causal = int(causal)
    args.has_window, args.window = int(window is not None), int(window or 0)
    args.has_softcap = int(softcap is not None)
    args.softcap = float(softcap or 0.0)
    args.scale = 1.0 / math.sqrt(D)           # the true head size's
    args.bf16 = int(q.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.library().flash_attention_launch(ctypes.byref(args), stream)
    _build.check(rc, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out if Dk == D else out[..., :D].contiguous()


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
