"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with plain tensor
ops, so it runs on the CPU and on the card.  The wrappers take these only
for tensors that lie on the CPU; the tests and `chip_smoke.py` hold each
kernel against its plain version bit for bit.

Channel products run in float64 and are cast back to int32: every partial
sum is an integer below K·128·46 (signed operands) or K·46² (canonical
residues), far below 2^53, so the float64 product is exact on any device
and in any summation order.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from repro_torch.core import multiword as mw
from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import QMAX, quantize_int8, requant_const

__all__ = ["rns_forward_ref", "rns_fused_matmul_ref", "rns_matmul_ref",
           "rns_modmul_ref", "rns_reverse_ref", "rns_fused_chain_ref",
           "rns_fused_crt_partial_ref", "fold_ref", "attention_ref",
           "split_key_ranges", "attention_split_ref"]

NEG_INF = -1e30
SPLIT_TILE = 64      # keys: the unit the flash split route shares out


def rns_forward_ref(x: torch.Tensor, moduli: Sequence[int],
                    dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(…,) int → (C, …) floored residues ``|x|_{m_c}`` in ``dtype``."""
    mods = torch.tensor([int(m) for m in moduli], dtype=torch.int32,
                        device=x.device).reshape((-1,) + (1,) * x.ndim)
    return torch.remainder(x.to(torch.int32)[None], mods).to(dtype)


def _channel_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def _channel_products(x: torch.Tensor, w: torch.Tensor, moduli,
                      scale_row: torch.Tensor | None,
                      gate: torch.Tensor | None):
    """The fused kernel's per-channel int32 accumulators, unfolded, one per
    modulus: the quantized (M, K) float ``x``, the raw signed (M, K) int8
    ``x`` shared by every channel, or channel c of the (C, M, K) residues
    ``x`` (times ``|gate|_m`` when gated), against channel c of ``w``: the
    (C, K, N) residues, or the raw (K, N) int8 weight's residues in the
    channel's modulus."""
    w_res = w if w.ndim == 3 else rns_forward_ref(w, moduli)
    if x.ndim == 2:
        q = (x.to(torch.int32) if x.dtype == torch.int8 else
             torch.clamp(torch.round(x.to(torch.float32) / scale_row),
                         -QMAX, QMAX))
    for c, m in enumerate(moduli):
        if x.ndim == 2:
            a = q
        else:
            a = x[c].to(torch.int32)
            if gate is not None:
                a = torch.remainder(
                    torch.remainder(gate.to(torch.int32), m) * a, m)
        yield _channel_dot(a, w_res[c])


def rns_fused_matmul_ref(x: torch.Tensor, w: torch.Tensor, basis, *,
                         scale_row: torch.Tensor | None = None,
                         scale_col: torch.Tensor | None = None,
                         scale: torch.Tensor | None = None,
                         gate: torch.Tensor | None = None,
                         creq: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the fused kernel.

    ``x`` is (M, K) float (quantize prologue: round/clip by ``scale_row``,
    signed fold plan), (M, K) raw signed int8 (shared by every channel,
    signed fold plan) or the (C, M, K) canonical int8 residues of an
    activation (residue-in: unsigned fold plan), whose channels are
    multiplied by ``|gate|_m`` when a raw int8 (M, K) ``gate`` is given.
    ``w`` is (C, K, N) canonical residues or (K, N) raw int8.  With
    ``creq`` (0-d) the epilogue requantizes in the domain and returns the
    (C, M, N) int8 residues of clip(round(y·s_col / creq), ±127); otherwise
    it returns (M, N) float32 ``((y·s_row)·s_col)·scale``, each factor
    left out when it is None (the exact product when all are).
    """
    moduli = tuple(int(m) for m in basis.moduli)
    K = x.shape[-1]
    residue_in = x.ndim == 3
    plan = ChannelPlan.for_matmul(moduli, K, signed=not residue_in)
    conv = ConversionPlan.for_basis(basis)
    res = [plan.fold(acc, c) for c, acc in enumerate(
        _channel_products(x, w, moduli, scale_row, gate))]
    val = conv.reverse_plain(torch.stack(res))
    if creq is not None:
        q = torch.clamp(torch.round((val * scale_col) / creq), -QMAX, QMAX)
        return rns_forward_ref(q.to(torch.int32), moduli, torch.int8)
    return float_epilogue(val, scale_row, scale_col, scale)


def float_epilogue(val: torch.Tensor, scale_row=None, scale_col=None,
                   scale=None) -> torch.Tensor:
    """The fused kernel's float epilogue on the exact product ``val``:
    ``((val·s_row)·s_col)·scale`` in that order, each factor left out when
    it is None."""
    for f in (scale_row, scale_col, scale):
        if f is not None:
            val = val * f
    return val


def rns_matmul_ref(a_res: torch.Tensor, b_res: torch.Tensor,
                   moduli: Sequence[int], *, signed_a: bool = False,
                   plan: ChannelPlan | None = None) -> torch.Tensor:
    """(C or 1, M, K) × (C, K, N) → (C, M, N) int32 canonical residues of the
    per-channel products, folded once by ``plan`` (default
    ``for_matmul(moduli, K, signed=signed_a)``).  A one-plane ``a_res`` is
    the raw signed int8 activation shared by every channel."""
    mods = tuple(int(m) for m in moduli)
    plan = plan or ChannelPlan.for_matmul(mods, a_res.shape[-1],
                                          signed=signed_a)
    return torch.stack([
        plan.fold(_channel_dot(a_res[c if a_res.shape[0] > 1 else 0],
                               b_res[c]), c)
        for c in range(len(mods))])


def rns_modmul_ref(a_res: torch.Tensor, b_res: torch.Tensor,
                   moduli: Sequence[int], *,
                   out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """|a·b|_{m_c} elementwise over (C, …) residues: one int32 product and
    the ``ChannelPlan.for_product`` fold ladder → int32, cast to
    ``out_dtype``."""
    plan = ChannelPlan.for_product(tuple(int(m) for m in moduli))
    p = a_res.to(torch.int32) * b_res.to(torch.int32)
    return torch.stack([plan.apply_ladder(p[c], c)
                        for c in range(plan.k)]).to(out_dtype)


def rns_reverse_ref(residues: torch.Tensor, plan: ConversionPlan,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C, …) canonical residues → (…) float32 signed values (times
    ``scale``): `ConversionPlan.reverse_plain`."""
    return plan.reverse_plain(residues.to(torch.int32), scale)


def rns_fused_chain_ref(x: torch.Tensor, w_gate, w_up, w_down, basis,
                        act: Callable[[torch.Tensor], torch.Tensor]):
    """The residue-resident GLU MLP written as the UNCHAINED per-linear
    composition (port of `repro/kernels/ref.rns_fused_chain_ref`): each
    linear quantizes, forward-converts, multiplies canonical residues and
    leaves through the MRC reverse, and the up projection's exit applies the
    same `requant_const` round/clip as the chained ``emit="residues"``
    epilogue.  ``x`` is the float (M, K) input; the weights are
    :class:`RNSTensor`s in ``basis`` (the chain basis)."""
    moduli = tuple(int(m) for m in basis.moduli)
    conv = ConversionPlan.for_basis(basis)
    K, F = x.shape[-1], w_up.residues.shape[-1]
    plan_k = ChannelPlan.for_matmul(moduli, K, signed=False)
    plan_f = ChannelPlan.for_matmul(moduli, F, signed=False)

    def linear(a_res, wt, plan):
        return conv.reverse_plain(
            rns_matmul_ref(a_res, wt.residues, moduli, plan=plan))

    xq, sx = quantize_int8(x, dim=-1)
    x_res = rns_forward_ref(xq, moduli, torch.int8)
    y_gate = (linear(x_res, w_gate, plan_k) * sx) * w_gate.scale
    gq, sg = quantize_int8(act(y_gate), dim=-1)
    creq = requant_const(w_up.scale, K)
    t = linear(x_res, w_up, plan_k) * w_up.scale
    q_up = torch.clamp(torch.round(t / creq), -QMAX, QMAX)
    s_up = sx * creq
    u_res = rns_forward_ref(q_up.to(torch.int32), moduli, torch.int8)
    g_res = rns_forward_ref(gq, moduli, torch.int8)
    a_res = rns_modmul_ref(u_res, g_res, moduli).to(torch.int8)
    return (linear(a_res, w_down, plan_f) * (s_up * sg)) * w_down.scale


def rns_fused_crt_partial_ref(x: torch.Tensor, w: torch.Tensor, *,
                              plan: ChannelPlan, mods: Sequence[int],
                              sched, crt_v: Sequence[int], crt_mc,
                              scale_row: torch.Tensor | None = None,
                              gate: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain version of the channel-slice kernel: Stage ②–④ on the slice,
    then the CRT partial sum Σ_j |r_j·v_j|_{m_j}·(M/m_j) as (L1, M, N)
    int32 15-bit limb planes, carried after every channel.

    ``x`` is (M, K) float (quantized by ``scale_row`` (M, 1), signed fold),
    (M, K) raw signed int8 (signed fold) or the (C_l, M, K) canonical int8
    residues of the slice (unsigned fold, times ``|gate|_m`` when gated);
    ``w`` the (C_l, K, N) residue slice or the raw (K, N) int8 weight,
    converted in the slice's moduli.
    ``plan`` gives the rung count, ``n_sub`` and signedness; ``mods``,
    ``sched`` (C_l, R, 2), ``crt_v`` (C_l,) and ``crt_mc`` (C_l, L1) are
    the slice's own tables.
    """
    mods = [int(m) for m in mods]
    L1 = len(crt_mc[0])
    limbs = [torch.zeros((x.shape[-2], w.shape[-1]), dtype=torch.int32,
                         device=x.device) for _ in range(L1)]
    for j, acc in enumerate(_channel_products(x, w, mods, scale_row, gate)):
        m = mods[j]
        r = plan.fold(acc, sched=sched[j], m=m)
        alpha = torch.remainder(r * int(crt_v[j]), m)
        carry = torch.zeros_like(alpha)
        for l in range(L1):
            v = limbs[l] + int(crt_mc[j][l]) * alpha + carry
            limbs[l] = v & mw.LIMB_MASK
            carry = v >> mw.LIMB_BITS
    return torch.stack(limbs)


def fold_ref(x: torch.Tensor, moduli: Sequence[int],
             bound: int) -> torch.Tensor:
    """(C, …) int32 values in [0, bound) → canonical residues per channel:
    the ``ChannelPlan.build(moduli, bound)`` ladder."""
    plan = ChannelPlan.build(tuple(int(m) for m in moduli), int(bound))
    return torch.stack([plan.apply_ladder(x[c].to(torch.int32), c)
                        for c in range(plan.k)])


def _positions(p, default: torch.Tensor, B: int) -> torch.Tensor:
    """(S,) or (B, S) int positions (``default`` when None) as a (B, S)
    int32 view."""
    p = default if p is None else torch.as_tensor(p, dtype=torch.int32,
                                                  device=default.device)
    if p.ndim not in (1, 2) or p.shape[-1] != default.shape[0]:
        raise ValueError(f"positions must be ({default.shape[0]},) or (B, "
                         f"{default.shape[0]}), got {tuple(p.shape)}")
    return (p[None] if p.ndim == 1 else p).expand(B, -1)


def attention_mask(B: int, Sq: int, Sk: int, *, causal: bool = True,
                   window: int | None = None, pad=None, qpos=None,
                   kpos=None, device=None) -> torch.Tensor:
    """(B, Sq, Sk) bool mask of `attention_ref` and the flash kernel.

    Implicit positions put query i at ``i + Sk − Sq`` (the causal frontier
    aligned to the end of the keys) and key j at ``j``; ``pad`` (B,) masks
    keys below ``pad[b]``.  Explicit ``qpos``/``kpos`` ((S,) or (B, S)
    int, −1 = invalid row) replace them and exclude ``pad``.
    """
    explicit = qpos is not None or kpos is not None
    if explicit and pad is not None:
        raise ValueError("pad= and explicit qpos/kpos= are mutually "
                         "exclusive")
    qp = _positions(qpos, torch.arange(Sq, dtype=torch.int32, device=device)
                    + (Sk - Sq), B)[:, :, None]
    kp = _positions(kpos, torch.arange(Sk, dtype=torch.int32, device=device),
                    B)[:, None, :]
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=device)
    if explicit:
        mask = mask & (kp >= 0) & (qp >= 0)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    if pad is not None:
        pad = torch.as_tensor(pad, dtype=torch.int32, device=device)
        mask = mask & (kp >= pad[:, None, None])
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  pad=None, qpos=None, kpos=None) -> torch.Tensor:
    """Plain version of the flash kernel: (B, H, Sq, D), (B, H, Sk, D)² →
    (B, H, Sq, D) in q's dtype, port of `repro/kernels/ref.attention_ref`.

    Scores ``q·k·scale`` (default 1/√D; a call padded to a larger head
    size keeps the true D's), ``tanh(s/c)·c`` under ``softcap``, masked scores
    set to −1e30, softmax, fully masked rows zero.  The products run in
    float32 whatever the input type, as the kernel (and the JAX package's
    Pallas kernel) computes them; the JAX reference multiplies bf16 inputs
    in bf16, which the bf16 tolerance covers.
    """
    B, _, Sq, D = q.shape
    Sk = k.shape[-2]
    mask = attention_mask(B, Sq, Sk, causal=causal, window=window, pad=pad,
                          qpos=qpos, kpos=kpos, device=q.device)[:, None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (
                         1.0 / math.sqrt(D) if scale is None else scale)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask.any(-1, keepdim=True), torch.softmax(s, -1), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def split_key_ranges(Sq: int, Sk: int, splits: int, *, pad: int = 0,
                     window: int | None = None, explicit: bool = False
                     ) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) of the flash kernel's split route, one per
    cluster rank, for one sequence of the batch (its ``pad``).

    The keys the Sq rows can reach are [k_lo, Sk): k_lo is the pad and the
    window's edge for the first row (query i sits at i + Sk − Sq; the last
    row at Sk − 1 reaches every key under a causal mask), or 0 with
    explicit positions.  Its SPLIT_TILE-key tiles are shared out in
    contiguous runs, rank r taking tiles [n·r/S, n·(r+1)/S) of the n;
    a rank with no tile gets an empty range.  `csrc/flash_split.cu`
    (``split_range``) computes the same ranges on the card.
    """
    k_lo, k_hi = 0, Sk
    if not explicit:
        if window is not None:
            k_lo = max(k_lo, Sk - Sq - window + 1)
        k_lo = max(k_lo, int(pad))
    if k_hi <= k_lo:
        return [(k_lo, k_lo)] * splits
    t_lo = k_lo // SPLIT_TILE
    n = -(-k_hi // SPLIT_TILE) - t_lo
    out = []
    for r in range(splits):
        lo = max(k_lo, (t_lo + n * r // splits) * SPLIT_TILE)
        hi = max(lo, min(k_hi, (t_lo + n * (r + 1) // splits) * SPLIT_TILE))
        out.append((lo, hi))
    return out


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, splits: int, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None, pad=None, qpos=None,
                        kpos=None) -> torch.Tensor:
    """The flash split route's decomposition with plain ops (tests only):
    per rank of `split_key_ranges`, the masked softmax partial (m, l, acc)
    over its keys, in float32; then the merge M = max m_r,
    out = Σ acc_r·e^(m_r − M) / Σ l_r·e^(m_r − M), fully masked rows 0.
    Equal to `attention_ref` up to float32 rounding."""
    B, _, Sq, D = q.shape
    Sk = k.shape[-2]
    explicit = qpos is not None or kpos is not None
    mask = attention_mask(B, Sq, Sk, causal=causal, window=window, pad=pad,
                          qpos=qpos, kpos=kpos, device=q.device)[:, None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(D))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    pads = [0] * B if pad is None else [int(p) for p in torch.as_tensor(
        pad).reshape(B)]
    ranges = [split_key_ranges(Sq, Sk, splits, pad=pads[b], window=window,
                               explicit=explicit) for b in range(B)]
    parts = []
    for r in range(splits):
        member = torch.zeros((B, 1, 1, Sk), dtype=torch.bool,
                             device=q.device)
        for b in range(B):
            lo, hi = ranges[b][r]
            member[b, ..., lo:hi] = True
        valid = mask & member
        sm = torch.where(valid, s, NEG_INF)
        m = sm.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(sm - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhqk,bhkd->bhqd", p,
                                   v.to(torch.float32))))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(acc * torch.exp(m - M) for m, _, acc in parts)
    den = sum(l * torch.exp(m - M) for m, l, _ in parts)
    return (num / torch.where(den == 0, 1.0, den)).to(q.dtype)
