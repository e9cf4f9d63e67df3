"""Bound checker: derive the RNS pipeline's dynamic ranges, don't trust them;
port of `repro/analysis/bounds.py`.

Every correctness argument in the datapath rests on a hand-derived constant:
the int8 product bound ``K·127²`` (`rns.basis_for_int8_matmul`), the signed
broadcast-operand bound ``K·128·max(m−1)`` (`ChannelPlan.for_matmul` — once
understated, for operands of −128), the chain requantize
constant ``creq = max(s_col)·K·127`` (`quant.requant_const`), and the gated
down-product ``F·127³`` (`rns.basis_for_chain`).  This pass re-derives each
of them from first principles — exact interval propagation over the
pipeline's stage semantics (`analysis.intervals`) — and cross-checks the
constants the runtime actually uses, with messages that name the violated
channel and the K at which it overflows.

What it proves per :func:`check_pipeline` configuration (basis, K, operand
bounds, residue_in/gate/emit):

  * the Stage-③ int32 accumulator of every channel stays inside int32;
  * the ``ChannelPlan`` the runtime would build covers the declared operand
    range (a plan sized for ±127 is REJECTED when operands reach −128);
  * every rung of the Stage-④ fold ladder is int32-safe and the ladder's
    exact output bound canonicalizes within the plan's ``n_sub`` subtracts;
  * the basis' dynamic range M covers the signed product (2·|y|+1 ≤ M),
    including the gated three-factor chain product;
  * every MRC digit step fits int32 and every modulus admits the 15-bit
    limb-Horner recombination (``m ≤ 2^15``);
  * the ``emit="residues"`` requantize clip is range-exact
    (``|t/creq| ≤ 127`` by bound), and is REJECTED for gated launches and
    for operand bounds above 127 — where the clip would silently saturate.

What it cannot prove: float-epilogue exactness above 2^24 (documented
dequant precision, reported as a warning, not an error) and anything about
values that left the abstract domain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import multiword as mw
from repro_torch.core.channel_plan import ChannelPlan
from repro_torch.core.folding import INT32_SAFE

from .findings import Report
from .intervals import Interval

__all__ = ["PipelineSpec", "check_pipeline", "check_channel_plan",
           "pipeline_specs_for"]

_QMAX = 127          # quantize_int8's symmetric clip (core/quant.QMAX)
_F32_EXACT = 1 << 24  # float32 integer-exactness limit of the dequant


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """One (basis, K, operand-range, variant) configuration to verify.

    ``x_bound``/``w_bound`` are the *declared* operand magnitudes: 127 for
    self-quantized tensors (`quantize_int8` never emits −128), 128 for
    externally supplied int8 (`RNSTensor.from_int8`, `rns_int_matmul`'s
    advertised contract).  ``gate_bound`` only matters with ``gate=True``.
    """

    moduli: Tuple[int, ...]
    k: int                        # contraction depth K
    x_bound: int = 128
    w_bound: int = 128
    residue_in: bool = False      # chained canonical-residue activations
    gate: bool = False            # fused elementwise modular gate
    emit: str = "float"           # float | residues
    basis_m: Optional[int] = None  # dynamic range Π m (None: non-coprime set)
    label: str = "pipeline"

    @classmethod
    def for_basis(cls, basis, k: int, **kw) -> "PipelineSpec":
        return cls(moduli=tuple(int(m) for m in basis.moduli), k=int(k),
                   basis_m=basis.M, label=kw.pop("label", basis.name), **kw)


def _value_bound(spec: PipelineSpec) -> Interval:
    """The exact integer result interval |y| ≤ K·x·(gate·)w — the quantity
    the basis' dynamic range and the requantize constant must cover."""
    x = Interval.symmetric(spec.x_bound)
    if spec.gate:
        x = x * Interval.symmetric(_QMAX)
    return x.dot(Interval.symmetric(spec.w_bound), spec.k)


def check_pipeline(spec: PipelineSpec) -> Tuple[Report, Dict[str, Interval]]:
    """Propagate exact intervals through quantize → forward → dot → fold →
    requant/MRC for one configuration; return (report, per-stage bounds).

    The returned stage map is part of the contract: the adversarial corpus
    pins its entries to the saturated-corner values the kernel tests hit
    (tight, not merely sound).
    """
    rep = Report(subject=f"bounds:{spec.label}")
    stages: Dict[str, Interval] = {}
    mods = spec.moduli
    k = spec.k

    # Stage ② — operands.  Activations: symmetric ±x_bound (quantize clip or
    # external int8); weights forward-convert to canonical [0, m) residues.
    x_iv = Interval.symmetric(spec.x_bound)
    stages["x"] = x_iv
    stages["w"] = Interval.symmetric(spec.w_bound)

    # Gate prologue (residue-in only): |q_x·q_g|_m per channel — the int32
    # product of two canonical factors must not wrap before the mod.
    if spec.gate:
        if not spec.residue_in:
            rep.add("bounds", spec.label,
                    "gate= requires the residue-in datapath (float/int8 "
                    "activations gate before quantize)")
        worst = max((m - 1) * (m - 1) for m in mods)
        stages["gate_product"] = Interval(0, worst)
        if worst > INT32_SAFE:
            bad = max(mods)
            rep.add("bounds", f"channel m={bad}",
                    f"gate product (m−1)²={worst} exceeds int32 before the "
                    f"modular reduction")

    # Stage ③ — the per-channel int32 accumulator, channel by channel.
    acc_by_channel = []
    for m in mods:
        if spec.residue_in:
            # canonical × canonical: [0, K·(m−1)²]
            acc = Interval.canonical(m).dot(Interval.canonical(m), k)
        else:
            # signed broadcast-operand: [−K·x_bound·(m−1), +K·x_bound·(m−1)]
            acc = x_iv.dot(Interval.canonical(m), k)
        acc_by_channel.append(acc)
        acc_abs = acc.max_abs
        assert acc_abs is not None
        if acc_abs > INT32_SAFE:
            rep.add("bounds", f"channel m={m}",
                    f"int32 accumulator overflow at K={k}: |acc| reaches "
                    f"{acc_abs} > 2^31−1 (operand bound "
                    f"±{spec.x_bound}); shrink K or the channel width")
    stages["accumulator"] = acc_by_channel[
        max(range(len(mods)), key=lambda i: acc_by_channel[i].max_abs or 0)]

    # The plan the runtime would build for this launch — its hand-written
    # bound constant must cover the derived accumulator range (a plan
    # sized for ±127 against −128 operands fails exactly here).
    plan = None
    try:
        plan = ChannelPlan.for_matmul(mods, k, signed=not spec.residue_in)
    except ValueError as e:
        rep.add("bounds", spec.label, f"ChannelPlan.for_matmul refuses this "
                f"configuration: {e}")
    if plan is not None:
        derived = max(iv.max_abs or 0 for iv in acc_by_channel)
        if plan.bound < derived:
            rep.add("bounds", spec.label,
                    f"ChannelPlan bound understates the operand range: "
                    f"plan.bound={plan.bound} < derived |acc| ≤ {derived} "
                    f"at K={k} (operands reach ±{spec.x_bound})")
        rep.extend(check_channel_plan(plan, operand_bound=derived)[0])

    # Dynamic range: the signed embedding needs M ≥ 2·|y| + 1, with |y| the
    # full (possibly gated) integer product.
    y_iv = _value_bound(spec)
    stages["value"] = y_iv
    y_abs = y_iv.max_abs
    assert y_abs is not None
    if spec.basis_m is not None:
        need = 2 * y_abs + 1
        if spec.basis_m < need:
            what = "gated chain product K·x·g·w" if spec.gate else \
                "K-deep product K·x·w"
            rep.add("bounds", spec.label,
                    f"dynamic range deficit: basis M={spec.basis_m} < {need} "
                    f"required for the {what} at K={k} (|y| ≤ "
                    f"{y_abs}); size the basis with "
                    f"rns.basis_for_chain/basis_for_accumulation")
        if y_abs >= _F32_EXACT:
            rep.add("bounds", spec.label,
                    f"|y| ≤ {y_abs} exceeds 2^24: the float32 dequant "
                    f"epilogue is not integer-exact at the corners "
                    f"(documented accelerator dequant precision)",
                    severity="warning")

        # MRC reverse: digit-step products and the limb-Horner admissibility.
        mx = max(mods)
        for mj in mods:
            step = max(mx, mj) * mj
            if step > INT32_SAFE:
                rep.add("bounds", f"channel m={mj}",
                        f"MRC digit step max(m_i, m_j)·m_j = {step} exceeds "
                        f"int32")
            if mj > mw.MAX_HORNER_MODULUS:
                rep.add("bounds", f"channel m={mj}",
                        f"modulus exceeds the 15-bit limb-Horner bound "
                        f"m ≤ {mw.MAX_HORNER_MODULUS}: the device MRC path "
                        f"cannot host this channel")
        nl = mw.nlimbs_for(spec.basis_m)
        stages["mrc_limbs"] = Interval(0, spec.basis_m - 1)
        if (1 << (15 * nl)) <= spec.basis_m:
            rep.add("bounds", spec.label,
                    f"limb count {nl} cannot represent the dynamic range "
                    f"M={spec.basis_m}")

    # emit="residues" — the in-domain requantize: q' = clip(round(t/creq))
    # with t = y·s_col and creq = max(s_col)·K·127.  |t/creq| ≤
    # x_bound·(gate·)w_bound/127 — range-exact iff that ratio ≤ 127.
    if spec.emit == "residues":
        num = spec.x_bound * spec.w_bound * (_QMAX if spec.gate else 1)
        q_hi = -(-num // _QMAX)        # ceil — exact worst-case |q'| pre-clip
        stages["requant"] = Interval.symmetric(min(q_hi, _QMAX))
        if num > _QMAX * _QMAX:
            why = ("the gated three-factor product needs a K·127³-sized "
                   "requantize bound" if spec.gate else
                   f"operand bound ±{spec.x_bound}·±{spec.w_bound} exceeds "
                   f"the 127² the requantize constant creq = max(s_col)·K·"
                   f"127 is sized for")
            rep.add("bounds", spec.label,
                    f"emit='residues' clip is NOT range-exact: |t/creq| "
                    f"reaches {num}/{_QMAX} > 127 — {why}")
    return rep, stages


def check_channel_plan(plan: ChannelPlan, *,
                       operand_bound: Optional[int] = None
                       ) -> Tuple[Report, Dict[int, Interval]]:
    """Independently re-prove a fold plan: replay every channel's rung
    ladder over exact intervals starting from the plan's declared bound
    (or a caller-supplied accumulator bound), checking int32 safety of each
    rung and that the final bound canonicalizes within ``n_sub`` subtracts.

    Passing ``operand_bound`` larger than ``plan.bound`` flags the plan as
    undersized — how the adversarial corpus detects a plan sized for ±127
    against signed −128 operands."""
    rep = Report(subject=f"bounds:plan C={plan.k}")
    finals: Dict[int, Interval] = {}
    start = plan.bound
    if operand_bound is not None and operand_bound > plan.bound:
        rep.add("bounds", f"plan bound={plan.bound}",
                f"plan is undersized: accumulators reach |acc| ≤ "
                f"{operand_bound} but the fold schedule only covers "
                f"{plan.bound} — the ladder can under-fold")
        start = operand_bound          # show the consequences downstream
    for c, m in enumerate(plan.moduli):
        iv = Interval(0, start)        # signed plans fold |acc|: nonnegative
        for s, cc in plan.rungs[c]:
            assert iv.hi is not None
            step_hi = (iv.hi >> s) * cc
            if step_hi > INT32_SAFE:
                rep.add("bounds", f"channel m={m}",
                        f"fold rung (s={s}, c={cc}) overflows int32: "
                        f"hi·c = {step_hi}")
            iv = iv.rung(s, cc)
        finals[m] = iv
        assert iv.hi is not None
        if iv.hi >= (plan.n_sub + 1) * m:
            rep.add("bounds", f"channel m={m}",
                    f"ladder output bound {iv.hi} needs more than the "
                    f"plan's n_sub={plan.n_sub} conditional subtracts to "
                    f"reach [0, {m})")
    return rep, finals


# ----------------------------------------------- config-zoo enumeration ----
def pipeline_specs_for(cfg) -> Sequence[PipelineSpec]:
    """Enumerate the pipeline configurations a ModelConfig's decode path
    launches — mirroring the dispatch in `models/{transformer,layers}.py`
    (the port's dense stack: full attention and a GLU MLP in every layer)
    — as :class:`PipelineSpec`s ready for :func:`check_pipeline`.

    Float-domain rns launches are checked at the *advertised* ±128 external-
    int8 contract (`rns.basis_for_int8_matmul`'s sizing); residue-resident
    chain launches at the ±127 bound the requantize/encode path guarantees
    (`quant.quantize_int8` never emits −128).
    """
    spec = cfg.linear_spec
    if not spec.is_rns:
        return []
    from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul

    d, F = cfg.d_model, cfg.d_ff
    H, dh = cfg.num_heads, cfg.head_dim
    out, seen = [], set()

    def add(ps: PipelineSpec):
        key = dataclasses.astuple(ps)
        if key not in seen:
            seen.add(key)
            out.append(ps)

    if spec.domain == "residue":
        add(PipelineSpec.for_basis(
            basis_for_int8_matmul(d), d, x_bound=127, w_bound=127,
            residue_in=True, label=f"{cfg.name}:qkv-chain"))
        add(PipelineSpec.for_basis(
            basis_for_int8_matmul(H * dh), H * dh, label=f"{cfg.name}:wo"))
        if F > 0:
            cb = basis_for_chain(F)
            add(PipelineSpec.for_basis(
                cb, d, x_bound=127, w_bound=127, residue_in=True,
                label=f"{cfg.name}:mlp-gate/up"))
            add(PipelineSpec.for_basis(
                cb, d, x_bound=127, w_bound=127, residue_in=True,
                emit="residues", label=f"{cfg.name}:mlp-up-emit"))
            add(PipelineSpec.for_basis(
                cb, F, x_bound=127, w_bound=127, residue_in=True, gate=True,
                label=f"{cfg.name}:mlp-gated-down"))
    else:
        ks = {d, H * dh}
        if F > 0:
            ks |= {d, F}
        for K in sorted(ks):
            add(PipelineSpec.for_basis(basis_for_int8_matmul(K), K,
                                       label=f"{cfg.name}:K{K}"))
    return out
