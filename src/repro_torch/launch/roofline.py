"""Roofline of one dry-run cell on one NVIDIA H100, port of
`repro/launch/roofline.py`:

    compute    = flops/device ÷ 989 TFLOP/s  + int8 ops/device ÷ 1,979 TOP/s
    memory     = HBM bytes/device ÷ 3.35 TB/s
    collective = interconnect bytes/device ÷ 450 GB/s (NVLink, one way) on
                 one card's cell; ÷ 50 GB/s (one 400 Gb/s InfiniBand NDR
                 port a GPU, one way) on the 16×16 and 2×16×16 meshes,
                 whose 16-wide axes each leave an 8-GPU NVLink domain

The terms come from the loop-correct analytic model (`launch/costs.py`,
``record["analytic"]``), else from the step's trace (``record["cost"]``:
the float flops of its aten ops outside the kernels and the kernels'
operations, `analysis/residency.py`).  MODEL_FLOPS is 6·N·D (train),
2·N·D (prefill) or 2·N_active·B (decode); MODEL_FLOPS over the counted
flops exposes remat recompute and padding or dispatch waste.

`collective_bytes` prices the collectives a mesh cell's trace recorded
(`analysis.residency.TraceSummary.wire`: op, output bytes, group size) by
the reference's ring model, which the reference applies to the compiled
HLO text's collectives:

    all-reduce      2·(n−1)/n · bytes        (reduce-scatter + all-gather)
    all-gather        (n−1)/n · bytes(output)
    reduce-scatter    (n−1)   · bytes(output)   (= (n−1)/n · input)
    all-to-all        (n−1)/n · bytes
    collective-permute        1 · bytes

There is no ``loop_trip``: the reference's HLO holds a scanned layer's
body once and multiplies its collectives by the trip count, while the
eager trace runs every layer and records each collective it issues.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity) at the 700 W
# limit; a card set to a lower power limit runs below them.
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores, FLOP/s
PEAK_INT8_OPS = 1979e12      # int8 tensor cores, OP/s
F32_FLOPS = 67e12            # float32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, bytes/s
HBM_BYTES = 80e9             # device memory, bytes
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s both ways, bytes/s one way
# NVIDIA ConnectX-7 / Quantum-2 data sheet: one 400 Gb/s InfiniBand NDR
# port a GPU (the DGX H100 layout), bytes/s one way; every 16-wide mesh
# axis spans two 8-GPU NVLink domains, so its ring runs at this rate
IB_BW = 50e9

__all__ = ["PEAK_FLOPS", "PEAK_INT8_OPS", "F32_FLOPS", "HBM_BW", "HBM_BYTES",
           "NVLINK_BW", "IB_BW", "Roofline", "analyze", "model_flops_for",
           "collective_bytes", "link_bw", "format_table", "load_records"]


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    flops_per_dev: float         # counted flops + int8 ops a device
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-at-peak time ÷ bound time."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s if self.bound_s else 0.0


def collective_bytes(collectives) -> Dict[str, float]:
    """Per-device wire bytes by op under the ring model, and each op's
    output bytes as ``<op>_output_bytes``, the reference's keys;
    ``collectives`` is ((op, output bytes, group size), ...) with the
    reference's HLO op names."""
    out: Dict[str, float] = {}
    raw: Dict[str, float] = {}
    for op, b, n in collectives:
        n = max(1, int(n))
        if op == "all-reduce":
            wire = 2.0 * (n - 1) / n * b
        elif op == "all-gather":
            wire = (n - 1) / n * b
        elif op == "reduce-scatter":
            wire = float(n - 1) * b
        elif op == "all-to-all":
            wire = (n - 1) / n * b
        elif op == "collective-permute":
            wire = float(b)
        else:
            raise ValueError(f"unknown collective {op!r}")
        out[op] = out.get(op, 0.0) + wire
        raw[op + "_output_bytes"] = raw.get(op + "_output_bytes", 0.0) + b
    out.update(raw)
    return out


def link_bw(record: dict) -> float:
    """The interconnect rate that prices a record's collective term: NVLink
    on one card's cell, the per-GPU InfiniBand port on a mesh."""
    return NVLINK_BW if record.get("n_devices", 1) == 1 else IB_BW


def analyze(record: dict) -> Roofline:
    """Roofline terms for one dry-run record: the analytic model's when the
    record has one, else the trace's (flops, kernel operations and the
    traced collectives; a meta trace moves no HBM bytes)."""
    chips = record["n_devices"]
    an = record.get("analytic")
    if an:
        flops_s = (an["flops"] / PEAK_FLOPS
                   + an.get("flops_int8", 0.0) / PEAK_INT8_OPS)
        mem_s = an["hbm_bytes"] / HBM_BW
        coll_s = an["ici_bytes"] / link_bw(record)
        flops_per_dev = an["flops"] + an.get("flops_int8", 0.0)
    else:
        cost = record.get("cost", {})
        flops_s = (cost.get("flops", 0.0) / PEAK_FLOPS
                   + cost.get("int8_ops", 0.0) / PEAK_INT8_OPS)
        mem_s = 0.0
        coll_s = sum(v for k, v in record.get("collectives", {}).items()
                     if not k.endswith("_output_bytes")) / link_bw(record)
        flops_per_dev = cost.get("flops", 0.0) + cost.get("int8_ops", 0.0)
    return Roofline(compute_s=flops_s, memory_s=mem_s, collective_s=coll_s,
                    model_flops=record.get("model_flops", 0.0),
                    flops_per_dev=flops_per_dev, chips=chips)


def model_flops_for(cfg, shape, n_params: int, n_active: int) -> float:
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_params * tokens if not cfg.moe \
            else 6.0 * n_active * tokens
    if shape.kind == "prefill":
        n = n_active if cfg.moe else n_params
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    n = n_active if cfg.moe else n_params
    return 2.0 * n * shape.global_batch


def format_table(records: List[dict]) -> str:
    rows = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s)"
            " | dominant | MODEL/counted | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r.get("status") != "ok":
            why = r.get("reason") or r.get("error", "")
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{r.get('status', '').upper()} ({why}) | | | | | |")
            continue
        a = analyze(r)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {a.compute_s:.3e} | {a.memory_s:.3e} | {a.collective_s:.3e} "
            f"| **{a.dominant}** | {a.useful_ratio:.2f} "
            f"| {a.roofline_fraction:.3f} |")
    return "\n".join(rows)


def load_records(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
