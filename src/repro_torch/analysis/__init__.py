"""`repro_torch.analysis` — static analysis of the port's RNS pipeline,
port of `repro/analysis`.

Three passes and a schema check, one vocabulary:

  * **bounds** — exact interval derivation of every dynamic-range constant
    (accumulators, fold rungs, MRC limbs, requant clips) for a (basis, K,
    operand-bound, variant) configuration, plus an interval interpreter
    over the aten ops of a traced call (`absint`);
  * **residency** — structural invariants of a traced call (no modular
    reduction outside a kernel region, exactly N kernel calls, no host
    sync in a step, no residue slab on a sharded step's wire), from a
    ``TorchDispatchMode`` trace;
  * **admissibility** — each tile launch's (tile height, K splits) against
    the kernel's constants (compiled heights, cluster size, shared memory,
    the 32-row tile's channels and alignment), plan-table moduli limits,
    the committed tune-table rows; `schema` validates the committed JSON
    artifacts the runtime trusts.

Entry points: :func:`assert_clean` (tests), :func:`lint.check_config`
(``Engine(verify="static")``) and ``python -m repro_torch.analysis.lint
--all-configs``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

from .absint import AbsintResult, check_fn_bounds, interpret
from .admissibility import (check_basis_tables, check_config_launches,
                            check_launch, check_tune_table)
from .bounds import (PipelineSpec, check_channel_plan, check_pipeline,
                     pipeline_specs_for)
from .findings import AnalysisError, Finding, Report, merged
from .intervals import TOP, Interval, dtype_range
from .lint import check_config
from .residency import (TraceMode, TraceSummary, check_kernel_count,
                        check_no_callbacks, check_reduced_wire,
                        check_resident, summarize_fn)
from .schema import (validate_bench, validate_bench_file, validate_tune_table,
                     validate_tune_table_file)

__all__ = [
    "AnalysisError", "Finding", "Report", "merged",
    "Interval", "TOP", "dtype_range",
    "PipelineSpec", "check_pipeline", "check_channel_plan",
    "pipeline_specs_for",
    "check_fn_bounds", "interpret", "AbsintResult",
    "TraceSummary", "TraceMode", "summarize_fn", "check_resident",
    "check_kernel_count", "check_no_callbacks", "check_reduced_wire",
    "check_launch", "check_basis_tables", "check_tune_table",
    "check_config_launches",
    "validate_bench", "validate_bench_file", "validate_tune_table",
    "validate_tune_table_file",
    "check_config", "assert_clean",
]


def assert_clean(fn, spec, *example_args, resident: Optional[bool] = None,
                 expect_kernel_calls: Union[int, Dict[str, int], None] = None,
                 require_no_sync: bool = False,
                 subject: str = "assert_clean", **example_kwargs) -> Report:
    """One-call static gate for a traced computation and its configuration.

    ``spec`` drives the bound pass: a :class:`PipelineSpec` is checked
    directly; a ``ModelConfig`` expands to every pipeline its decode path
    launches (and its launches admitted); ``None`` checks nothing.  ``fn``
    (with example args) runs once under the residency pass
    (`residency.summarize_fn`): residency when ``resident`` (default: a
    residue-domain spec), the exact kernel calls (in all, or a dict by
    wrapper) when ``expect_kernel_calls`` is given, and no host sync when
    ``require_no_sync``.  Raises :class:`AnalysisError` listing every
    violated invariant; returns the full report (warnings included) when
    clean."""
    reports = []
    if isinstance(spec, PipelineSpec):
        reports.append(check_pipeline(spec)[0])
        reports.append(check_basis_tables(spec.moduli, subject=spec.label))
        if resident is None:
            resident = spec.residue_in
    elif spec is not None:
        reports.append(check_config(spec))
        if resident is None:
            resident = spec.linear_spec.domain == "residue"
    if fn is not None:
        summ = summarize_fn(fn, *example_args, **example_kwargs)
        if require_no_sync:
            reports.append(check_no_callbacks(summ, subject=subject))
        if resident:
            reports.append(check_resident(summ, subject=subject))
        if expect_kernel_calls is not None:
            reports.append(check_kernel_count(summ, expect_kernel_calls,
                                              subject=subject))
    return merged(subject, reports).raise_if_failed()
