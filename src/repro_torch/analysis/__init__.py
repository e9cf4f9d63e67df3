"""`repro_torch.analysis` — static analysis of the port's RNS pipeline,
port of `repro/analysis`.

Two passes and a schema check, one vocabulary:

  * **bounds** — exact interval derivation of every dynamic-range constant
    (accumulators, fold rungs, MRC limbs, requant clips) for a (basis, K,
    operand-bound, variant) configuration;
  * **admissibility** — each tile launch's (tile height, K splits) against
    the kernel's constants (compiled heights, cluster size, shared memory,
    the 32-row tile's channels and alignment), plan-table moduli limits,
    the committed tune-table rows; `schema` validates the committed JSON
    artifacts the runtime trusts.

Entry points: :func:`assert_clean` (tests), :func:`lint.check_config`
(``Engine(verify="static")``) and ``python -m repro_torch.analysis.lint
--all-configs``.  The reference's jaxpr passes (``absint``,
``residency``) are not ported.
"""
from __future__ import annotations

from .admissibility import (check_basis_tables, check_config_launches,
                            check_launch, check_tune_table)
from .bounds import (PipelineSpec, check_channel_plan, check_pipeline,
                     pipeline_specs_for)
from .findings import AnalysisError, Finding, Report, merged
from .intervals import TOP, Interval, dtype_range
from .lint import check_config
from .schema import (validate_bench, validate_bench_file, validate_tune_table,
                     validate_tune_table_file)

__all__ = [
    "AnalysisError", "Finding", "Report", "merged",
    "Interval", "TOP", "dtype_range",
    "PipelineSpec", "check_pipeline", "check_channel_plan",
    "pipeline_specs_for",
    "check_launch", "check_basis_tables", "check_tune_table",
    "check_config_launches",
    "validate_bench", "validate_bench_file", "validate_tune_table",
    "validate_tune_table_file",
    "check_config", "assert_clean",
]


def assert_clean(spec, *, subject: str = "assert_clean") -> Report:
    """One-call static gate for a configuration: ``spec`` is a
    :class:`PipelineSpec`, checked directly, or a ``ModelConfig``, expanded
    to every pipeline its decode path launches (and its launches admitted);
    ``None`` checks nothing.  Raises :class:`AnalysisError` listing every
    violated invariant; returns the full report (warnings included) when
    clean."""
    reports = []
    if isinstance(spec, PipelineSpec):
        reports.append(check_pipeline(spec)[0])
        reports.append(check_basis_tables(spec.moduli, subject=spec.label))
    elif spec is not None:
        reports.append(check_config(spec))
    return merged(subject, reports).raise_if_failed()
