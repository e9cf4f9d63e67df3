"""`python -m repro_torch.analysis.lint` — static analysis over the port's
configs; port of `repro/analysis/lint.py`.

Runs the bound and admissibility passes over every (full + smoke) config in
the port's registry, and the schema + admissibility passes over the
committed tuner table (`kernels/tune_table_h100.json`), printing one
summary line per subject and every error finding.  Exit 1 iff any pass
proved a violation; warnings (unprovable properties) never fail the run but
print under ``-v``.  The reference's jaxpr pass (``--jaxpr``) has no
counterpart here.

Usage:
    python -m repro_torch.analysis.lint --all-configs
    python -m repro_torch.analysis.lint --configs rns-smollm-135m-resident -v
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from .findings import Report, merged

__all__ = ["check_config", "lint_arch", "main"]


def check_config(cfg) -> Report:
    """Bound + admissibility passes over ONE ModelConfig instance.

    This is the checker `Engine(verify="static")` runs at init: every
    pipeline configuration the config's decode path launches is re-derived
    and proven (accumulators, fold ladders, dynamic range, MRC limbs,
    requant exactness), every launch's (tm, splits) and basis tables
    admitted.
    """
    from . import admissibility, bounds

    reports: List[Report] = []
    for ps in bounds.pipeline_specs_for(cfg):
        reports.append(bounds.check_pipeline(ps)[0])
        reports.append(admissibility.check_basis_tables(
            ps.moduli, subject=ps.label))
    reports.append(admissibility.check_config_launches(cfg))
    return merged(f"config:{cfg.name}", reports)


def lint_arch(name: str) -> List[Report]:
    """Reports for an arch's full AND smoke config."""
    from repro_torch.configs.base import get_config, get_smoke_config

    out = []
    for tag, cfg in (("", get_config(name)),
                     (":smoke", get_smoke_config(name))):
        rep = check_config(cfg)
        rep.subject = f"{name}{tag}"
        out.append(rep)
    return out


def _lint_artifacts(tune_table: str) -> List[Report]:
    from . import admissibility, schema

    out: List[Report] = []
    if os.path.exists(tune_table):
        rep = schema.validate_tune_table_file(tune_table)
        if rep.ok:
            with open(tune_table) as fh:
                rep.extend(admissibility.check_tune_table(json.load(fh)))
        out.append(rep)
    return out


def main(argv=None) -> int:
    from repro_torch.kernels import tune

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static bound/admissibility/schema analysis of the "
                    "port's RNS pipeline")
    ap.add_argument("--all-configs", action="store_true",
                    help="lint every arch in the registry (full + smoke)")
    ap.add_argument("--configs", default=None,
                    help="comma-separated arch names to lint")
    ap.add_argument("--tune-table", default=str(tune.COMMITTED_TABLE),
                    help="committed tune table to validate")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print warning findings")
    args = ap.parse_args(argv)

    names: List[str] = []
    if args.all_configs:
        from repro_torch.configs.base import _REGISTRY, _ensure_loaded

        _ensure_loaded()
        names = sorted(_REGISTRY)
    elif args.configs:
        names = [n.strip() for n in args.configs.split(",") if n.strip()]

    reports: List[Report] = []
    for name in names:
        reports.extend(lint_arch(name))
    reports.extend(_lint_artifacts(args.tune_table))
    if not names:
        ap.print_help()
        return 2

    n_err = n_warn = 0
    for rep in reports:
        print(f"# {rep.summary()}")
        for f in rep.errors:
            print(f"    {f}")
        if args.verbose:
            for f in rep.warnings:
                print(f"    {f}")
        n_err += len(rep.errors)
        n_warn += len(rep.warnings)
    print(f"# lint: {len(reports)} subjects, {n_err} errors, "
          f"{n_warn} warnings")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
