"""Findings and reports — the shared result vocabulary of the analysis layer,
port of `repro/analysis/findings.py`.

Every pass (bounds, admissibility, schema) emits
:class:`Finding`s into a :class:`Report` instead of raising ad hoc: a lint
run wants to see *all* violations of a config at once, while a pytest
fixture or ``Engine(verify="static")`` wants one loud exception.  The report
supports both: accumulate findings, then :meth:`Report.raise_if_failed`.

Severities:

  * ``error``  — a proven violation of an invariant (overflow,
    inadmissible launch, malformed artifact).  Lint exits 1.
  * ``warning``— a property the pass could not *prove* either way (a value
    that escaped the abstract domain, the float32 dequant above 2^24).  Lint
    prints but passes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

__all__ = ["Finding", "Report", "AnalysisError", "merged"]


class AnalysisError(ValueError):
    """Raised by ``Report.raise_if_failed`` / ``assert_clean`` on errors."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated (or unprovable) invariant.

    ``where`` names the object the finding is about — a channel
    (``"channel m=37"``), a launch, a tune-table key, a JSON field
    path — so the message is actionable without re-running the pass.
    """

    passname: str                 # bounds | admissibility | schema
    severity: str                 # error | warning
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.passname}:{self.severity}] {self.where}: {self.message}"


@dataclasses.dataclass
class Report:
    """Accumulated findings of one or more passes over one subject."""

    subject: str
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def add(self, passname: str, where: str, message: str,
            severity: str = "error") -> None:
        self.findings.append(Finding(passname=passname, severity=severity,
                                     where=where, message=message))

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_failed(self) -> "Report":
        if not self.ok:
            lines = "\n".join(f"  {f}" for f in self.errors)
            raise AnalysisError(
                f"static analysis failed for {self.subject} "
                f"({len(self.errors)} error(s)):\n{lines}")
        return self

    def summary(self) -> str:
        state = "OK" if self.ok else "FAIL"
        return (f"{self.subject}: {state} "
                f"({len(self.errors)} errors, {len(self.warnings)} warnings)")


def merged(subject: str, reports: Iterable[Report]) -> Report:
    """Fold several pass reports over the same subject into one."""
    out = Report(subject=subject)
    for r in reports:
        out.extend(r)
    return out
