"""Artifact schema pass — committed JSON validated with named fields; port
of `repro/analysis/schema.py`.

`kernels/tune.py` trusts its committed table
(`kernels/tune_table_h100.json`, rows ``[tm, splits]``), and the
reference's ``BENCH_<n>.json`` trajectories keep their validator here
unchanged.  A malformed artifact would surface as a KeyError deep inside
its consumer; these validators check the shape up front and report *which
field* is wrong (``rows[3].value``, not a traceback), as findings so lint
can show every problem at once.  No external jsonschema dependency.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

from .findings import Report

__all__ = ["validate_bench", "validate_tune_table", "validate_bench_file",
           "validate_tune_table_file"]

# BENCH_<n>.json top level: required key -> type ("number" = int|float)
_BENCH_TOP = {
    "bench": int,
    "commit": str,
    "device": str,
    "failures": list,
    "rows": list,
    "smoke": bool,
    "timestamp": str,
}


def _is_number(v: object) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_bench(payload: object, *, subject: str = "BENCH") -> Report:
    """Schema of a ``BENCH_<n>.json`` payload (what gate.py consumes)."""
    rep = Report(subject=f"schema:{subject}")
    if not isinstance(payload, Mapping):
        rep.add("schema", "$", f"top level must be an object, "
                               f"got {type(payload).__name__}")
        return rep
    for key, typ in _BENCH_TOP.items():
        if key not in payload:
            rep.add("schema", key, "required top-level field is missing")
        elif (not isinstance(payload[key], typ)
              or (typ is int and isinstance(payload[key], bool))):
            rep.add("schema", key,
                    f"expected {typ.__name__}, "
                    f"got {type(payload[key]).__name__}")
    rows = payload.get("rows")
    if isinstance(rows, list):
        seen = set()
        for i, row in enumerate(rows):
            where = f"rows[{i}]"
            if not isinstance(row, Mapping):
                rep.add("schema", where, "row must be an object")
                continue
            name = row.get("name")
            if not isinstance(name, str) or not name:
                rep.add("schema", f"{where}.name",
                        "row name must be a non-empty string")
            elif name in seen:
                rep.add("schema", f"{where}.name",
                        f"duplicate row name {name!r} — the gate matches "
                        f"rows by name")
            else:
                seen.add(name)
            if not _is_number(row.get("value")):
                rep.add("schema", f"{where}.value",
                        f"row value must be a number, "
                        f"got {type(row.get('value')).__name__}")
            if "derived" in row and not isinstance(row["derived"], Mapping):
                rep.add("schema", f"{where}.derived",
                        "derived must be an object when present")
    failures = payload.get("failures")
    if isinstance(failures, list):
        for i, f in enumerate(failures):
            if not isinstance(f, str):
                rep.add("schema", f"failures[{i}]",
                        "failure entries must be strings")
    return rep


def validate_tune_table(payload: object, *,
                        subject: str = "tune_table") -> Report:
    """Schema of the tuner's table: key -> [tm, splits].

    Only the *shape* is checked here; whether the row is admissible for the
    keyed launch is the admissibility pass's job.
    """
    rep = Report(subject=f"schema:{subject}")
    if not isinstance(payload, Mapping):
        rep.add("schema", "$", f"top level must be an object, "
                               f"got {type(payload).__name__}")
        return rep
    for key, val in payload.items():
        if not isinstance(key, str) or key.count("/") != 4:
            rep.add("schema", f"key {key!r}",
                    "keys must be backend/device/dtype/C<c>/M<m>xK<k>xN<n>")
        if (not isinstance(val, list) or len(val) != 2
                or not all(isinstance(v, int) and not isinstance(v, bool)
                           and v > 0 for v in val)):
            rep.add("schema", f"{key}",
                    f"entry must be a [tm, splits] list of 2 positive ints, "
                    f"got {val!r}")
    return rep


def _load(path, validator, subject_prefix: str) -> Report:
    p = Path(path)
    try:
        payload = json.loads(p.read_text())
    except OSError as e:
        rep = Report(subject=f"schema:{p.name}")
        rep.add("schema", str(p), f"cannot read artifact: {e}")
        return rep
    except ValueError as e:
        rep = Report(subject=f"schema:{p.name}")
        rep.add("schema", str(p), f"invalid JSON: {e}")
        return rep
    return validator(payload, subject=p.name)


def validate_bench_file(path) -> Report:
    return _load(path, validate_bench, "BENCH")


def validate_tune_table_file(path) -> Report:
    return _load(path, validate_tune_table, "tune_table")
