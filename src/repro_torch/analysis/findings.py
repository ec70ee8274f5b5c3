"""Findings schema for the port's static checker suite.

Counterpart of ``repro/analysis/findings.py``, with a schema of its own
(``repro_torch.analysis/1``), so a report of one package is never read as
the other's. Every pass reports the same record: a *rule id* (stable,
documented in ``repro_torch.analysis.registry``), a severity, the *target*
it was checked against (a driver, a kernel case, an exchange, a source
file), a location inside that target, a human message, and a fix hint.

The committed baseline (``results/analysis_baseline_torch.json``)
grandfathers known findings: the CLI fails only on findings whose
:meth:`Finding.key` is not in the baseline, so new hazards fail the gate
while accepted ones stay visible without blocking.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, Optional

SCHEMA = "repro_torch.analysis/1"

# Severities, in gate order. ``error`` = the invariant is violated;
# ``warning`` = almost certainly a hazard but the pass cannot prove it;
# ``info`` = accounting the reader should know about (never gates alone,
# but still participates in the baseline diff so silent changes surface).
SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding (see module docstring)."""

    rule: str          # stable rule id, e.g. "KG001"
    severity: str      # one of SEVERITIES
    target: str        # what was analyzed, e.g. "drivers:oneshot/mapreduce"
    location: str      # where inside the target, e.g. "sample_kernel/u"
    message: str       # human-readable description (may contain numbers)
    fix_hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    @property
    def key(self) -> str:
        """Baseline identity: stable across reruns, excludes the message
        (which may carry volatile byte/round counts)."""
        return f"{self.rule}::{self.target}::{self.location}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Finding":
        return Finding(rule=d["rule"], severity=d["severity"],
                       target=d["target"], location=d["location"],
                       message=d["message"], fix_hint=d.get("fix_hint", ""))


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    return sorted(findings,
                  key=lambda f: (SEVERITIES.index(f.severity), f.rule,
                                 f.target, f.location))


def write_report(findings: Iterable[Finding], path) -> None:
    payload = {
        "schema": SCHEMA,
        "findings": [f.to_dict() for f in sort_findings(findings)],
    }
    pathlib.Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def load_report(path) -> list[Finding]:
    """Load a findings report / baseline file; [] for a missing path."""
    p = pathlib.Path(path)
    if not p.exists():
        return []
    payload = json.loads(p.read_text())
    schema = payload.get("schema")
    if schema != SCHEMA:
        raise ValueError(
            f"{p}: unknown findings schema {schema!r} (expected {SCHEMA})")
    return [Finding.from_dict(d) for d in payload.get("findings", [])]


@dataclasses.dataclass(frozen=True)
class BaselineDiff:
    """Result of diffing current findings against a committed baseline."""

    new: tuple        # Finding tuple: not in the baseline -> gate failure
    known: tuple      # Finding tuple: grandfathered by the baseline
    fixed: tuple      # baseline keys with no current finding (stale entries)

    @property
    def gate_failed(self) -> bool:
        return bool(self.new)


def diff_against_baseline(findings: Iterable[Finding],
                          baseline: Optional[Iterable[Finding]]) -> BaselineDiff:
    baseline_keys = {f.key for f in (baseline or [])}
    current = sort_findings(findings)
    new = tuple(f for f in current if f.key not in baseline_keys)
    known = tuple(f for f in current if f.key in baseline_keys)
    current_keys = {f.key for f in current}
    fixed = tuple(sorted(k for k in baseline_keys if k not in current_keys))
    return BaselineDiff(new=new, known=known, fixed=fixed)
