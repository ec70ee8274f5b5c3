"""``python -m repro_torch.analysis`` -- run the port's static checker suite.

Counterpart of ``repro/analysis/cli.py``, with its flags and exit codes:
0 = no findings outside the committed baseline, 1 = new findings (the
gate fails), 2 = usage error. ``--update-baseline`` rewrites the baseline
from the current run (review the diff before committing it: every entry
is a known, explained hazard, not an ignore list).

``--device`` picks where the driver and collective families run their
programs, as every entry point of the port does: on the card unless the
caller asks for the CPU (``--device cpu``); on the card the drivers also
report the card's own count of synchronizing operations beside the
recorder's. Without a card and without ``--device cpu`` those families
exit 2; the kernel and lint families run no program and need no device.
The CLI never falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis.findings import (
    diff_against_baseline,
    load_report,
    sort_findings,
    write_report,
)
from repro_torch.analysis.registry import (
    DEVICE_FAMILIES,
    FAMILIES,
    AnalysisContext,
    run_passes,
)
from repro_torch.common.nodes import resolve_device

DEFAULT_BASELINE = (pathlib.Path(__file__).resolve().parents[3]
                    / "results" / "analysis_baseline_torch.json")


def _parse_targets(values) -> list:
    fams = []
    for v in values:
        for part in v.split(","):
            part = part.strip()
            if not part:
                continue
            if part == "all":
                return list(FAMILIES)
            fams.append(part)
    return fams or list(FAMILIES)


def _fmt(finding) -> str:
    line = (f"  [{finding.severity:7s}] {finding.rule} {finding.target} "
            f"@ {finding.location}\n            {finding.message}")
    if finding.fix_hint:
        line += f"\n            fix: {finding.fix_hint}"
    return line


def _device(name):
    """``resolve_device``, its refusal without a card a usage error."""
    try:
        return resolve_device(name)
    except RuntimeError as exc:
        raise ValueError(f"{exc} (--device cpu)") from exc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static checker suite of the PyTorch port: driver / "
                    "kernel launch-plan / collective / lint passes over "
                    "the live tree")
    p.add_argument("--target", action="append", default=None,
                   metavar="FAMILY",
                   help=f"pass family to run: {', '.join(FAMILIES)} or "
                        f"'all' (repeatable / comma-separated; default all)")
    p.add_argument("--baseline", type=pathlib.Path, default=DEFAULT_BASELINE,
                   help="grandfathered-findings file to diff against "
                        "(default: results/analysis_baseline_torch.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: any finding fails the gate")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from this run and exit 0")
    p.add_argument("--report", type=pathlib.Path, default=None,
                   help="also write the full findings report as JSON")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="where the driver and collective families run "
                        "(default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        families = _parse_targets(args.target or ["all"])
        device = (_device(args.device)
                  if set(families) & set(DEVICE_FAMILIES) else None)
        ctx = AnalysisContext(device=device)
        findings = sort_findings(run_passes(families, ctx))
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    for note in ctx.notes:
        print(f"note: {note}")
    if args.report is not None:
        write_report(findings, args.report)
        print(f"report: wrote {len(findings)} finding(s) to {args.report}")

    if args.update_baseline:
        args.baseline.parent.mkdir(parents=True, exist_ok=True)
        write_report(findings, args.baseline)
        print(f"baseline: wrote {len(findings)} finding(s) to "
              f"{args.baseline}")
        return 0

    baseline = [] if args.no_baseline else load_report(args.baseline)
    diff = diff_against_baseline(findings, baseline)

    print(f"{len(findings)} finding(s) over families "
          f"{','.join(families)}: {len(diff.new)} new, "
          f"{len(diff.known)} grandfathered, {len(diff.fixed)} fixed")
    if diff.known:
        print("grandfathered (baseline):")
        for f in diff.known:
            print(f"  [{f.severity:7s}] {f.rule} {f.target} @ {f.location}")
    if diff.fixed:
        print("fixed (stale baseline entries -- re-run with "
              "--update-baseline to drop them):")
        for key in diff.fixed:
            print(f"  {key}")
    if diff.new:
        print("NEW findings (gate failure):")
        for f in diff.new:
            print(_fmt(f))
        return 1
    print("gate: OK")
    return 0
