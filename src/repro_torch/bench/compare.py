"""Perf-regression gate of the port: diff two BENCH_*.json runs.

Counterpart of ``repro/bench/compare.py``; either document may come from
either package, so ``BENCH_smoke.json`` (JAX) against
``BENCH_torch_smoke.json`` (the port) compares the two scenario by
scenario (``--allow-missing``: the port registers fewer scenarios).

    PYTHONPATH=src python -m repro_torch.bench.compare baseline.json \
        current.json --tolerance 0.15

For every scenario in the baseline, the current run's ``us_per_call``
(median) must satisfy ``current <= baseline * (1 + tolerance)``.

Exit codes (stable contract — CI and tests rely on them):

    0  no regressions (improvements are fine and reported)
    1  at least one scenario regressed beyond the tolerance
    2  structural failure: unreadable/schema-invalid document, or a
       baseline scenario missing from the current run (unless
       ``--allow-missing``)

``--metric us_min`` switches the gate to the min-of-k estimate, which is
less noisy on dedicated hardware but hides queueing effects;
``us_per_call`` (median) is the default because CI runs on shared
runners.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.bench import schema

METRICS = ("us_per_call", "us_min", "us_mean")


def compare_documents(baseline: dict, current: dict, *,
                      tolerance: float = 0.15,
                      metric: str = "us_per_call",
                      allow_missing: bool = False) -> dict:
    """Pure comparison (no I/O): returns a report dict.

    ``report["status"]`` is "ok", "regression", or "missing"; rows carry
    the per-scenario ratio (current / baseline, >1 = slower).
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    base = schema.results_by_scenario(baseline)
    cur = schema.results_by_scenario(current)

    rows, missing, regressions = [], [], []
    for name, b in base.items():
        c = cur.get(name)
        if c is None:
            missing.append(name)
            continue
        b_us, c_us = float(b[metric]), float(c[metric])
        ratio = c_us / b_us if b_us > 0 else float("inf")
        regressed = ratio > 1.0 + tolerance
        if regressed:
            regressions.append(name)
        rows.append({
            "scenario": name,
            "baseline_us": b_us,
            "current_us": c_us,
            "ratio": ratio,
            "regressed": regressed,
            "steady": bool(b.get("steady", True))
                      and bool(c.get("steady", True)),
        })
    new = sorted(set(cur) - set(base))

    if missing and not allow_missing:
        status = "missing"
    elif regressions:
        status = "regression"
    else:
        status = "ok"
    return {
        "status": status,
        "metric": metric,
        "tolerance": tolerance,
        "rows": rows,
        "missing": missing,
        "new_scenarios": new,
        "regressions": regressions,
    }


def format_report(report: dict) -> str:
    lines = ["| scenario | baseline us | current us | ratio | verdict |",
             "|---|---|---|---|---|"]
    for r in sorted(report["rows"], key=lambda r: -r["ratio"]):
        if r["regressed"]:
            verdict = "**REGRESSION**"
        elif r["ratio"] < 1.0 / (1.0 + report["tolerance"]):
            # symmetric in log-space with the regression bound, so large
            # tolerances (CI uses 5.0) can still surface wins
            verdict = "improvement"
        else:
            verdict = "ok"
        if not r["steady"]:
            verdict += " (unsteady)"
        lines.append(f"| {r['scenario']} | {r['baseline_us']:.1f} "
                     f"| {r['current_us']:.1f} | {r['ratio']:.3f} "
                     f"| {verdict} |")
    for name in report["missing"]:
        lines.append(f"| {name} | - | MISSING | - | **missing** |")
    for name in report["new_scenarios"]:
        lines.append(f"| {name} | new | - | - | (not gated) |")
    lines.append("")
    lines.append(f"gate: metric={report['metric']} "
                 f"tolerance={report['tolerance']:.0%} -> "
                 f"{report['status'].upper()} "
                 f"({len(report['regressions'])} regressed, "
                 f"{len(report['missing'])} missing, "
                 f"{len(report['new_scenarios'])} new)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.compare",
                                 description=__doc__)
    ap.add_argument("baseline")
    ap.add_argument("current")
    ap.add_argument("--tolerance", type=float, default=0.15,
                    help="allowed slowdown fraction (0.15 = +15%%)")
    ap.add_argument("--metric", default="us_per_call", choices=METRICS)
    ap.add_argument("--allow-missing", action="store_true",
                    help="baseline scenarios absent from the current run "
                         "are reported but not fatal")
    args = ap.parse_args(argv)

    try:
        baseline = schema.load_document(args.baseline)
        current = schema.load_document(args.current)
    except schema.BenchSchemaError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    report = compare_documents(baseline, current,
                               tolerance=args.tolerance, metric=args.metric,
                               allow_missing=args.allow_missing)
    print(format_report(report))
    return {"ok": 0, "regression": 1, "missing": 2}[report["status"]]


if __name__ == "__main__":
    sys.exit(main())
