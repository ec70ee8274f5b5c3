"""Bench runner CLI of the port: sweep the scenario registry, emit
``BENCH_<name>.json``.

    PYTHONPATH=src python -m repro_torch.bench.run --device cpu --preset smoke
    PYTHONPATH=src python -m repro_torch.bench.run --scenario kernel_windowed_ratio_pallas
    PYTHONPATH=src python -m repro_torch.bench.run --list

Runs on the card unless ``--device cpu``. The document (default name
``torch_<preset>``, so a run never overwrites the JAX package's
``BENCH_<preset>.json``) lands at the repo root and conforms to
``repro_torch.bench.schema``; the ``name,us_per_call,derived`` CSV rows go
to stdout. ``--nodes N`` (default 2, as the JAX package) is the count of
nodes held as the leading axis. Compare two runs, of either package, with
``python -m repro_torch.bench.compare``.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.bench import registry, schema


def _csv_row(entry: dict) -> str:
    derived = ""
    if "records_per_s" in entry:
        derived = f"{entry['records_per_s']:.4g}_records_per_s"
    elif entry.get("derived"):
        k, v = next(iter(entry["derived"].items()))
        derived = f"{v:.4g}_{k}" if isinstance(v, float) else f"{v}_{k}"
    return f"{entry['scenario']},{entry['us_per_call']:.1f},{derived}"


def run_scenarios(names, scale, ctx, doc, *, verbose=True):
    """Run each named scenario, append to ``doc``; return skipped names."""
    skipped = []
    for sc in registry.iter_scenarios(names):
        t0 = time.perf_counter()
        try:
            res = sc.run(scale, ctx)
        except registry.ScenarioSkip as e:
            skipped.append(sc.name)
            if verbose:
                print(f"# skip {sc.name}: {e}", flush=True)
            continue
        # provenance: scale defaults, then the grid point, then what the
        # scenario actually ran with (sweeps override nodes/records)
        params = scale.as_params()
        params["nodes"] = ctx.nodes
        params.update(sc.params)
        params.update(res.effective or {})
        entry = schema.add_result(doc, sc.name, params, res.timing,
                                  records=res.records, derived=res.derived)
        if verbose:
            wall = time.perf_counter() - t0
            print(f"{_csv_row(entry)}  # wall {wall:.1f}s "
                  f"steady={res.timing.steady}", flush=True)
    return skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.run",
                                 description=__doc__)
    ap.add_argument("--preset", default="smoke",
                    choices=sorted(registry.PRESETS))
    ap.add_argument("--scenario", action="append", metavar="NAME",
                    help="run only these scenarios (repeatable); default = "
                         "the preset's selection")
    ap.add_argument("--name", default=None,
                    help="document name -> BENCH_<name>.json (default: "
                         "torch_<preset>)")
    ap.add_argument("--out", default=None,
                    help="explicit output path (overrides --name placement)")
    ap.add_argument("--nodes", type=int, default=2,
                    help="nodes, held as the leading axis on one device")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="device to run on (default: the card)")
    ap.add_argument("--list", action="store_true",
                    help="list scenario names (with the preset's selection "
                         "marked) and exit")
    args = ap.parse_args(argv)

    selected = set(registry.preset_scenario_names(args.preset))
    if args.list:
        for name, sc in registry.SCENARIOS.items():
            mark = "*" if name in selected else " "
            print(f"{mark} {name:42s} [{sc.group}]")
        print(f"\n* = in --preset {args.preset} selection "
              f"({len(selected)}/{len(registry.SCENARIOS)})")
        return 0

    names = args.scenario if args.scenario else sorted(selected)
    scale = registry.PRESETS[args.preset]
    ctx = registry.BenchContext(nodes=args.nodes, device=args.device)
    doc = schema.new_document(args.name or f"torch_{args.preset}",
                              preset=args.preset, device=ctx.device)

    print("name,us_per_call,derived")
    skipped = run_scenarios(names, scale, ctx, doc)
    if not doc["results"]:
        print("error: no scenario produced a result", file=sys.stderr)
        return 2
    path = schema.write_document(doc, path=args.out)
    print(f"# wrote {path} ({len(doc['results'])} scenarios, "
          f"{len(skipped)} skipped)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
