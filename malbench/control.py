"""The control of the comparison that decides ``correct``: the reference
computed a precision lower (MalStone's ratio in bfloat16 where the
configurations state float32), put in the program's place and compared
as a run's outputs are. Every cell has to read it as not correct.

    python malbench/control.py --workload <cell> --seeds 1,2,3

prints, a seed a line, the numbers the control reads at the cell's own
size. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(resolved: dict, seed: int, device) -> dict:
    from malbench import check, harness

    run = harness.Run(resolved, seed, 0.0, False, device, 0.0)
    if resolved["traffic"]["kind"] == "batch":
        run.counters["jobs"] = 1
        return check.batch_checks(run, check.control_outputs(run))
    return check.serve_checks(run, check.control_outputs(run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="malbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    from malbench import harness

    resolved = harness.resolve(harness.load_spec(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = readings(resolved, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
