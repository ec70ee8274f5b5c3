"""Count the kernel records ``torch.profiler`` keeps as a process ages, in
one process on the card.

    PYTHONPATH=src python tools/profiler_record_probe.py --work edge \\
        --sleeps 0,60,240 --lead 0.05
    PYTHONPATH=src python tools/profiler_record_probe.py --work none \\
        --sleeps 60 --late

A block of sessions profiles one tiny kernel (three times), a burst of
200 tiny kernels, a long run of 100 kernels of about 0.2 ms each, and
each small kernel analysis case's wrapper, and prints ``found/launched``
a session: the kernel records in the trace over the kernel launches the
runtime recorded inside the case's window. For the long run it also
prints ``dropped_us``, how far into the profiler's window the last
launch whose kernel record is missing came (0: none missing). A block
runs first (unless ``--late``), then the unprofiled ``--work``
(``edge``: ``chip_smoke.py``'s phase 2, the kernels' edge cases;
``none``), then one block after each of ``--sleeps`` seconds. With
``--lead S`` each block runs its sessions again with S seconds of sleep
at the start of each window, before the case. Prints one JSON line a
block, with the process's age.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
T0 = time.perf_counter()

SMALL_CASES = ("windowed_ratio/nodedoctor", "powerlaw_sample/direct_limit",
               "count_scatter/shard_exchange", "segment_hist/b_preset",
               "windowed_ratio/masked_batch64", "count_scatter/max_dests")


def session(fn, lead: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(lead)
        with torch.profiler.record_function("case"):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    window = next(e for e in events if e.get("cat") == "Trace")
    case = next(e for e in events if e.get("name") == "case"
                and e.get("cat") == "user_annotation")
    end = case["ts"] + case["dur"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")
                and case["ts"] <= e["ts"] <= end}
    found = {e["args"].get("correlation") for e in events
             if e.get("cat") == "kernel"} & set(launches)
    missing = [ts for c, ts in launches.items() if c not in found]
    return {"found": f"{len(found)}/{len(launches)}",
            "dropped_us": round(max(missing) - window["ts"], 1)
            if missing else 0}


def block(tag: str, lead: float) -> dict:
    import torch

    from repro_torch.analysis import kernel_passes as kp

    device = torch.device("cuda")
    cases = {c["name"]: c for c in kp.kernel_analysis_cases()}
    x = torch.ones(1 << 20, device=device)
    big = torch.ones(1 << 26, device=device)

    def burst():
        for _ in range(100):
            x.add_(1)
            x.mul_(1)

    def long():
        for _ in range(100):
            big.add_(1)

    out = {"one": [session(lambda: x.add_(1), lead)["found"]
                   for _ in range(3)],
           "burst200": session(burst, lead)["found"],
           "long100": session(long, lead)}
    for name in SMALL_CASES:
        out[name] = session(lambda: cases[name]["run"](device),
                            lead)["found"]
    return out


def blocks(tag: str, leads: list) -> None:
    age = time.perf_counter() - T0
    out = {f"lead {lead}": block(tag, lead) for lead in leads}
    print(f"[record-probe] {tag} age={age:.1f}s {json.dumps(out)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", choices=("edge", "none"), default="edge")
    ap.add_argument("--sleeps", default="0",
                    help="comma-separated seconds before each later block")
    ap.add_argument("--lead", type=float, default=0.0)
    ap.add_argument("--late", action="store_true",
                    help="no profiled block before the work")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels._build import build_all

    if not torch.cuda.is_available():
        print("profiler_record_probe: needs a CUDA device", file=sys.stderr)
        return 2
    build_all()
    leads = [0.0] + ([args.lead] if args.lead else [])
    if not args.late:
        blocks("before", leads)
    if args.work == "edge":
        sys.path.insert(0, str(ROOT))
        import chip_smoke

        chip_smoke.kernel_edge_cases(torch.device("cuda"))
    for i, s in enumerate(float(v) for v in args.sleeps.split(",")):
        time.sleep(s)
        blocks(f"after{i} (slept {s:g} s)", leads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
