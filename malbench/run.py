"""Run one benchmark cell once on the card and print its result line.

    python malbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``checks`` last, each
number compared with its limit, which also close standard error). With no
card, fewer cards than the cell asks for, or a module of JAX or of the
JAX package loaded, it prints no result and exits with another code than
0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="malbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the kernel caches live at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from malbench import harness

    harness.steady_host_allocator()

    spec = harness.load_spec(ROOT)
    resolved = harness.resolve(spec, args.workload)
    chips = resolved["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"malbench: the cell needs {chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    result = harness.execute(resolved, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"malbench: the run loaded {found}: no module of JAX or of the"
              f" JAX package may load", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
