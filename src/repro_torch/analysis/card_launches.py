"""Take the card's launch records of the kernel analysis cases.

    PYTHONPATH=src python -m repro_torch.analysis.card_launches --out FILE

Builds the kernels first, then runs every case of
``kernel_passes.kernel_analysis_cases()`` once under
``torch.profiler`` and writes ``{case name: [record, ...]}`` as JSON
(``kernel_passes.card_launches``). A process of its own, so that every
session comes within seconds of its first one: later, the profiler drops
the first kernel records of each session. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, metavar="FILE")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analysis import kernel_passes as kp
    from repro_torch.common.nodes import resolve_device
    from repro_torch.kernels._build import build_all

    device = resolve_device("cuda")
    build_all()
    sources = kp.read_sources()
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in kp.kernel_analysis_cases():
            torch.cuda.empty_cache()
            records[case["name"]] = kp.card_launches(
                case, device, sources[case["source"]].kernels,
                pathlib.Path(tmp) / "trace.json")
    pathlib.Path(args.out).write_text(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
