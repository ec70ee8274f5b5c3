"""One rank of the collective passes' gang (CL005).

    PYTHONPATH=src python -m repro_torch.analysis.gang --num-processes 2 \\
        --device cpu --out DIR

Without ``--process-id`` this is the spawn parent: it forks the ranks over
gloo on localhost (``repro_torch.launch.coordinator``, as the gang tests
and ``tools/gang_check.py`` do) and exits with the gang's status. Each
rank holds ``P / N`` of the P = 4 nodes, runs every target of
``collective_passes.live_plans()`` under the recorder on ``--device``
(rank k on card ``k % count``) and writes ``DIR/rank{k}.json``:
``{target: [record, ...]}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    from repro_torch.launch import coordinator

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    coordinator.add_arguments(ap)
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"))
    ap.add_argument("--out", required=True, metavar="DIR")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analysis import collective_passes as cp
    from repro_torch.common.nodes import NodeGroup, resolve_device

    cfg = coordinator.bootstrap(argv, build_kernels=args.device == "cuda",
                                timeout=cp.GANG_TIMEOUT_S - 30)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", (cfg.process_id or 0)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    group = NodeGroup(cp.PARTS, cfg.process_id or 0, cfg.num_processes)
    out = {name: [r.to_dict()
                  for r in cp.run_target(name, device, group)[0]]
           for name in cp.live_plans()}
    path = pathlib.Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"rank{group.rank}.json").write_text(json.dumps(out))
    if cfg.is_distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
