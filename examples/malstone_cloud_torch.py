"""The paper's experiment at cloud shape on the PyTorch port: 8 nodes as
a leading axis on one device, the three middleware backends side by
side, MalStone A and B (Tables 4 and 5).

    PYTHONPATH=src python examples/malstone_cloud_torch.py [--device cpu]

The counterpart of ``examples/malstone_cloud.py``. It runs on the card
unless ``--device cpu`` is given; each backend's rho is held bit for bit
against the single-device oracle run on the CPU.
"""

import argparse
import time

import torch

from repro_torch.core import malstone_run, malstone_single_device
from repro_torch.malgen import MalGenConfig, generate_shards_device, make_seed


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--records-per-node", type=int, default=262_144)
    ap.add_argument("--sites", type=int, default=10_000)
    ap.add_argument("--entities", type=int, default=100_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    nodes, rps = args.nodes, args.records_per_node
    cfg = MalGenConfig(num_sites=args.sites, num_entities=args.entities)
    print(f"MalGen: {nodes} nodes x {rps} records "
          f"({nodes * rps * 100 / 1e6:.0f} MB at 100 B/record) on "
          f"{args.device}")
    seed = make_seed(0, cfg, nodes * rps, device=device)
    log = generate_shards_device(seed, cfg, nodes, rps, device=device).map(
        lambda c: c.reshape(-1))

    # the oracle on a CPU copy shares no kernel with the runs it checks
    ref = {stat: malstone_single_device(log.map(lambda c: c.cpu()),
                                        cfg.num_sites, statistic=stat)
           for stat in ("A", "B")}

    print(f"\n{'backend':<12} {'stat':<5} {'time':>9}  matches-reference")
    matches = []
    for stat in ("A", "B"):
        for backend in ("streams", "sphere", "mapreduce"):
            def fn():
                return malstone_run(log, cfg.num_sites, nodes=nodes,
                                    statistic=stat, backend=backend,
                                    device=device).rho

            fn()                                  # builds the kernels
            _sync(device)
            t0 = time.perf_counter()
            rho = fn()
            _sync(device)
            dt = time.perf_counter() - t0
            ok = torch.equal(rho.cpu().view(torch.int32),
                             ref[stat].rho.view(torch.int32))
            matches.append(ok)
            print(f"{backend:<12} {stat:<5} {dt * 1e3:8.1f}ms  {ok}")

    print("\nNote: the P nodes share one device, so the collectives are"
          "\ntensor copies; the paper's middleware gap shows in the bytes"
          "\nthe exchange ships (the launcher's --bench-json records them).")
    return matches


if __name__ == "__main__":
    main()
