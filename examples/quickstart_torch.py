"""Quickstart of the PyTorch port: generate a MalGen log, run MalStone A
and B, inspect suspects.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py``. It runs on the card unless
``--device cpu`` is given.
"""

import argparse

import torch

from repro_torch.core import malstone_single_device
from repro_torch.malgen import MalGenConfig, generate_shards_device, make_seed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=1_000_000)
    ap.add_argument("--sites", type=int, default=5_000)
    ap.add_argument("--entities", type=int, default=50_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = MalGenConfig(num_sites=args.sites, num_entities=args.entities,
                       marked_site_fraction=0.05, p_mark=0.7)
    print(f"generating {args.records:,} events for {cfg.num_sites} sites "
          f"({cfg.num_marked_sites} marked) on {args.device}...")
    seed = make_seed(0, cfg, args.records, device=args.device)
    log = generate_shards_device(seed, cfg, 1, args.records,
                                 device=args.device).map(
        lambda c: c.reshape(-1))

    res_a = malstone_single_device(log, cfg.num_sites, statistic="A")
    res_b = malstone_single_device(log, cfg.num_sites, statistic="B")

    rho = res_a.rho.cpu()
    total = res_a.total.cpu()
    marked_sites = seed.marked_mask.cpu()

    # the SPM statistic should separate marked from unmarked sites
    busy = total > 20
    print("\nMalStone A (rho_j over the year), sites with >20 visits:")
    print(f"  mean rho over marked sites:   "
          f"{rho[busy & marked_sites].mean():.3f}")
    print(f"  mean rho over unmarked sites: "
          f"{rho[busy & ~marked_sites].mean():.3f}")

    top = torch.argsort(-torch.where(busy, rho, torch.tensor(-1.0)),
                        stable=True)[:10]
    hit = marked_sites[top].float().mean()
    print(f"\ntop-10 sites by rho_j: {top.tolist()}")
    print(f"  {hit:.0%} of them are truly marked sites")

    rho_b = res_b.rho.cpu()
    j = int(top[0])
    print(f"\nMalStone B for site {j} (rho_j,t across the year's weeks):")
    print("  " + " ".join(f"{v:.2f}" for v in rho_b[j][::4].tolist()))


if __name__ == "__main__":
    main()
