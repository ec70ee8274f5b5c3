"""The paper's technique as cluster ops tooling, in the PyTorch port:
MalStone B + CUSUM over step telemetry attributes a degrading host (paper
§8's change-detection remark, Table 1's "site = the thing that marks").

    PYTHONPATH=src python examples/node_doctor_torch.py [--device cpu]

The counterpart of ``examples/node_doctor.py``, on the same telemetry. It
runs on the card unless ``--device cpu`` is given; on the card the
diagnosis's MalStone B finalize is K7.
"""

import argparse

import numpy as np
import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import SECONDS_PER_WEEK
from repro_torch.core.nodedoctor import diagnose, host_telemetry_log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    hosts, buckets, steps_per = 16, 24, 40
    bad_host, degrade_after = 11, 12

    host, step, bucket, failed = [], [], [], []
    sid = 0
    for b in range(buckets):
        for h in range(hosts):
            for _ in range(steps_per):
                p = 0.01
                if h == bad_host and b >= degrade_after:
                    p = 0.30  # slow memory fault: 30% step failure
                host.append(h)
                step.append(sid)
                bucket.append(b * SECONDS_PER_WEEK)
                failed.append(int(rng.random() < p))
                sid += 1

    def col(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    log = host_telemetry_log(col(host), col(step), col(bucket), col(failed))
    rep = diagnose(log, num_hosts=hosts, num_buckets=buckets)

    print(f"{sid} steps across {hosts} hosts; host {bad_host} degrades at "
          f"bucket {degrade_after}\n")
    print("host  rho_final  cusum_max  alarm")
    rho = rep.rho[:, -1].cpu().numpy()
    cmax = rep.cusum.max(dim=-1).values.cpu().numpy()
    alarm = rep.alarm.cpu().numpy()
    for h in range(hosts):
        flag = " <-- blocklist" if alarm[h] else ""
        print(f"{h:>4}  {rho[h]:>9.3f}  {cmax[h]:>9.1f}  {alarm[h]}{flag}")

    suspects = rep.suspect_rank[:3].cpu().numpy()
    print(f"\ntop suspects: {suspects.tolist()} "
          f"(truth: {bad_host})")
    if not (alarm[bad_host] and alarm.sum() == 1):
        raise SystemExit(f"expected host {bad_host} alone to alarm, got "
                         f"{np.flatnonzero(alarm).tolist()}")
    return alarm.tolist()


if __name__ == "__main__":
    main()
