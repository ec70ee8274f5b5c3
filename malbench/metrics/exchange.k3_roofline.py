"""exchange.k3_roofline: the reduce of a round's shipped words (K3),
``[P, P x capacity]`` into ``[P, S/P, W, 2]``, against its roofline."""

from malbench import roofline
from malbench.check import capacity

KERNELS = ("packed_hist_kernel(", "hot_sites_kernel(int const*, int*,")


def read(run):
    calls = (run.launches or {}).get("segment_hist.packed", 0)
    if run.trace is None or not calls:
        return None
    c = run.config
    p = c["nodes"]
    b, o = roofline.k3_work(p, p * capacity(c),
                            roofline.padded_sites(c) // p, c["num_weeks"])
    return roofline.share(calls * b, calls * o,
                          roofline.kernel_seconds(run, KERNELS))
