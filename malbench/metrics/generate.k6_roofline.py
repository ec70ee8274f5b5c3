"""generate.k6_roofline: MalGen's site sampling (K6) against its roofline:
a marked and an unmarked call a chunk, over K6's device time."""

from malbench import roofline
from malbench.reference.malgen import marked_rows

KERNELS = ("::sample_kernel(", "direct_kernel(", "guide_kernel(")


def read(run):
    calls = (run.launches or {}).get("powerlaw_sample", 0)
    if run.trace is None or calls < 2:
        return None
    c = run.config
    sites, n = c["malgen"]["num_sites"], c["chunk_records"]
    n_marked = marked_rows(c["malgen"], n)
    b1, o1 = roofline.k6_work(n_marked, sites)
    b2, o2 = roofline.k6_work(n - n_marked, sites)
    chunks = calls // 2
    return roofline.share(chunks * (b1 + b2), chunks * (o1 + o2),
                          roofline.kernel_seconds(run, KERNELS))
