"""query.k5_roofline: a query batch's masked week sums and ratios (K5)
over the ``[S, W, 2]`` snapshot against its roofline."""

from malbench import roofline
from malbench.reference import spm

KERNELS = ("masked_window_ratio_kernel(", "mask_runs_kernel(")


def read(run):
    calls = (run.launches or {}).get("windowed_ratio.masked", 0)
    if run.trace is None or not calls:
        return None
    c, queries = run.config, run.traffic["queries"]
    w, year = c["num_weeks"], c["malgen"]["span_seconds"]
    masks = [spm.query_masks(q, w, year) for q in queries]
    runs = roofline.mask_runs([m for pair in masks for m in pair])
    b, o = roofline.k5_work(c["malgen"]["num_sites"], w, len(queries), runs)
    return roofline.share(calls * b, calls * o,
                          roofline.kernel_seconds(run, KERNELS))
