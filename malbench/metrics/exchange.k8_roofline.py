"""exchange.k8_roofline: the combiner's block exchange (K8), a step's
``[P, S, W, 2]`` local histograms summed by owner into the ``[P, S/P, W,
2]`` carry, against its roofline. K8's calls are its kernel records in the
trace (its wrapper's counter is not among ``launch_counts()``)."""

from malbench import roofline
from malbench.roofline_k8 import k8_work
from malbench.trace import kernel_records

KERNELS = ("combine_blocks_kernel(",)


def read(run):
    if run.trace is None:
        return None
    calls = sum(kernel_records(run.trace["ops"], k)[0] for k in KERNELS)
    if not calls:
        return None
    c = run.config
    b, o = k8_work(c["nodes"], roofline.padded_sites(c), c["num_weeks"])
    return roofline.share(calls * b, calls * o,
                          roofline.kernel_seconds(run, KERNELS))
