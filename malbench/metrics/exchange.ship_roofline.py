"""exchange.ship_roofline: a round's shipped words written in one pass
(K9), a step's ``[P, n]`` words ordered by destination into the receivers'
``[P, P, C]`` buckets, against its roofline. K9's calls are its kernel
records in the trace (its wrapper's counter is not among
``launch_counts()``).

Its work: every slot of a call's buckets written once (4 P P C bytes a
call), and every valid word read once a step whatever the rounds, since
the shuffle is lossless (4 P n bytes a step; a step orders its words with
one K2 launch). Every row of the cells' seed-mode chunks is valid, so the
words a step reads are exactly its P n records. The integer work is not
counted, as K3's and K8's is not."""

from malbench import roofline
from malbench.check import capacity
from malbench.trace import kernel_records

KERNELS = ("ship_buckets_kernel(",)


def read(run):
    if run.trace is None:
        return None
    calls = sum(kernel_records(run.trace["ops"], k)[0] for k in KERNELS)
    steps = (run.launches or {}).get("count_scatter.scatter", 0)
    if not calls or not steps:
        return None
    c = run.config
    p = c["nodes"]
    nbytes = (calls * 4 * p * p * capacity(c)
              + steps * 4 * p * c["chunk_records"])
    return roofline.share(nbytes, 0, roofline.kernel_seconds(run, KERNELS))
