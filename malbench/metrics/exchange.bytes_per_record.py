"""exchange.bytes_per_record: bucket bytes the record shuffle ships a
record, ``ShuffleStats.bytes_exchanged / sent`` by the stats' definition
(rounds x P x capacity x 4 bytes a node), counted from the launch counters:
a round reduces its words with one K3 launch, a step orders them with one
K2 launch. (The job's ``ShuffleStats`` wrap as int32 at this scale.)"""

from malbench.check import capacity


def read(run):
    launches = run.launches or {}
    rounds = launches.get("segment_hist.packed", 0)
    steps = launches.get("count_scatter.scatter", 0)
    if not rounds or not steps:
        return None
    c = run.config
    p = c["nodes"]
    shipped = rounds * p * p * capacity(c) * 4
    return {"value": shipped / (steps * p * c["chunk_records"])}
