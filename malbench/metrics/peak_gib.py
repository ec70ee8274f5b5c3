"""peak_gib: the allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    peak = run.counters.get("memory_peak_bytes", 0)
    return {"value": peak / 2**30} if peak else None
