"""One ``torch.profiler`` session over the window of a traced run, reduced
in memory.

The session records the card's activity alone (kernels, copies, sets), so
the host pays no profiler cost an operator; the harness's own spans
(``malbench.*``) are read from the host's clock in the same time base
(nanoseconds since the epoch). The session is the process's first and
only one and lasts one window: once a process's first session is about a
minute old, the profiler drops kernel records of later ones. ``reduce``
gives the device's busy seconds (the union of its activity) over the
window, the time and count of each device operation by name, and the idle
gaps, each named by the innermost host span it fell in.
"""

from __future__ import annotations

import contextlib
import time

WINDOW_SPAN = "malbench.window"
TOP = 10


def session(device):
    """The profiler over the card's activity, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    activity = (ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU)
    return profile(activities=[activity])


class Spans:
    """The harness's host spans, ``(name, start_ns, end_ns)``, when
    enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def events(prof) -> list:
    """The card's activity in a stopped session: ``(name, start_ns,
    end_ns)``."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(host: list, dev: list) -> dict:
    """The window's busy and window seconds, the device operations by
    time, and the longest idle gaps by host span."""
    win = [s for s in host if s[0] == WINDOW_SPAN]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans")
    _, w0, w1 = win[0]
    clipped = [(max(a, w0), min(b, w1)) for _, a, b in dev if b > w0
               and a < w1]
    busy = union(clipped)
    ops = {}
    for name, a, b in dev:
        if b > w0 and a < w1:
            count, ns = ops.get(name, (0, 0))
            ops[name] = (count + 1, ns + min(b, w1) - max(a, w0))
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    inner = [s for s in host if s[0] != WINDOW_SPAN]

    def cause(a, b):
        mid = (a + b) // 2
        around = [s for s in inner if s[1] <= mid < s[2]]
        if not around:
            return "host: " + WINDOW_SPAN
        return "host: " + min(around, key=lambda s: s[2] - s[1])[0]

    idle_by_cause: dict = {}
    for a, b in gaps:
        key = cause(a, b)
        idle_by_cause[key] = idle_by_cause.get(key, 0.0) + (b - a) / 1e9
    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "ops": {name: {"count": c, "seconds": ns / 1e9}
                for name, (c, ns) in ops.items()},
        "idle_s_by_host_span": idle_by_cause,
        "breakdown": {
            "device_ops": [[name[:160], ns / 1e9]
                           for name, (_, ns) in top_ops],
            "idle_gaps": [[cause(a, b), (b - a) / 1e9]
                          for a, b in gaps[:TOP]]},
    }


def kernel_records(ops: dict, fragment: str) -> tuple:
    """(records, seconds) of the device operations whose name holds
    ``fragment``: a kernel's symbol and the start of its argument list,
    such as ``"sample_kernel("``."""
    hits = [v for name, v in ops.items() if fragment in name]
    return (sum(v["count"] for v in hits), sum(v["seconds"] for v in hits))
