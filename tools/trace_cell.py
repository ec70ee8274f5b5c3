#!/usr/bin/env python3
"""Run one benchmark cell with the port's span recorder on, and put the
card's idle and busy time down to the port's spans.

    python tools/trace_cell.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--out FILE]

Run from the root of a checkout, on the card. The cell runs exactly as
``malbench/run.py`` runs it (``malbench.harness.execute``: set-up, window,
check, the cell's metrics), with ``repro_torch.common.trace`` recording
over the window. With ``--trace 0`` the result line is the cell's
end-to-end metrics with the recorder on (beside ``malbench/run.py``'s on
the same seed, its cost); with ``--trace 1`` the harness's profiler
session also runs, and its raw records are kept to join the program's
spans:

- ``idle_s_by_span_path``: the window's idle seconds by the chain of host
  spans (the harness's ``malbench.*`` and the port's), outermost first,
  that the host was inside while the card idled;
- ``device_s_by_span_path``: the window's busy seconds by the chain of
  spans in which the host launched each device operation (joined by the
  profiler's correlation id of the CUDA runtime call), and
  ``device_ops_by_span_path`` how many operations each launched;
- ``span_metrics``: per-layer readings of the spans and counters (see
  :data:`SPAN_METRICS`);
- ``idle_s_by_step`` (batch cells): the idle seconds by a job's step
  number;
- ``host_self_s``: by span name, how many and the host's seconds in them
  less their children (with ``--trace 0`` too).

The two path sums equal the window's idle and busy seconds. The result
line gains a ``program`` key; its last line is printed and ``--out``
keeps the whole of it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WINDOW = "malbench.window"
SYNC = "host.sync."
NO_SPAN = "(no span)"
NO_LAUNCH = "(no launch record)"
TOP = 10


# ------------------------------------------------------------ span paths
def span_segments(spans: list) -> list:
    """``[(start, end, path)]``: the time the host spent in each chain of
    nested spans, innermost last, for ``spans`` of ``(name, start_ns,
    end_ns)`` (the harness's and the port's, nested by interval: one host
    thread). The window span is the root and stays out of the paths; a
    span that overlaps an earlier one without lying inside it starts where
    that one ends."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    children: dict = {None: []}
    stack: list = []
    for i in order:
        _, a, b = spans[i][:3]
        while stack and not (spans[stack[-1]][1] <= a
                             and b <= spans[stack[-1]][2]):
            stack.pop()
        children.setdefault(stack[-1] if stack else None, []).append(i)
        stack.append(i)
    segments: list = []

    def walk(i, a, b, path):
        name = spans[i][0]
        path = path if name == WINDOW else (
            f"{path}/{name}" if path else name)
        here = path or WINDOW
        cur = a
        for c in children.get(i, ()):
            ca, cb = max(spans[c][1], cur), min(spans[c][2], b)
            if cb <= ca:
                continue
            if ca > cur:
                segments.append((cur, ca, here))
            walk(c, ca, cb, path)
            cur = cb
        if b > cur:
            segments.append((cur, b, here))

    cur = None
    for r in children[None]:
        a = spans[r][1] if cur is None else max(spans[r][1], cur)
        if spans[r][2] > a:
            walk(r, a, spans[r][2], "")
            cur = spans[r][2]
    return segments


def _overlap_by_path(intervals: list, segments: list, out: dict) -> None:
    """Add each interval's seconds to the path of the segments it
    overlaps (both sorted, each list disjoint); time outside every segment
    goes to ``NO_SPAN``."""
    j = 0
    for a, b in intervals:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(segments) and segments[k][0] < b:
            sa, sb, path = segments[k]
            lo, hi = max(sa, cur), min(sb, b)
            if lo > cur:
                out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (lo - cur) / 1e9
            if hi > lo:
                out[path] = out.get(path, 0.0) + (hi - lo) / 1e9
                cur = hi
            k += 1
        if b > cur:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - cur) / 1e9


def path_at(segments: list, starts: list, t: int) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t < segments[i][1]:
        return segments[i][2]
    return NO_SPAN


def by_span_path(host: list, device: list, launches: dict, w0: int,
                 w1: int) -> dict:
    """The window ``[w0, w1)`` of a traced run put down to span paths.

    ``host``: ``(name, start_ns, end_ns)`` host spans; ``device``:
    ``(name, start_ns, end_ns, correlation)`` device operations;
    ``launches``: correlation -> the host time of the runtime call that
    launched it. Busy time is the union of the operations; where two
    overlap, the earlier one takes the shared time. Returns
    ``idle_s_by_span_path``, ``device_s_by_span_path``,
    ``device_ops_by_span_path`` (how many device operations, kernels and
    copies, each span path launched), ``window_s``,
    ``busy_s``, the ``TOP`` longest ``idle_gaps`` (``[path at the gap's
    middle, s]``), ``launch_matched`` (the share of device seconds whose
    launch record was found) and ``gaps``, every idle ``(start, end)``."""
    segments = span_segments(host)
    starts = [s[0] for s in segments]
    ops = sorted((max(a, w0), min(b, w1), corr) for _, a, b, corr in device
                 if b > w0 and a < w1)
    busy: list = []
    device_s: dict = {}
    device_ops: dict = {}
    cursor = w0
    for a, b, corr in ops:
        t = launches.get(corr)
        path = NO_LAUNCH if t is None else path_at(segments, starts, t)
        device_ops[path] = device_ops.get(path, 0) + 1
        lo = max(a, cursor)
        if b <= lo:
            continue
        device_s[path] = device_s.get(path, 0.0) + (b - lo) / 1e9
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = b
        else:
            busy.append([lo, b])
        cursor = b
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    idle_s: dict = {}
    _overlap_by_path(gaps, segments, idle_s)
    busy_s = sum(b - a for a, b in busy) / 1e9
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
        "idle_s_by_span_path": idle_s, "device_s_by_span_path": device_s,
        "device_ops_by_span_path": device_ops,
        "idle_gaps": [[path_at(segments, starts, (a + b) // 2),
                       (b - a) / 1e9] for a, b in top],
        "launch_matched": (1.0 - device_s.get(NO_LAUNCH, 0.0) / busy_s
                           if busy_s else None),
        "gaps": gaps}


def idle_s_by_step(gaps: list, spans: list) -> dict:
    """A job's step number (``stream.step``'s ``req``) -> the idle seconds
    that fell while the host was inside such a step."""
    steps = sorted((s.start_ns, s.end_ns, s.req) for s in spans
                   if s.name == "stream.step")
    out: dict = {}
    _overlap_by_path(gaps, steps, out)
    out.pop(NO_SPAN, None)
    return dict(sorted(out.items(), key=lambda kv: kv[0]))


# --------------------------------------------------------- span metrics
def _percentile(samples, p):
    from malbench.stats import percentile

    return percentile(samples, p)


def _in(spans: list, window) -> list:
    if window is None:
        return spans
    w0, w1 = window
    return [s for s in spans if s.start_ns >= w0 and s.end_ns <= w1]


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def _sync_ms_under(spans: list, name: str) -> dict:
    """index of each ``name`` span -> the ms of the ``host.sync.*`` spans
    nested inside it (by the recorder's parent indices)."""
    out = {i: 0.0 for i, s in enumerate(spans) if s.name == name}
    for s in spans:
        if not s.name.startswith(SYNC):
            continue
        p = s.parent
        while p is not None and spans[p].name != name:
            p = spans[p].parent
        if p is not None:
            out[p] += _ms(s)
    return out


def _enqueue_ms_p50(view: dict, name: str):
    spans = view["spans"]
    inside = {id(s) for s in _in(spans, view["window"])}
    less = [_ms(spans[i]) - sync for i, sync in
            _sync_ms_under(spans, name).items() if id(spans[i]) in inside]
    v = _percentile(less, 50)
    return None if v is None else {"value": v, "n": len(less)}


def _named(view: dict, name: str) -> list:
    return [s for s in _in(view["spans"], view["window"]) if s.name == name]


def _steps(view: dict) -> int:
    return len(_named(view, "stream.step"))


def _generate_device(view: dict):
    paths, steps = view.get("paths"), _steps(view)
    if not paths or not steps:
        return None
    dev = paths["device_s_by_span_path"]

    def ms(part):
        return 1e3 * sum(s for p, s in dev.items()
                         if part in p.split("/")) / steps

    out = {"value": ms("malgen.generate"), "draw": ms("malgen.draw"),
           "sample": ms("malgen.sample"), "assemble": ms("malgen.assemble"),
           "steps": steps}
    ops = paths.get("device_ops_by_span_path")
    if ops:
        # device operations launched a step: by generation, by the step
        for key, part in (("launches", "malgen.generate"),
                          ("step_launches", "stream.step")):
            out[key] = sum(n for p, n in ops.items()
                           if part in p.split("/")) / steps
    chunks = view["counters"].get("malgen.chunks_in_place")
    if chunks is not None:
        out["chunks_in_place"] = chunks / steps
    return out


def _job_edges(view: dict):
    paths = view.get("paths")
    if not paths or not _named(view, "run.job"):
        return None
    idle = sum(s for p, s in paths["idle_s_by_span_path"].items()
               if "run.job" in p.split("/")
               and "stream.step" not in p.split("/"))
    return {"value": 100.0 * idle / paths["window_s"], "idle_s": idle}


def _syncs_per_step(view: dict):
    steps = len([s for s in view["spans"] if s.name == "stream.step"])
    if not steps or not _named(view, "run.job"):
        return None
    syncs = sum(n for k, n in view["counters"].items()
                if k.startswith("host.syncs."))
    return {"value": syncs / steps, "syncs": syncs, "steps": steps}


def _snapshot(view: dict):
    snaps = [_ms(s) for s in _named(view, "serve.snapshot")]
    submits = [s for s in view["spans"] if s.name == "serve.submit"]
    if not snaps or not submits:
        return None
    rebuilds = view["counters"].get("serve.snapshot_rebuilds", 0)
    return {"value": _percentile(snaps, 50),
            "rebuilds_per_batch": rebuilds / len(submits)}


def _device_wait(view: dict):
    spans = view["spans"]
    waits = [_ms(s) for s in _in(spans, view["window"])
             if s.name == SYNC + "query_done" and s.parent is not None
             and spans[s.parent].name == "serve.wait"]
    if not waits:
        return None
    return {"value": _percentile(waits, 95), "p50": _percentile(waits, 50),
            "n": len(waits)}


def _upload(view: dict):
    uploads = [_ms(s) for s in _named(view, "query.upload")]
    if not uploads:
        return None
    return {"value": _percentile(uploads, 95),
            "p50": _percentile(uploads, 50), "n": len(uploads)}


def _copy(view: dict):
    copies = [_ms(s) for s in _named(view, "query.copy")]
    if not copies:
        return None
    n = len([s for s in view["spans"] if s.name == "query.copy"])
    return {"value": _percentile(copies, 50),
            "bytes": view["counters"].get("query.copy_bytes", 0) / n}


# name -> (unit, reader of the view): the per-layer readings of the port's
# spans and counters; a reader returns None where it finds nothing
SPAN_METRICS = {
    "step.enqueue_ms.p50": ("ms", lambda v: _enqueue_ms_p50(v, "stream.step")
                            if _named(v, "run.job") else None),
    "generate.device_ms_per_step": ("ms/step", _generate_device),
    "device.idle_share.job_edges": ("%", _job_edges),
    "host.syncs_per_step": ("syncs/step", _syncs_per_step),
    "ingest.enqueue_ms.p50": ("ms", lambda v: _enqueue_ms_p50(
        v, "serve.ingest")),
    "serve.snapshot_ms.p50": ("ms", _snapshot),
    "query.device_wait_ms.p95": ("ms", _device_wait),
    "query.copy_ms.p50": ("ms", _copy),
    # where a batch waits for the ingest step in flight: the masks' upload
    # (pageable, so the copy waits for the stream's queue) inside submit
    "query.upload_ms.p95": ("ms", _upload),
}


def host_self_s(spans: list, window=None) -> dict:
    """name -> [count, seconds the host spent in the span less its
    children] over the spans inside ``window``."""
    child = [0] * len(spans)
    for s in spans:
        if s.parent is not None:
            child[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    inside = {id(s) for s in _in(spans, window)}
    for i, s in enumerate(spans):
        if id(s) in inside:
            n, sec = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, sec + (s.end_ns - s.start_ns - child[i])
                           / 1e9)
    return {k: list(v) for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1][1])}


def span_metrics(spans: list, counters: dict, window=None,
                 paths=None) -> dict:
    """Every reading of :data:`SPAN_METRICS` that finds something to read:
    ``spans`` and ``counters`` as ``repro_torch.common.trace.stop()`` gives
    them, ``window`` ``(w0, w1)`` (None: every span), ``paths``
    ``by_span_path``'s result (None: an untraced run)."""
    view = {"spans": spans, "counters": counters, "window": window,
            "paths": paths}
    out = {}
    for name, (unit, read) in SPAN_METRICS.items():
        value = read(view)
        if value is not None:
            out[name] = {**value, "unit": unit}
    return out


# ------------------------------------------------------------- the run
def raw_events(prof) -> tuple:
    """A stopped session's device operations ``(name, start_ns, end_ns,
    correlation)`` and its runtime records, correlation -> host start."""
    from torch.autograd import DeviceType

    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(),
                           e.start_ns() + e.duration_ns(),
                           e.correlation_id()))
        elif e.correlation_id() > 0:
            launches[e.correlation_id()] = e.start_ns()
    return device, launches


@contextlib.contextmanager
def recorded(harness, mtrace):
    """``harness.execute`` with the recorder over each run's window and
    the profiler's raw records kept; yields the list of those runs'
    ``(spans, counters, raw)``."""
    from repro_torch.common import trace

    got: list = []
    raw: list = []

    class SpanRun(harness.Run):
        @contextlib.contextmanager
        def window(self):
            trace.start()
            try:
                with super().window() as t0:
                    yield t0
            finally:
                spans, counters = trace.stop()
                got.append((self, spans, counters, raw[-1] if raw else None))

    events = mtrace.events

    def keep(prof):
        raw.append(raw_events(prof))
        return events(prof)

    run_cls, harness.Run, mtrace.events = harness.Run, SpanRun, keep
    try:
        yield got
    finally:
        harness.Run, mtrace.events = run_cls, events


def program_view(run, spans, counters, raw) -> dict:
    """The ``program`` key of the result line."""
    out = {"spans": len(spans),
           "counters": {k: n for k, n in counters.items() if n}}
    window = paths = None
    win = [s for s in run.spans.spans if s[0] == WINDOW]
    if raw is not None and win:
        _, w0, w1 = win[0]
        window = (w0, w1)
        host = list(run.spans.spans) + [s[:3] for s in spans]
        paths = by_span_path(host, raw[0], raw[1], w0, w1)
        gaps = paths.pop("gaps")
        out.update(paths)
        if any(s.name == "run.job" for s in spans):
            out["idle_s_by_step"] = idle_s_by_step(gaps, spans)
    out["span_metrics"] = span_metrics(spans, counters, window, paths)
    out["host_self_s"] = host_self_s(spans, window)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/trace_cell.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", type=pathlib.Path,
                    help="write the whole result line here")
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from malbench import harness
    from malbench import trace as mtrace

    harness.steady_host_allocator()
    resolved = harness.resolve(harness.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    with recorded(harness, mtrace) as got:
        result = harness.execute(resolved, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_PROCESS)
    run, spans, counters, raw = got[-1]
    result["program"] = program_view(run, spans, counters, raw)
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
