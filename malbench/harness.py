"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything of one configuration, traffic mix or metric is a file found by
its name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(run)`` that returns ``{"value": ...}``,
optionally with more keys, or ``None`` where it finds nothing to read).
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import importlib.util
import json
import pathlib
import sys

import torch

from malbench import check, generator, trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
# Top-level modules a run must not load: JAX and the JAX package, whose
# name the port's (repro_torch) begins with, so names compare whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The kernel each wrapper of the port launches once a call, by its symbol
# in the trace; a traced run holds its records against the wrappers'
# launch counters.
KERNEL_SYMBOLS = {
    "count_scatter.count": ("count_tiles_kernel(",),
    "count_scatter.scatter": ("scatter_tiles_kernel(",),
    "segment_hist.packed": ("packed_hist_kernel(",),
    "segment_hist": ("segment_hist_kernel(",),
    "windowed_ratio.masked": ("masked_window_ratio_kernel(",),
    "powerlaw_sample": ("::sample_kernel(", "direct_kernel("),
    "windowed_ratio": ("::windowed_ratio_kernel(",),
}
# glibc's mallopt parameters
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3


def steady_host_allocator() -> None:
    """Fix glibc's thresholds for large host blocks (the service copies 13
    MB of answers to the host a batch). Left dynamic, they move with the
    order of a process's first frees, so one run's copies reuse the heap
    and the next run's fault in fresh pages: the same work at two speeds.
    Fixed, every run takes the path a long-running process settles on."""
    name = ctypes.util.find_library("c")
    if name:
        libc = ctypes.CDLL(name)
        libc.mallopt(M_MMAP_THRESHOLD, 64 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, 512 << 20)


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str, here: pathlib.Path = HERE) -> dict:
    """The cell's entry, configuration, traffic and metric entries, each
    read from its file."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((here.parent / conf["file"]).read_text())
    traffic = json.loads(
        (here / "traffic" / f"{cell['traffic']}.json").read_text())
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": cell_metrics(spec["end_to_end"], workload),
            "per_layer": cell_metrics(spec["per_layer"], workload)}


def in_cell(metric: dict, workload: str) -> bool:
    """Whether a metric belongs to a cell: its ``workloads`` list it, or it
    has none (a reader that finds nothing to read there returns None)."""
    return workload in metric.get("workloads", [workload])


def cell_metrics(metrics: list, workload: str) -> list:
    return [m for m in metrics if in_cell(m, workload)]


def reader(name: str, here: pathlib.Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "malbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """One run's state: its inputs, the window, the counters and outputs
    the generator leaves, and (traced) the trace's reduction."""

    def __init__(self, resolved: dict, seed: int, seconds: float,
                 traced: bool, device, t_process: float):
        self.cell = resolved["cell"]
        self.config = resolved["config"]
        self.traffic = resolved["traffic"]
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = torch.device(device)
        self.t_process = t_process
        self.counters: dict = {}
        self.outputs = None
        self.trace = None
        self.launches = None
        self.setup_s = self.window_s = None
        self.build = {}
        self.info = {}
        self.spans = trace.Spans(traced)

    def span(self, name: str):
        return self.spans.span(name)

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; a traced run
        profiles exactly it."""
        from repro_torch import kernels

        generator.sync(self.device)
        prof = trace.session(self.device) if self.traced else None
        if prof is not None:
            prof.start()
        before = kernels.launch_counts()
        t0 = generator.CLOCK()
        self.setup_s = t0 - self.t_process
        with self.span(trace.WINDOW_SPAN):
            yield t0
            generator.sync(self.device)
        self.window_s = generator.CLOCK() - t0
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        if prof is not None:
            prof.stop()
            self.trace = trace.reduce(self.spans.spans, trace.events(prof))
            if self.device.type == "cuda":
                self._hold_trace_to_counters()

    def _hold_trace_to_counters(self) -> None:
        """A launch with no kernel record in the trace means the profiler
        dropped records: no device number is read from such a trace."""
        for wrapper, n in self.launches.items():
            found = sum(trace.kernel_records(self.trace["ops"], sym)[0]
                        for sym in KERNEL_SYMBOLS[wrapper])
            if found != n:
                raise RuntimeError(
                    f"trace holds {found} kernel records of {wrapper} for "
                    f"{n} launches in the window")


def build_kernels() -> dict:
    """Build (first run in a checkout) or find the port's kernel libraries;
    their build is part of set-up, reported apart."""
    from repro_torch.kernels import _build

    built = all(_build.library_path(n).exists() for n in _build.SOURCES)
    t0 = generator.CLOCK()
    _build.build_all()
    return {"kernel_build_s": generator.CLOCK() - t0, "built_now": not built}


def execute(resolved: dict, seed: int, seconds: float, traced: bool,
            device, t_process: float) -> dict:
    """Run the cell once on ``device`` and return its result line (a
    dict)."""
    run = Run(resolved, seed, seconds, traced, device, t_process)
    if run.device.type == "cuda":
        run.build = build_kernels()
        torch.cuda.reset_peak_memory_stats(run.device)
    generator.run_mix(run)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    run.counters["memory_peak_bytes"] = peak
    outputs, run.outputs = run.outputs, None
    generator.sync(run.device)
    verdict = check.compare(run, outputs)
    del outputs
    wanted = resolved["per_layer" if traced else "end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {**value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device)
                            if run.device.type == "cuda" else "cpu"),
                   "count": resolved["cell"]["chips"],
                   "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"], "failed": verdict["failed"],
              "metrics": metrics, "device": device_info}
    if traced and run.trace is not None:
        device_info.update(busy_s=run.trace["busy_s"],
                           window_s=run.trace["window_s"])
        result["breakdown"] = run.trace["breakdown"]
        run.info["idle_s_by_host_span"] = run.trace["idle_s_by_host_span"]
    result["info"] = run.info
    result["setup"] = dict(run.build, setup_s=run.setup_s)
    result["checks"] = verdict["checks"]
    return result


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, the names compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})
