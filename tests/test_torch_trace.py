"""The port's span and counter recorder (``repro_torch.common.trace``) and
``tools/trace_cell.py``, which lays its spans over a traced benchmark run.

- The recorder: off records nothing and hands out one null context; spans
  nest by parent index and carry ``req``; ``stop()`` gives the launch
  counters' differences; the host-sync helpers return what they read.
- Tiny sphere and mapreduce streaming runs on the CPU: the span tree of
  each layer, and the host syncs (none in sphere; 1 + rounds a step and
  three a job in mapreduce); the results are the same on and off.
- A service batch: ``serve.submit`` and ``serve.wait`` share the ticket.
- ``tools/trace_cell.py``: idle and busy time by span path on a synthetic
  trace, each reading of its span metrics, and a whole tiny cell on the
  CPU.
- On the card (``-m cuda``): a span around a K4 launch and its sync holds
  the kernel's record and its launch record in a profiler session, so the
  spans and the device trace share a clock.

No JAX here: the card's test lives in this file too.
"""

import json
import pathlib
import sys

import pytest
import torch

from repro_torch import kernels
from repro_torch.common import nodes, trace
from repro_torch.common.trace import Span
from repro_torch.common.types import ExchangePlan
from repro_torch.core import api
from repro_torch.malgen import MalGenConfig, make_seed_streaming

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "tools"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

import trace_cell  # noqa: E402

P, CHUNK, STEPS = 4, 1024, 3
CFG = MalGenConfig(num_sites=512, num_entities=4096)


@pytest.fixture(autouse=True)
def recorder_off():
    trace.stop()
    yield
    trace.stop()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m cuda "
                    "tests/test_torch_trace.py on the card)")
    return torch.device("cuda")


def _names(spans, parent):
    return [s.name for s in spans if s.parent == parent]


# ------------------------------------------------------------ recorder
def test_off_records_nothing_and_shares_one_null_context():
    a, b = trace.span("x"), trace.span("y", req=3)
    assert a is b
    with a:
        trace.count("n", 5)
        trace.record("z", 1, 2)
    assert trace.seq("run.job") is None
    assert trace.host_read(torch.tensor(7), "site") == 7
    assert trace.stop() == ([], {})


def test_spans_nest_carry_req_and_counters():
    trace.start()
    with trace.span("a", req="job-1"):
        with trace.span("b"):
            trace.count("c")
            trace.count("c", 2)
        with trace.span("d", req=4):
            trace.record("e", 10, 20)
    with trace.span("f"):
        pass
    open_span = trace.span("g")
    open_span.__enter__()
    spans, counters = trace.stop()
    assert [s.name for s in spans] == ["a", "b", "d", "e", "f", "g"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None, None]
    assert spans[0].req == "job-1" and spans[2].req == 4
    assert spans[3][1:3] == (10, 20)
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[1].end_ns \
        <= spans[2].start_ns <= spans[0].end_ns
    assert counters["c"] == 3
    open_span.__exit__(None, None, None)   # after stop: touches nothing
    assert trace.stop() == ([], {})


def test_seq_numbers_requests_from_start():
    trace.start()
    assert [trace.seq("run.job") for _ in range(3)] == [0, 1, 2]
    assert trace.seq("serve.ingest") == 0
    trace.stop()
    trace.start()
    assert trace.seq("run.job") == 0


def test_stop_gives_launch_differences(monkeypatch):
    fn = kernels.KERNEL_WRAPPERS["segment_hist"]
    monkeypatch.setattr(fn, "launches", fn.launches + 5)
    trace.start()
    fn.launches += 3
    _, counters = trace.stop()
    assert counters["launches.segment_hist"] == 3
    assert counters["launches.powerlaw_sample"] == 0
    assert set(counters) >= {f"launches.{k}" for k in kernels.launch_counts()}


class _Waitable:
    def __init__(self):
        self.calls = 0

    def synchronize(self):
        self.calls += 1


def test_host_sync_helpers_record_and_count():
    w = _Waitable()
    assert trace.host_wait(w, "off")[0] <= trace.host_wait(w, "off")[1]
    trace.start()
    with trace.span("outer"):
        value = trace.host_read(torch.tensor([41]).sum() + 1, "read")
        t0, t1 = trace.host_wait(w, "wait")
    spans, counters = trace.stop()
    assert value == 42 and w.calls == 3
    assert [s.name for s in spans] == ["outer", "host.sync.read",
                                       "host.sync.wait"]
    assert spans[1].parent == 0 and spans[2].parent == 0
    assert spans[2][1:3] == (t0, t1)
    assert counters["host.syncs.read"] == 1
    assert counters["host.syncs.wait"] == 1


def test_gang_clock_parts_are_the_spans():
    group = nodes.NodeGroup(2, rank=0, world=2)
    trace.start()
    nodes._gloo(lambda: sum(range(10_000)), group, 16)
    spans, _ = trace.stop()
    (gloo,) = spans
    assert gloo.name == "collective.gloo"
    assert (gloo.end_ns - gloo.start_ns) / 1e6 == group.clock.gloo_ms
    assert group.clock.bytes == 16 and group.clock.calls == 1


# ----------------------------------------------------- streaming runs
def _seed():
    return make_seed_streaming(7, CFG, P * STEPS, CHUNK, device="cpu")


def _job(seed, backend):
    return api.run(seed, nodes=P, engine="streaming", cfg=CFG,
                   num_chunks=P * STEPS, chunk_records=CHUNK,
                   backend=backend, statistic="B",
                   plan=ExchangePlan(impl="counting", capacity_factor=0.5),
                   return_shuffle_stats=True, device="cpu")


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


@pytest.mark.parametrize("backend", ["sphere", "mapreduce"])
def test_streaming_span_tree(backend):
    seed = _seed()
    trace.start()
    _job(seed, backend)
    spans, counters = trace.stop()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["run.job"]
    assert spans[0].req == 0
    top = [spans[j].name for j in _children(spans, 0)]
    tail = (["stream.collective", "run.finalize"] if backend == "sphere"
            else ["stream.collective", "host.sync.overflow", "run.finalize"])
    assert top == ["run.setup"] + ["stream.step"] * STEPS + tail
    steps = [j for j in _children(spans, 0) if spans[j].name == "stream.step"]
    assert [spans[j].req for j in steps] == list(range(STEPS))
    for j in steps:
        gen, fold = _children(spans, j)
        assert [spans[gen].name, spans[fold].name] == ["malgen.generate",
                                                       "stream.fold"]
        assert _names(spans, gen) == ["malgen.assemble"] \
            + ["malgen.draw", "malgen.sample"] * P
        inner = [spans[k].name for k in _children(spans, fold)]
        if backend == "sphere":
            assert inner == []
        else:
            rounds = inner.count("shuffle.round")
            assert inner == ["shuffle.order", "host.sync.global_count"] \
                + ["shuffle.round"] * rounds
            for k in _children(spans, fold)[2:]:
                assert _names(spans, k) == ["host.sync.global_count"]
    coll = [j for j in _children(spans, 0)
            if spans[j].name == "stream.collective"][0]
    syncs = {k: n for k, n in counters.items() if k.startswith("host.syncs")}
    if backend == "sphere":
        assert syncs == {}
        assert _names(spans, coll) == []
    else:
        assert _names(spans, coll) == ["host.sync.capacity",
                                       "host.sync.rounds"]
        rounds = sum(s.name == "shuffle.round" for s in spans)
        assert rounds > STEPS          # capacity 0.5: more than one a step
        assert syncs == {"host.syncs.global_count": STEPS + rounds,
                         "host.syncs.capacity": 1, "host.syncs.rounds": 1,
                         "host.syncs.overflow": 1}


@pytest.mark.parametrize("backend", ["sphere", "mapreduce"])
def test_generation_counts_its_chunks_in_place(backend):
    """``malgen.chunks_in_place`` counts P a step: every chunk of the
    job was written in place."""
    seed = _seed()
    trace.start()
    _job(seed, backend)
    spans, counters = trace.stop()
    steps = sum(s.name == "stream.step" for s in spans)
    assert steps == STEPS
    assert counters["malgen.chunks_in_place"] == P * steps


def test_results_equal_on_and_off():
    seed = _seed()
    off = _job(seed, "mapreduce")
    trace.start()
    on = _job(seed, "mapreduce")
    trace.stop()
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(off[1], on[1]):
        assert int(torch.as_tensor(a)) == int(torch.as_tensor(b))


def test_service_batch_spans_share_the_ticket():
    from repro_torch.serve import MalStoneService, default_query_mix

    svc = MalStoneService(nodes=P, num_sites=CFG.num_sites,
                          chunk_records=CHUNK, backend="mapreduce",
                          seed=_seed(), cfg=CFG, num_chunks=P * STEPS,
                          device="cpu")
    specs = default_query_mix(num_sites=CFG.num_sites)
    svc.wait(svc.submit(specs))
    trace.start()
    svc.ingest_chunks(1)
    t1 = svc.submit(specs)
    on = svc.wait(t1)
    t2 = svc.submit(specs)
    svc.wait(t2)
    spans, counters = trace.stop()
    off = svc.query(specs)
    for a, b in zip(on, off):
        assert (a.rho.view("int32") == b.rho.view("int32")).all()
    assert [s.name for s in spans if s.parent is None] == [
        "serve.ingest", "serve.submit", "serve.wait", "serve.submit",
        "serve.wait"]
    assert spans[0].req == 0
    assert _names(spans, 0) == ["stream.step"]
    for ticket in (t1, t2):
        mine = [i for i, s in enumerate(spans)
                if s.parent is None and s.req == ticket]
        assert [spans[i].name for i in mine] == ["serve.submit",
                                                 "serve.wait"]
        sub, wait = mine
        want = ["query.encode", "serve.snapshot", "query.launch"] \
            if ticket == t1 else ["query.encode", "query.launch"]
        assert _names(spans, sub) == want
        assert _names(spans, _children(spans, sub)[-1]) == ["query.upload"]
        # on the CPU no event is recorded, so the wait holds no host.sync
        assert _names(spans, wait) == ["query.copy", "query.decode"]
        kids = _children(spans, sub) + _children(spans, wait)
        assert all(spans[j].req == ticket for j in kids
                   if spans[j].name != "serve.snapshot")
    snap = [i for i, s in enumerate(spans) if s.name == "serve.snapshot"]
    assert _names(spans, snap[0]) == ["stream.collective",
                                      "host.sync.overflow"]
    assert counters["serve.snapshot_rebuilds"] == 1
    assert counters["serve.snapshot_hits"] == 1
    copied = sum(x.nbytes for a in on for x in (a.rho, a.num, a.den))
    assert counters["query.copy_bytes"] > copied


# ---------------------------------------------------- the span paths
HOST = [("malbench.window", 0, 1000), ("malbench.job", 100, 900),
        ("run.job", 120, 800), ("stream.step", 200, 500),
        ("stream.fold", 300, 480), ("host.sync.global_count", 350, 420),
        ("stream.step", 500, 780), ("malgen.generate", 510, 600)]
DEV = [("gen_kernel", 205, 290, 1), ("fold_kernel", 290, 360, 2),
       ("late_kernel", 340, 370, 3), ("next_kernel", 515, 650, 4),
       ("outside", 1100, 1200, 5), ("orphan", 660, 700, 6)]
LAUNCH = {1: 210, 2: 310, 3: 320, 4: 520, 5: 950}


def test_by_span_path_names_gaps_by_the_program_span():
    r = trace_cell.by_span_path(HOST, DEV, LAUNCH, 0, 1000)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["busy_s"] == pytest.approx((370 - 205 + 650 - 515 + 40) * 1e-9)
    idle = r["idle_s_by_span_path"]
    sync = ("malbench.job/run.job/stream.step/stream.fold/"
            "host.sync.global_count")
    assert idle[sync] == pytest.approx(50e-9)
    assert idle["malbench.job/run.job/stream.step/stream.fold"] \
        == pytest.approx(60e-9)
    assert idle["malbench.window"] == pytest.approx(200e-9)
    assert idle["malbench.job"] == pytest.approx(120e-9)
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    dev = r["device_s_by_span_path"]
    assert sum(dev.values()) == pytest.approx(r["busy_s"])
    assert dev["malbench.job/run.job/stream.step"] == pytest.approx(85e-9)
    assert dev["malbench.job/run.job/stream.step/stream.fold"] \
        == pytest.approx(80e-9)   # fold_kernel, and late_kernel past it
    assert dev["malbench.job/run.job/stream.step/malgen.generate"] \
        == pytest.approx(135e-9)
    assert dev[trace_cell.NO_LAUNCH] == pytest.approx(40e-9)
    assert r["launch_matched"] == pytest.approx(1 - 40 / 340)
    assert idle["malbench.job/run.job/stream.step"] == pytest.approx(125e-9)
    assert r["idle_gaps"][0] == ["malbench.job", pytest.approx(300e-9)]
    steps = [Span("stream.step", 200, 500, 0, 0),
             Span("stream.step", 500, 780, 0, 1), Span("run.job", 120, 800,
                                                      None, 0)]
    assert trace_cell.idle_s_by_step(r["gaps"], steps) == {
        0: pytest.approx(5e-9 + 130e-9), 1: pytest.approx(105e-9)}


def test_device_ops_are_counted_by_the_span_that_launched_them():
    """Each device operation in the window counts once, under the span
    path its launch fell in (an operation hidden by an earlier one's
    overlap too); the generate reading gives them a step, beside the
    chunks written in place a step."""
    r = trace_cell.by_span_path(HOST, DEV, LAUNCH, 0, 1000)
    step = "malbench.job/run.job/stream.step"
    assert r["device_ops_by_span_path"] == {
        step: 1, f"{step}/stream.fold": 2, f"{step}/malgen.generate": 1,
        trace_cell.NO_LAUNCH: 1}
    spans = [Span("stream.step", 200, 500, None, 0),
             Span("stream.step", 500, 780, None, 1)]
    view = {"spans": spans, "counters": {"malgen.chunks_in_place": 16},
            "window": None, "paths": r}
    got = trace_cell.span_metrics(spans, view["counters"], None, r)
    gen = got["generate.device_ms_per_step"]
    assert gen["launches"] == 0.5 and gen["step_launches"] == 2.0
    assert gen["chunks_in_place"] == 8.0


def test_span_segments_cover_overlaps_once():
    segs = trace_cell.span_segments([("malbench.window", 0, 100),
                                     ("a", 10, 50), ("b", 40, 70)])
    assert segs == [(0, 10, "malbench.window"), (10, 50, "a"),
                    (50, 70, "b"), (70, 100, "malbench.window")]
    assert sum(b - a for a, b, _ in segs) == 100


def _span(name, a, b, parent=None, req=None):
    return Span(name, a * 1_000_000, b * 1_000_000, parent, req)


def test_span_metrics_of_a_batch_window():
    spans = [_span("run.job", 0, 100, None, 0),
             _span("stream.step", 0, 10, 0, 0),
             _span("stream.fold", 2, 9, 1),
             _span("host.sync.global_count", 3, 7, 2),
             _span("stream.step", 10, 16, 0, 1),
             _span("stream.step", 16, 30, 0, 2),
             _span("host.sync.global_count", 20, 22, 5),
             _span("run.job", 100, 200, None, 1)]
    counters = {"host.syncs.global_count": 2, "host.syncs.overflow": 1,
                "launches.segment_hist": 3}
    paths = {"window_s": 2.0,
             "idle_s_by_span_path": {"malbench.job/run.job": 0.02,
                                     "malbench.job/run.job/run.setup": 0.01,
                                     "malbench.job/run.job/stream.step": 0.5,
                                     "malbench.job": 0.3},
             "device_s_by_span_path": {
                 "malbench.job/run.job/stream.step/malgen.generate/"
                 "malgen.sample": 0.003,
                 "malbench.job/run.job/stream.step/malgen.generate": 0.006,
                 "malbench.job/run.job/stream.step/stream.fold": 0.5}}
    m = trace_cell.span_metrics(spans, counters, (0, 10**9), paths)
    assert set(m) == {"step.enqueue_ms.p50", "generate.device_ms_per_step",
                      "device.idle_share.job_edges", "host.syncs_per_step"}
    assert m["step.enqueue_ms.p50"]["value"] == pytest.approx(6.0)
    assert m["step.enqueue_ms.p50"]["unit"] == "ms"
    assert m["generate.device_ms_per_step"]["value"] == pytest.approx(3.0)
    assert m["generate.device_ms_per_step"]["sample"] == pytest.approx(1.0)
    assert m["device.idle_share.job_edges"]["value"] == pytest.approx(1.5)
    assert m["host.syncs_per_step"]["value"] == pytest.approx(1.0)
    untraced = trace_cell.span_metrics(spans, counters)
    assert set(untraced) == {"step.enqueue_ms.p50", "host.syncs_per_step"}


def test_span_metrics_of_a_serve_window():
    spans = [_span("serve.ingest", 0, 10, None, 0),
             _span("stream.step", 0, 9, 0),
             _span("serve.submit", 10, 14, None, 0),
             _span("serve.snapshot", 11, 13, 2),
             _span("serve.wait", 14, 30, None, 0),
             _span("host.sync.query_done", 14, 24, 4),
             _span("query.copy", 24, 29, 4, 0),
             _span("serve.ingest", 30, 36, None, 1),
             _span("host.sync.global_count", 31, 33, 7),
             _span("serve.submit", 36, 37, None, 1),
             _span("serve.wait", 37, 40, None, 1),
             _span("host.sync.query_done", 37, 38, 10),
             _span("query.copy", 38, 40, 10, 1)]
    counters = {"serve.snapshot_rebuilds": 1, "serve.snapshot_hits": 1,
                "query.copy_bytes": 26_000_000}
    m = trace_cell.span_metrics(spans, counters, (0, 10**9))
    assert set(m) == {"ingest.enqueue_ms.p50", "serve.snapshot_ms.p50",
                      "query.device_wait_ms.p95", "query.copy_ms.p50"}
    self_s = trace_cell.host_self_s(spans)
    assert self_s["serve.ingest"] == [2, pytest.approx(0.001 + 0.004)]
    assert self_s["serve.wait"] == [2, pytest.approx(0.001 + 0.0)]
    assert m["ingest.enqueue_ms.p50"]["value"] == pytest.approx(7.0)
    assert m["serve.snapshot_ms.p50"]["value"] == pytest.approx(2.0)
    assert m["serve.snapshot_ms.p50"]["rebuilds_per_batch"] == 0.5
    assert m["query.device_wait_ms.p95"]["value"] == pytest.approx(9.55)
    assert m["query.copy_ms.p50"]["value"] == pytest.approx(3.5)
    assert m["query.copy_ms.p50"]["bytes"] == 13_000_000
    assert trace_cell.span_metrics([], {}) == {}


def _tiny(cell):
    from malbench import harness

    resolved = harness.resolve(harness.load_spec(ROOT), cell)
    config, traffic = resolved["config"], resolved["traffic"]
    config["malgen"].update(num_sites=512, num_entities=4096)
    config.update(chunk_records=4096, steps=3)
    for q in traffic.get("queries", []):
        if q.get("site") is not None:
            q["site"] = 511
    return resolved


@pytest.mark.parametrize("cell,traced,want", [
    ("malstone-b10-mapreduce.batch", True,
     {"step.enqueue_ms.p50", "host.syncs_per_step",
      "generate.device_ms_per_step", "device.idle_share.job_edges"}),
    ("malstone-b10-sphere.serve", False,
     {"ingest.enqueue_ms.p50", "serve.snapshot_ms.p50",
      "query.copy_ms.p50", "query.upload_ms.p95"}),
])
def test_a_tiny_cell_with_the_recorder_on(cell, traced, want):
    from malbench import harness
    from malbench import trace as mtrace

    with trace_cell.recorded(harness, mtrace) as got:
        result = harness.execute(_tiny(cell), 2**31 + 33, 0.3, traced,
                                 "cpu", 0.0)
    assert harness.Run.__name__ == "Run" and not trace.RECORDER.on
    assert result["correct"] is True
    run, spans, counters, raw = got[-1]
    view = trace_cell.program_view(run, spans, counters, raw)
    assert set(view["span_metrics"]) == want
    if traced:
        assert sum(view["idle_s_by_span_path"].values()) == pytest.approx(
            view["window_s"] - view["busy_s"])
        assert view["span_metrics"]["host.syncs_per_step"]["value"] > 2
        assert set(view["idle_s_by_step"]) == {0, 1, 2}
        json.dumps(view)
    else:
        assert raw is None and "idle_s_by_span_path" not in view


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_span_holds_its_kernel_record_on_the_card(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.segment_hist.ops import segment_hist

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, sites, weeks = 1 << 20, 1000, 52
    site = torch.randint(0, sites, (2, n), generator=g, device=cuda_device,
                         dtype=torch.int32)
    week = torch.randint(0, weeks, (2, n), generator=g, device=cuda_device,
                         dtype=torch.int32)
    mark = (site % 3 == 0).to(torch.int32)
    valid = torch.ones(2, n, dtype=torch.bool, device=cuda_device)
    segment_hist(site, week, mark, valid, num_sites=sites, num_weeks=weeks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.start()
        with trace.span("k4"):
            segment_hist(site, week, mark, valid, num_sites=sites,
                         num_weeks=weeks)
            trace.host_wait(torch.cuda.current_stream(), "k4")
        spans, _ = trace.stop()
    device, launches = trace_cell.raw_events(prof)
    (k4,) = [d for d in device if "segment_hist_kernel(" in d[0]]
    span = spans[0]
    assert span.start_ns <= k4[1] < k4[2] <= span.end_ns
    assert span.start_ns <= launches[k4[3]] <= k4[1]
