"""The port's overlap runner (``core/overlap.py``) against the streaming
engine, the one-shot run and JAX's ``OverlapStreamingRunner``, exactly.

Equality is exact: integer histograms, the bits of ``rho``, every
``ShuffleStats`` field, with ``overlap`` True and False. On the CPU both
values run the serial order; the two-stream schedule itself is held here
against fake streams (the order of generation, waits, folds and
synchronisations), and on the card by ``tests/test_torch_cuda.py``.

JAX's runner is given the same records: the port's chunk source is
patched with JAX's chunks, made from JAX's draws through
``test_torch_streaming._jax_chunk_draws``.

- P = 1 runs in this process against a 1-device JAX mesh.
- P = 4 needs 4 JAX host devices, so the JAX side runs once per module in
  a subprocess: this file run as a script (``python
  tests/test_torch_overlap.py OUT.npz``) forces 4 devices.
"""

import os
import pathlib
import subprocess
import sys

if __name__ == "__main__":
    from repro.common.env import force_host_devices

    force_host_devices(4)

import jax
import numpy as np
import pytest

from repro.common.types import ExchangePlan as JaxPlan
from repro.core.overlap import OverlapStreamingRunner as JaxRunner
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import make_seed_streaming as jax_seed_streaming

HERE = pathlib.Path(__file__).resolve().parent
KW = dict(num_sites=301, num_entities=1000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
JCFG = JaxConfig(**KW)
KEY, NUM_CHUNKS, CHUNK = 11, 8, 128
P4 = 4
STATS = ("sent", "overflow", "capacity", "rounds", "residual",
         "bytes_exchanged")
STATISTICS = ("A", "B", "B-fixed")
# (backend, exchange impl, capacity factor): mapreduce at 0.5 so that a
# chunk needs several rounds
CASES = (("streams", "auto", 2.0), ("sphere", "auto", 2.0),
         ("mapreduce_combiner", "auto", 2.0),
         ("mapreduce", "counting", 0.5))


def _jax_seed():
    return jax_seed_streaming(jax.random.key(KEY), JCFG, NUM_CHUNKS, CHUNK)


def _jax_runner_results(mesh):
    """JAX's runner over every case, overlap on and off: the padded
    histogram, rho of B and the global ShuffleStats, as numpy."""
    seed = _jax_seed()
    out = {}
    for backend, impl, cf in CASES:
        runner = JaxRunner(seed, JCFG, mesh=mesh, num_chunks=NUM_CHUNKS,
                           chunk_records=CHUNK, backend=backend,
                           plan=JaxPlan(impl=impl, capacity_factor=cf))
        for ov in (True, False):
            hist, stats = runner.run(overlap=ov)
            res, _ = runner.run_result("B", overlap=ov)
            tag = f"{backend}/{ov}"
            out[f"{tag}/hist"] = np.asarray(hist)
            out[f"{tag}/rho"] = np.asarray(res.rho)
            if stats is not None:
                out.update({f"{tag}/stats/{f}": np.asarray(
                    int(getattr(stats, f))) for f in STATS})
    return out


if __name__ == "__main__":
    assert jax.device_count() == P4, jax.devices()
    np.savez(sys.argv[1], **_jax_runner_results(
        jax.make_mesh((P4,), ("data",))))
    sys.exit(0)

import torch  # noqa: E402

from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.core import (  # noqa: E402
    malstone_run,
    malstone_run_streaming,
)
from repro_torch.core import overlap  # noqa: E402
from repro_torch.core.overlap import OverlapStreamingRunner  # noqa: E402
from repro_torch.core.streaming import (  # noqa: E402
    streaming_histogram_generate,
)
from repro_torch.malgen import (  # noqa: E402
    MalGenConfig,
    generate_chunk,
    generate_chunked_log,
    make_seed_streaming,
    seed_from_numpy,
)
from test_torch_streaming import (  # noqa: E402
    _jax_chunk_draws,
    _seed_arrays,
)

TCFG = MalGenConfig(**KW)


def _plan(impl, cf):
    return ExchangePlan(impl=impl, capacity_factor=cf)


def _same(a, b, msg):
    for f in ("total", "marked"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{f} {msg}"
    assert torch.equal(a.rho.view(torch.int32), b.rho.view(torch.int32)), \
        f"rho bits {msg}"


def _stats_list(stats):
    return None if stats is None else [int(getattr(stats, f))
                                       for f in STATS]


# ------------------------------------------- the port's own generators
@pytest.mark.parametrize("nodes", (1, 4))
@pytest.mark.parametrize("backend,impl,cf", CASES)
def test_runner_equals_streaming_engine_and_one_shot(nodes, backend, impl,
                                                     cf):
    num_chunks = 2 * nodes
    seed = make_seed_streaming(5, TCFG, num_chunks, CHUNK, device="cpu")
    plan = _plan(impl, cf)
    runner = OverlapStreamingRunner(
        seed, TCFG, nodes=nodes, num_chunks=num_chunks, chunk_records=CHUNK,
        backend=backend, plan=plan, device="cpu")
    s_pad = runner.s_pad
    want_hist, want_stats = streaming_histogram_generate(
        seed, TCFG, s_pad, parts=nodes, chunks_per_node=runner.cpd,
        chunk_records=CHUNK, backend=backend, plan=plan)
    oneshot = generate_chunked_log(seed, TCFG, num_chunks, CHUNK)
    for ov in (True, False):
        hist, stats = runner.run(overlap=ov)
        assert torch.equal(hist, want_hist), f"{backend} overlap={ov}"
        assert _stats_list(stats) == _stats_list(want_stats)
        for stat in STATISTICS:
            want, ws = malstone_run_streaming(
                seed, KW["num_sites"], nodes=nodes, cfg=TCFG,
                num_chunks=num_chunks, chunk_records=CHUNK, backend=backend,
                statistic=stat, plan=plan, device="cpu",
                return_shuffle_stats=True)
            got, gs = runner.run_result(stat, overlap=ov)
            _same(got, want, f"{backend} {stat} P={nodes} overlap={ov}")
            assert _stats_list(gs) == _stats_list(ws)
            via, vs = malstone_run_streaming(
                seed, KW["num_sites"], nodes=nodes, cfg=TCFG,
                num_chunks=num_chunks, chunk_records=CHUNK, backend=backend,
                statistic=stat, plan=plan, device="cpu",
                return_shuffle_stats=True, overlap=ov)
            _same(via, want, f"{backend} {stat} through overlap={ov}")
            assert _stats_list(vs) == _stats_list(ws)
            one = malstone_run(oneshot, KW["num_sites"], nodes=nodes,
                               statistic=stat, backend=backend, plan=plan,
                               device="cpu")
            _same(got, one, f"{backend} {stat} vs one-shot")
    if backend == "mapreduce":
        assert stats.rounds > 1, "want a chunk that needs several rounds"
        assert int(stats.sent) == num_chunks * CHUNK


# ----------------------------------------------------- against JAX
@pytest.fixture(scope="module")
def jax_chunks():
    """JAX's streaming seed, the port's seed of the same tables, and every
    chunk JAX's generator makes, as the port's EventLogs."""
    jseed = _jax_seed()
    seed = seed_from_numpy(_seed_arrays(jseed), TCFG, KEY, device="cpu")
    chunks = {}
    for c in range(NUM_CHUNKS):
        marked, _, unmarked = _jax_chunk_draws(jseed, c, CHUNK)
        chunks[c] = generate_chunk(seed, TCFG, c, CHUNK, marked=marked,
                                   unmarked=unmarked)
    return seed, chunks


@pytest.fixture(scope="module")
def jax_p1():
    return _jax_runner_results(jax.make_mesh((1,), ("data",)))


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_overlap_p4")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE.parent),
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_overlap.py"),
         str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


def _check_against_jax(monkeypatch, jax_chunks, want, nodes, backend,
                       impl, cf):
    seed, chunks = jax_chunks
    made = []

    def jax_generate_chunks(seed, cfg, chunk_ids, records):
        made.extend(chunk_ids)
        return EventLog(*[None if cols[0] is None else torch.stack(cols)
                          for cols in zip(*[chunks[c] for c in chunk_ids])])

    monkeypatch.setattr(overlap, "generate_chunks", jax_generate_chunks)
    runner = OverlapStreamingRunner(
        seed, TCFG, nodes=nodes, num_chunks=NUM_CHUNKS, chunk_records=CHUNK,
        backend=backend, plan=_plan(impl, cf), device="cpu")
    for ov in (True, False):
        tag = f"{backend}/{ov}"
        made.clear()
        hist, stats = runner.run(overlap=ov)
        assert sorted(made) == list(range(NUM_CHUNKS))
        np.testing.assert_array_equal(hist.numpy(), want[f"{tag}/hist"],
                                      err_msg=f"{tag} P={nodes}")
        res, stats_b = runner.run_result("B", overlap=ov)
        np.testing.assert_array_equal(
            res.rho.numpy().view(np.int32),
            want[f"{tag}/rho"].view(np.int32),
            err_msg=f"rho bits {tag} P={nodes}")
        if backend == "mapreduce":
            for s in (stats, stats_b):
                for f in STATS:
                    assert int(getattr(s, f)) == int(
                        want[f"{tag}/stats/{f}"]), f"{tag} P={nodes}: {f}"
        else:
            assert stats is None and f"{tag}/stats/sent" not in want


@pytest.mark.parametrize("backend,impl,cf", CASES)
def test_runner_matches_jax_runner_p1(monkeypatch, jax_chunks, jax_p1,
                                      backend, impl, cf):
    _check_against_jax(monkeypatch, jax_chunks, jax_p1, 1, backend, impl,
                       cf)


@pytest.mark.parametrize("backend,impl,cf", CASES)
def test_runner_matches_jax_runner_p4(monkeypatch, jax_chunks, jax_p4,
                                      backend, impl, cf):
    _check_against_jax(monkeypatch, jax_chunks, jax_p4, P4, backend, impl,
                       cf)
    if backend == "mapreduce":
        assert int(jax_p4["mapreduce/True/stats/rounds"]) > 1


# ------------------------------------------------------- the schedule
class _Stream:
    def __init__(self, name, trace):
        self.name, self.trace = name, trace

    def wait_stream(self, other):
        self.trace.append(f"{self.name} waits {other.name}")

    def wait_event(self, event):
        self.trace.append(f"{self.name} waits {event.name}")

    def synchronize(self):
        self.trace.append(f"sync {self.name}")


class _Col:
    def __init__(self, chunk, trace):
        self.chunk, self.trace = chunk, trace

    def record_stream(self, stream):
        self.trace.append(f"chunk {self.chunk} used on {stream.name}")


def _fake_streams(monkeypatch, runner):
    """Fakes of the CUDA stream calls the runner makes, each appending to
    one trace; chunks and folds are recorded with the stream current at
    the call."""
    trace = []
    main, current = _Stream("main", trace), []

    class _StreamContext:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            current.append(self.stream)

        def __exit__(self, *exc):
            current.pop()

    class _Event:
        def record(self, stream):
            self.name = f"event after {trace[-1]}"

    def chunk(k):
        trace.append(f"gen {k} on {(current or [main])[-1].name}")
        return (_Col(k, trace), None)

    def fold(state, chunk):
        where = (current or [main])[-1].name
        trace.append(f"fold {chunk[0].chunk} on {where}")
        return state + 1

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: main)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device: _Stream("gen", trace))
    monkeypatch.setattr(torch.cuda, "stream", _StreamContext)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(runner, "_chunk", chunk)
    monkeypatch.setattr(runner, "_fold", fold)
    return trace


def test_two_stream_schedule_overlap_on(monkeypatch):
    """Overlap on: chunk k+1's generation is enqueued on the generation
    stream before fold k, the fold waits for its chunk's event on the
    caller's stream, and chunk k+2 waits until fold k has finished (two
    chunks in flight at most)."""
    seed = make_seed_streaming(1, TCFG, 3, 64, device="cpu")
    runner = OverlapStreamingRunner(seed, TCFG, nodes=1, num_chunks=3,
                                    chunk_records=64, device="cpu")
    trace = _fake_streams(monkeypatch, runner)
    assert runner._run_on_streams(0, overlap=True) == 3
    assert trace == [
        "gen waits main",
        "gen 0 on gen", "chunk 0 used on main",
        "gen 1 on gen", "chunk 1 used on main",
        "main waits event after gen 0 on gen", "fold 0 on main",
        "sync main",
        "gen 2 on gen", "chunk 2 used on main",
        "main waits event after gen 1 on gen", "fold 1 on main",
        "sync main",
        "main waits event after gen 2 on gen", "fold 2 on main",
        "sync main"]


def test_two_stream_schedule_overlap_off(monkeypatch):
    """Overlap off: the same calls on the same streams, each generation
    and each fold synchronised before the next call."""
    seed = make_seed_streaming(1, TCFG, 2, 64, device="cpu")
    runner = OverlapStreamingRunner(seed, TCFG, nodes=1, num_chunks=2,
                                    chunk_records=64, device="cpu")
    trace = _fake_streams(monkeypatch, runner)
    assert runner._run_on_streams(0, overlap=False) == 2
    assert trace == [
        "gen waits main",
        "gen 0 on gen", "chunk 0 used on main", "sync gen",
        "main waits event after gen 0 on gen", "fold 0 on main",
        "sync main",
        "gen 1 on gen", "chunk 1 used on main", "sync gen",
        "main waits event after gen 1 on gen", "fold 1 on main",
        "sync main"]


@pytest.mark.parametrize("ov", (True, False))
def test_cpu_runs_the_serial_order_without_streams(monkeypatch, ov):
    """On the CPU both values of overlap generate and fold in turn and
    touch no CUDA stream."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("a CPU run touched a CUDA stream")

    for name in ("Stream", "stream", "Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    seed = make_seed_streaming(2, TCFG, 4, 64, device="cpu")
    runner = OverlapStreamingRunner(seed, TCFG, nodes=2, num_chunks=4,
                                    chunk_records=64, backend="mapreduce",
                                    device="cpu")
    calls = []
    chunk, fold = runner._chunk, runner._fold
    monkeypatch.setattr(runner, "_chunk",
                        lambda k: calls.append(f"gen {k}") or chunk(k))
    monkeypatch.setattr(runner, "_fold", lambda s, c: calls.append("fold")
                        or fold(s, c))
    _, stats = runner.run_result("B", overlap=ov)
    assert calls == ["gen 0", "fold", "gen 1", "fold"]
    assert int(stats.sent) == 4 * 64


# ------------------------------------------------------- contracts
def test_overlap_contracts():
    seed = make_seed_streaming(1, TCFG, 4, 64, device="cpu")
    log = generate_chunked_log(seed, TCFG, 4, 64)
    with pytest.raises(ValueError, match="seed-mode streaming"):
        malstone_run_streaming(log, 301, nodes=2, chunk_records=64,
                               overlap=True, device="cpu")
    with pytest.raises(ValueError, match="seed-mode streaming"):
        malstone_run_streaming(log, 301, nodes=2, chunk_records=64,
                               overlap=False, device="cpu")
    with pytest.raises(ValueError, match="must divide over"):
        OverlapStreamingRunner(seed, TCFG, nodes=3, num_chunks=4,
                               chunk_records=64, device="cpu")
    with pytest.raises(ValueError, match="must divide over"):
        malstone_run_streaming(seed, 301, nodes=3, cfg=TCFG, num_chunks=4,
                               chunk_records=64, overlap=True, device="cpu")
    with pytest.raises(ValueError, match="unknown streaming backend"):
        OverlapStreamingRunner(seed, TCFG, nodes=2, num_chunks=4,
                               chunk_records=64, backend="hadoop",
                               device="cpu")
    # overlap=None on a log is the streaming engine, as before
    got = malstone_run_streaming(log, 301, nodes=2, chunk_records=64,
                                 device="cpu")
    _same(got, malstone_run(log, 301, nodes=2, device="cpu"), "log mode")


def test_runner_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seed = make_seed_streaming(1, TCFG, 4, 64, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OverlapStreamingRunner(seed, TCFG, nodes=2, num_chunks=4,
                               chunk_records=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        malstone_run_streaming(seed, 301, nodes=2, cfg=TCFG, num_chunks=4,
                               chunk_records=64, overlap=True)
