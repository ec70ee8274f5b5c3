"""The port's resumable runs (``core/resume.py``) against the JAX package's,
exactly: segmented, killed and resumed, under fault schedules, and across
packages through the checkpoint store.

Equality is exact: integer histograms, the bits of ``rho``, every
``ShuffleStats`` field. The port's chunk source is patched with JAX's
chunks, made from JAX's draws through
``test_torch_streaming._jax_chunk_draws``, so both packages fold the same
records; the tests of a real process exit use the port's own generators
and hold the resumed run against the port's streaming engine.

- P = 1 runs in this process against a 1-device JAX mesh.
- P = 4 needs 4 JAX host devices, so the JAX side runs once per module in
  a subprocess: this file run as a script (``python
  tests/test_torch_resume.py OUT_DIR``) forces 4 devices, computes the
  streaming references, writes JAX checkpoints and replays the fault
  schedules of ``FAULT_CASES``.

A process exit (``kill_mode="exit"``) only ever happens in a child
process, under a timeout.
"""

import json
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
from repro.core import malstone_run_streaming as jax_run_streaming
from repro.core.resume import RecoveryReport as JaxReport
from repro.core.resume import ResumableRunner as JaxRunner
from repro.faults import FaultPlan as JaxFaultPlan
from repro.faults import RetryPolicy as JaxRetry
from repro.faults import SimulatedKill as JaxKill
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import make_seed_streaming as jax_seed_streaming

HERE = pathlib.Path(__file__).resolve().parent
KW = dict(num_sites=301, num_entities=1000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
JCFG = JaxConfig(**KW)
KEY, NUM_CHUNKS, CHUNK = 7, 8, 512
P4 = 4
BACKENDS = ("streams", "sphere", "mapreduce", "mapreduce_combiner")
STATS = ("sent", "overflow", "capacity", "rounds", "residual",
         "bytes_exchanged")
REPORT_FIELDS = ("segments_total", "segments_run", "segments_retried",
                 "resumed_from_step", "chunks_processed", "chunks_skipped",
                 "fault_events", "alarmed_hosts", "rerouted_shards")
# fault schedules replayed by both packages at P = 4 (streams, one chunk a
# segment, 4 hosts): (name, FaultPlan fields, retry attempts)
FAULT_CASES = (
    ("transient", dict(seed=11, transient_rate=0.25), 6),
    ("badhost", dict(bad_hosts=(0,)), 6),
    ("badhost_flaky", dict(seed=3, transient_rate=0.2, bad_hosts=(2,)), 4),
    ("all_bad", dict(bad_hosts=(0, 1, 2, 3)), 6),
    ("exhausted", dict(transient_rate=1.0), 2),
    ("sweep_41", dict(seed=41, transient_rate=0.35), 6),
    ("sweep_97", dict(seed=97, transient_rate=0.4, bad_hosts=(3,)), 4),
)


def _jax_plan(backend):
    """mapreduce counts at capacity factor 0.5, so a chunk takes several
    shuffle rounds; every backend reduces with segment_sum."""
    if backend == "mapreduce":
        return JaxPlan(impl="counting", capacity_factor=0.5)
    return JaxPlan()


def _jax_seed():
    return jax_seed_streaming(jax.random.key(KEY), JCFG, NUM_CHUNKS, CHUNK)


def _jax_reference(seed, mesh, backend):
    """JAX's uninterrupted streaming engine: rho, totals, marks and the
    global ShuffleStats, as numpy."""
    res, stats = jax_run_streaming(
        seed, KW["num_sites"], mesh=mesh, backend=backend,
        chunk_records=CHUNK, statistic="B", cfg=JCFG, num_chunks=NUM_CHUNKS,
        plan=_jax_plan(backend), return_shuffle_stats=True)
    out = {f: np.asarray(getattr(res, f)) for f in ("rho", "total",
                                                    "marked")}
    if stats is not None:
        out.update({f"stats/{f}": np.asarray(int(getattr(stats, f)))
                    for f in STATS})
    return out


def _jax_runner(seed, mesh, backend, segment_chunks):
    return JaxRunner(seed, JCFG, mesh=mesh, num_chunks=NUM_CHUNKS,
                     chunk_records=CHUNK, segment_chunks=segment_chunks,
                     backend=backend, statistic="B",
                     plan=_jax_plan(backend))


def _jax_killed_checkpoint(runner, path, kill_at):
    """Run JAX's runner into ``path`` until a raised kill at segment
    ``kill_at``."""
    try:
        runner.run(checkpoint_dir=str(path),
                   faults=JaxFaultPlan(kill_at_segment=kill_at,
                                       kill_mode="raise"))
    except JaxKill:
        return
    raise RuntimeError("the kill did not fire")


def _report_dict(report):
    d = report.to_derived()
    return {k: d[k] for k in REPORT_FIELDS}


def _jax_fault_outcomes(runner):
    out = {}
    for name, fields, attempts in FAULT_CASES:
        try:
            rep = runner.run(
                faults=JaxFaultPlan(kill_mode="raise", **fields),
                retry=JaxRetry(max_attempts=attempts, backoff_s=0.0),
                num_hosts=4).report
            out[name] = {"ok": _report_dict(rep)}
        except Exception as e:  # the class is compared, not the message
            out[name] = {"error": type(e).__name__}
    return out


def _oracle_main(out_dir):
    """The P = 4 JAX side: references, checkpoints killed at segment 1 of
    two, the fault schedules' outcomes."""
    assert jax.device_count() == P4, jax.devices()
    out_dir = pathlib.Path(out_dir)
    mesh = jax.make_mesh((P4,), ("data",))
    seed = _jax_seed()
    arrays = {}
    for backend in BACKENDS:
        arrays.update({f"{backend}/{k}": v for k, v in
                       _jax_reference(seed, mesh, backend).items()})
    meta = {"fingerprint": {}}
    for backend in ("streams", "mapreduce"):
        runner = _jax_runner(seed, mesh, backend, 1)
        _jax_killed_checkpoint(runner, out_dir / f"ckpt_{backend}", 1)
        meta["fingerprint"][backend] = int(runner._fingerprint)
        if backend == "streams":
            meta["faults"] = _jax_fault_outcomes(runner)
    np.savez(out_dir / "ref.npz", **arrays)
    (out_dir / "meta.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    _oracle_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

import repro_torch.malgen.generator as generator  # noqa: E402
from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ResumableRunner,
    ResumeOutcome,
    malstone_run_streaming,
    run,
)
from repro_torch.core.resume import RecoveryReport  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    FaultPlan,
    NoHealthyHostsError,
    RetryPolicy,
    SegmentRetriesExhausted,
    SimulatedKill,
)
from repro_torch.launch import malstone as launcher  # noqa: E402
from repro_torch.malgen import (  # noqa: E402
    MalGenConfig,
    generate_chunk,
    make_seed_streaming,
    seed_from_numpy,
)
from test_torch_streaming import (  # noqa: E402
    _jax_chunk_draws,
    _seed_arrays,
)

TCFG = MalGenConfig(**KW)
ROOT = HERE.parent


def _plan(backend, histogram_impl="kernel"):
    """The port's plan of ``_jax_plan(backend)``; ``"kernel"`` is JAX's
    ``"pallas"`` (on the CPU, the kernels' plain versions)."""
    if backend == "mapreduce":
        return ExchangePlan(impl="counting", capacity_factor=0.5,
                            histogram_impl=histogram_impl)
    return ExchangePlan(histogram_impl=histogram_impl)


def _runner(seed, backend, segment_chunks, nodes=1, **kw):
    kw.setdefault("plan", _plan(backend))
    return ResumableRunner(seed, TCFG, nodes=nodes, num_chunks=NUM_CHUNKS,
                           chunk_records=CHUNK,
                           segment_chunks=segment_chunks, backend=backend,
                           statistic="B", device="cpu", **kw)


def _assert_matches(out, want, msg):
    """``out`` a ResumeOutcome; ``want`` JAX's numpy reference."""
    res = out.result
    np.testing.assert_array_equal(res.total.numpy(), want["total"],
                                  err_msg=f"total {msg}")
    np.testing.assert_array_equal(res.marked.numpy(), want["marked"],
                                  err_msg=f"marked {msg}")
    np.testing.assert_array_equal(res.rho.numpy().view(np.int32),
                                  want["rho"].view(np.int32),
                                  err_msg=f"rho bits {msg}")
    if "stats/sent" in want:
        for f in STATS:
            assert int(getattr(out.shuffle_stats, f)) == int(
                want[f"stats/{f}"]), f"{msg}: ShuffleStats.{f}"
    else:
        assert out.shuffle_stats is None, msg


def _assert_same(a, b, msg):
    """Two port outcomes (or an outcome and a streaming (result, stats))."""
    ra, sa = (a.result, a.shuffle_stats) if isinstance(a, ResumeOutcome) \
        else a
    rb, sb = (b.result, b.shuffle_stats) if isinstance(b, ResumeOutcome) \
        else b
    for f in ("total", "marked"):
        assert torch.equal(getattr(ra, f), getattr(rb, f)), f"{f} {msg}"
    assert torch.equal(ra.rho.view(torch.int32), rb.rho.view(torch.int32)), \
        f"rho bits {msg}"
    if sb is None:
        assert sa is None, msg
    else:
        assert [int(x) for x in sa] == [int(x) for x in sb], msg


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def jax_seed():
    return _jax_seed()


@pytest.fixture(scope="module")
def port_seed(jax_seed):
    """The port's seed of JAX's tables, with JAX's rng seed and marked
    event count (so the fingerprints agree)."""
    return seed_from_numpy(_seed_arrays(jax_seed), TCFG, KEY, device="cpu")


@pytest.fixture(scope="module")
def jax_chunks(jax_seed, port_seed):
    """Every chunk JAX's generator makes, as the port's EventLogs."""
    chunks = {}
    for c in range(NUM_CHUNKS):
        marked, _, unmarked = _jax_chunk_draws(jax_seed, c, CHUNK)
        chunks[c] = generate_chunk(port_seed, TCFG, c, CHUNK, marked=marked,
                                   unmarked=unmarked)
    return chunks


@pytest.fixture
def jax_records(monkeypatch, jax_chunks):
    """Patch the port's chunk source with JAX's chunks; the list records
    every chunk id generated."""
    made = []

    def jax_generate_chunks(seed, cfg, chunk_ids, records):
        made.extend(chunk_ids)
        return EventLog(*[None if cols[0] is None else torch.stack(cols)
                          for cols in zip(*[jax_chunks[c]
                                            for c in chunk_ids])])

    monkeypatch.setattr(generator, "generate_chunks", jax_generate_chunks)
    return made


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module")
def jax_p1(jax_seed, mesh1):
    return {b: _jax_reference(jax_seed, mesh1, b) for b in BACKENDS}


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_resume_p4")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_resume.py"), str(tmp)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as f:
        ref = dict(f)
    want = {b: {k.split("/", 1)[1]: v for k, v in ref.items()
                if k.startswith(b + "/")} for b in BACKENDS}
    return want, json.loads((tmp / "meta.json").read_text()), tmp


# ------------------------------------------------------- bit identity
@pytest.mark.parametrize("segment_chunks", (1, 3, 8))
@pytest.mark.parametrize("backend", BACKENDS)
def test_segmented_run_matches_jax_p1(jax_records, port_seed, jax_p1,
                                      backend, segment_chunks):
    """K = 3 over 8 chunks a node is the uneven 3 + 3 + 2."""
    out = run(port_seed, engine="resumable", nodes=1, cfg=TCFG,
              num_chunks=NUM_CHUNKS, chunk_records=CHUNK,
              segment_chunks=segment_chunks, backend=backend,
              plan=_plan(backend), device="cpu")
    assert isinstance(out, ResumeOutcome)
    _assert_matches(out, jax_p1[backend], f"{backend} K={segment_chunks}")
    rep = out.report
    assert rep.segments_run == rep.segments_total == -(-8 // segment_chunks)
    assert rep.chunks_processed == NUM_CHUNKS
    assert rep.chunks_skipped == 0 and rep.resumed_from_step is None
    assert sorted(jax_records) == list(range(NUM_CHUNKS))
    if backend == "mapreduce":
        assert int(out.shuffle_stats.rounds) > 1


@pytest.mark.parametrize("segment_chunks", (1, 2))
@pytest.mark.parametrize("backend", BACKENDS)
def test_segmented_run_matches_jax_p4(jax_records, port_seed, jax_p4,
                                      backend, segment_chunks):
    want, _, _ = jax_p4
    out = _runner(port_seed, backend, segment_chunks, nodes=P4).run()
    _assert_matches(out, want[backend], f"{backend} K={segment_chunks} P=4")
    assert out.report.segments_run == 2 // segment_chunks


# ------------------------------------------------- kills and resumption
@pytest.mark.parametrize("backend", ("streams", "mapreduce"))
def test_checkpointed_then_fully_resumed(jax_records, port_seed, jax_p1,
                                         backend, tmp_path):
    runner = _runner(port_seed, backend, 2)
    first = runner.run(checkpoint_dir=str(tmp_path))
    _assert_matches(first, jax_p1[backend], f"{backend} checkpointed")
    jax_records.clear()
    again = runner.run(checkpoint_dir=str(tmp_path))
    _assert_matches(again, jax_p1[backend], f"{backend} resumed")
    assert jax_records == [], "a complete checkpoint regenerates nothing"
    rep = again.report
    assert rep.segments_run == 0 and rep.chunks_processed == 0
    assert rep.chunks_skipped == NUM_CHUNKS
    assert rep.resumed_from_step == first.report.segments_total == 4


@pytest.mark.parametrize("kill", ("boundary", "mid_checkpoint"))
@pytest.mark.parametrize("backend", ("streams", "mapreduce"))
def test_raised_kill_then_resume(jax_records, port_seed, jax_p1, backend,
                                 kill, tmp_path):
    runner = _runner(port_seed, backend, 2)
    fields = ({"kill_at_segment": 2} if kill == "boundary"
              else {"kill_mid_checkpoint_step": 2})
    with pytest.raises(SimulatedKill):
        runner.run(checkpoint_dir=str(tmp_path),
                   faults=FaultPlan(kill_mode="raise", **fields))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert "step_00000001.COMMITTED" in names
    if kill == "boundary":
        assert "step_00000002.COMMITTED" in names
        resumed_from = 2
    else:
        # the window between the shard files and the commit marker
        assert any(n.startswith(".tmp_step_2_") for n in names), names
        assert "step_00000002.COMMITTED" not in names
        resumed_from = 1
    jax_records.clear()
    out = runner.run(checkpoint_dir=str(tmp_path))
    _assert_matches(out, jax_p1[backend], f"{backend} kill {kill}")
    rep = out.report
    assert rep.resumed_from_step == resumed_from
    assert rep.chunks_skipped == 2 * resumed_from
    assert rep.chunks_processed == NUM_CHUNKS - 2 * resumed_from
    assert sorted(jax_records) == list(range(2 * resumed_from, NUM_CHUNKS))
    left = sorted(p.name for p in tmp_path.iterdir())
    assert not any(n.startswith(".tmp_") for n in left), left


LAUNCH = ["--device", "cpu", "--nodes", "2", "--records-per-node", "2048",
          "--sites", "301", "--entities", "1000", "--stream-chunks", "4",
          "--segment-chunks", "1"]


def _launcher_runner(backend):
    """The runner the launcher builds for ``LAUNCH`` + ``--backend``."""
    cfg = MalGenConfig(num_sites=301, num_entities=1000)
    seed = make_seed_streaming(0, cfg, 8, 512, device="cpu")
    plan = ExchangePlan()
    runner = ResumableRunner(seed, cfg, nodes=2, num_chunks=8,
                             chunk_records=512, segment_chunks=1,
                             backend=backend, plan=plan, device="cpu")
    want = malstone_run_streaming(
        seed, 301, nodes=2, cfg=cfg, num_chunks=8, chunk_records=512,
        backend=backend, plan=plan, device="cpu", return_shuffle_stats=True)
    return runner, want


def _launch(args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.malstone", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


@pytest.mark.parametrize("backend,kill", (("mapreduce", "boundary"),
                                         ("streams", "mid_checkpoint")))
def test_process_exit_then_resume(backend, kill, tmp_path):
    """A real ``os._exit(17)`` in a child launcher, then ``--resume`` in a
    second child, then an in-process resume from a copy of the killed
    run's directory: each resumed run equals the streaming engine."""
    import shutil

    ckpt = tmp_path / "ckpt"
    spec = ("kill_at_segment=2" if kill == "boundary"
            else "kill_mid_checkpoint_step=2")
    base = LAUNCH + ["--backend", backend, "--checkpoint-dir", str(ckpt)]
    proc = _launch(base + ["--inject-faults", spec])
    assert proc.returncode == 17, proc.stderr[-4000:]
    names = sorted(p.name for p in ckpt.iterdir())
    if kill == "mid_checkpoint":
        assert any(n.startswith(".tmp_step_2_") for n in names), names
        assert "step_00000002.COMMITTED" not in names
    else:
        assert "step_00000002.COMMITTED" in names
    copy = tmp_path / "copy"
    shutil.copytree(ckpt, copy)
    bench = tmp_path / "BENCH_resume.json"
    proc = _launch(base + ["--resume", "--bench-json", str(bench)])
    assert proc.returncode == 0, proc.stderr[-4000:]
    resumed_from = 2 if kill == "boundary" else 1
    assert f"resumed from checkpoint step {resumed_from}" in proc.stdout
    doc = json.loads(bench.read_text())
    assert doc["results"][0]["derived"]["resumed_from_step"] == resumed_from
    runner, want = _launcher_runner(backend)
    out = runner.run(checkpoint_dir=str(copy))
    assert out.report.resumed_from_step == resumed_from
    _assert_same(out, want, f"{backend} exit at {kill}")


def test_resume_refuses_other_runs_checkpoint(port_seed, tmp_path):
    _runner(port_seed, "streams", 2).run(checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="different run configuration"):
        _runner(port_seed, "sphere", 2).run(checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="different run configuration"):
        _runner(port_seed, "streams", 2,
                plan=_plan("streams", "segment_sum")).run(
            checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="segment boundaries"):
        _runner(port_seed, "streams", 3).run(checkpoint_dir=str(tmp_path))


def test_resume_false_recomputes(port_seed, tmp_path):
    runner = _runner(port_seed, "streams", 2)
    first = runner.run(checkpoint_dir=str(tmp_path))
    out = runner.run(checkpoint_dir=str(tmp_path), resume=False)
    assert out.report.resumed_from_step is None
    assert out.report.chunks_processed == NUM_CHUNKS
    _assert_same(out, first, "resume=False")


# ------------------------------------------------- across the packages
@pytest.fixture(scope="module")
def jax_runners(jax_seed, mesh1):
    """JAX's runners at K = 2 (their compiled segments cached)."""
    return {b: _jax_runner(jax_seed, mesh1, b, 2)
            for b in ("streams", "mapreduce")}


def _jax_outcome_matches(out, want, msg):
    for f in ("total", "marked", "rho"):
        np.testing.assert_array_equal(np.asarray(getattr(out.result, f)),
                                      want[f], err_msg=f"{f} {msg}")
    if "stats/sent" in want:
        for f in STATS:
            assert int(getattr(out.shuffle_stats, f)) == int(
                want[f"stats/{f}"]), f"{msg}: ShuffleStats.{f}"


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
@pytest.mark.parametrize("backend", ("streams", "mapreduce"))
def test_checkpoints_cross_the_packages(jax_records, port_seed, jax_p1,
                                        jax_runners, backend, direction,
                                        tmp_path):
    """A checkpoint JAX wrote resumes in the port to JAX's uninterrupted
    result, and the reverse; the fingerprints are equal."""
    jrunner = jax_runners[backend]
    runner = _runner(port_seed, backend, 2,
                     plan=_plan(backend, "segment_sum"))
    assert int(runner._fingerprint) == int(jrunner._fingerprint)
    if direction == "jax_to_port":
        _jax_killed_checkpoint(jrunner, tmp_path, 2)
        jax_records.clear()
        out = runner.run(checkpoint_dir=str(tmp_path))
        _assert_matches(out, jax_p1[backend], f"{backend} {direction}")
        assert sorted(jax_records) == list(range(4, NUM_CHUNKS))
    else:
        with pytest.raises(SimulatedKill):
            runner.run(checkpoint_dir=str(tmp_path),
                       faults=FaultPlan(kill_at_segment=2,
                                        kill_mode="raise"))
        out = jrunner.run(checkpoint_dir=str(tmp_path))
        _jax_outcome_matches(out, jax_p1[backend], f"{backend} {direction}")
    assert out.report.resumed_from_step == 2
    assert out.report.chunks_skipped == 4


def test_fingerprints_follow_the_reducer(port_seed, jax_seed, mesh1,
                                         jax_runners, tmp_path):
    """The port's "kernel" is JAX's "pallas": the fingerprints agree pair
    by pair and differ across, and a checkpoint of the other reducer is
    refused."""
    jax_pallas = JaxRunner(jax_seed, JCFG, mesh=mesh1, num_chunks=NUM_CHUNKS,
                           chunk_records=CHUNK, segment_chunks=2,
                           backend="streams",
                           plan=JaxPlan(histogram_impl="pallas"))
    kernel = _runner(port_seed, "streams", 2)
    segsum = _runner(port_seed, "streams", 2,
                     plan=_plan("streams", "segment_sum"))
    jax_segsum = jax_runners["streams"]
    assert int(kernel._fingerprint) == int(jax_pallas._fingerprint)
    assert int(segsum._fingerprint) == int(jax_segsum._fingerprint)
    assert int(kernel._fingerprint) != int(segsum._fingerprint)
    _jax_killed_checkpoint(jax_segsum, tmp_path, 1)
    with pytest.raises(ValueError, match="different run configuration"):
        kernel.run(checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize("backend", ("streams", "mapreduce"))
def test_jax_checkpoint_at_p4_resumes_in_the_port(jax_records, port_seed,
                                                  jax_p4, backend):
    """JAX at P = 4 killed at the boundary of segment 1 of 2."""
    import shutil
    import tempfile

    want, meta, tmp = jax_p4
    runner = _runner(port_seed, backend, 1, nodes=P4,
                     plan=_plan(backend, "segment_sum"))
    assert int(runner._fingerprint) == meta["fingerprint"][backend]
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(tmp / f"ckpt_{backend}", pathlib.Path(d) / "c")
        jax_records.clear()
        out = runner.run(checkpoint_dir=str(pathlib.Path(d) / "c"))
    _assert_matches(out, want[backend], f"{backend} P=4 from JAX")
    assert out.report.resumed_from_step == 1
    assert sorted(jax_records) == [1, 3, 5, 7]


# ------------------------------------------------------------ faults
@pytest.mark.parametrize("case", [c[0] for c in FAULT_CASES])
def test_fault_schedules_match_jax_p4(jax_records, port_seed, jax_p4, case):
    """Each schedule completes bit-identically with JAX's recovery report,
    or raises the error JAX raises."""
    want, meta, _ = jax_p4
    _, fields, attempts = next(c for c in FAULT_CASES if c[0] == case)
    runner = _runner(port_seed, "streams", 1, nodes=P4,
                     plan=_plan("streams", "segment_sum"))
    expect = meta["faults"][case]
    try:
        out = runner.run(faults=FaultPlan(kill_mode="raise", **fields),
                         retry=RetryPolicy(max_attempts=attempts,
                                           backoff_s=0.0),
                         num_hosts=4)
    except (SegmentRetriesExhausted, NoHealthyHostsError) as e:
        assert expect == {"error": type(e).__name__}, case
        return
    assert expect == {"ok": _report_dict(out.report)}, case
    _assert_matches(out, want["streams"], case)


# ------------------------------------------------------- contracts
def test_runner_and_api_contracts(port_seed):
    from repro_torch.malgen import generate_chunked_log

    with pytest.raises(ValueError, match="unknown streaming backend"):
        _runner(port_seed, "hadoop", 1)
    for k in (0, NUM_CHUNKS + 1):
        with pytest.raises(ValueError, match="segment_chunks"):
            _runner(port_seed, "streams", k)
        with pytest.raises(ValueError, match="segment_chunks"):
            run(port_seed, engine="resumable", nodes=1, cfg=TCFG,
                num_chunks=NUM_CHUNKS, chunk_records=CHUNK,
                segment_chunks=k, device="cpu")
    with pytest.raises(ValueError, match="must divide over the mesh"):
        _runner(port_seed, "streams", 1, nodes=3)
    log = generate_chunked_log(port_seed, TCFG, 2, 64)
    with pytest.raises(ValueError, match="SeedInfo"):
        run(log, 301, nodes=1, engine="resumable", device="cpu")


def test_recovery_report_has_jax_derived_keys(port_seed):
    out = _runner(port_seed, "streams", 4).run()
    d = out.report.to_derived()
    assert list(d) == list(JaxReport().to_derived())
    assert list(RecoveryReport().to_derived().values()) == list(
        JaxReport().to_derived().values())
    assert d["resumed_from_step"] == -1     # json-friendly sentinel


@pytest.mark.parametrize("flags, msg", [
    (["--checkpoint-dir", "x"], "need --stream-chunks"),
    (["--inject-faults", "seed=1", "--stream-chunks", "2", "--gen-device"],
     "incompatible"),
    (["--checkpoint-dir", "x", "--stream-chunks", "2", "--check"],
     "--check"),
    (["--checkpoint-dir", "x", "--stream-chunks", "2", "--overlap", "on"],
     "--overlap"),
    (["--checkpoint-dir", "x", "--stream-chunks", "2", "--overlap", "off"],
     "--overlap"),
])
def test_launcher_refuses(flags, msg, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(["--device", "cpu", "--records-per-node", "256",
                       *flags])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_launcher_writes_the_resume_document(tmp_path, capsys):
    from repro.bench import schema as jax_schema

    bench = tmp_path / "BENCH_r.json"
    launcher.main(LAUNCH + ["--backend", "mapreduce",
                            "--inject-faults", "seed=11,transient_rate=0.25,"
                            "kill_mode=raise", "--retry-attempts", "6",
                            "--bench-json", str(bench)])
    text = capsys.readouterr().out
    assert "resumable x4/seg1" in text and "recovery:" in text
    doc = json.loads(bench.read_text())
    jax_schema.validate_document(doc)
    (row,) = doc["results"]
    assert row["scenario"] == "launch_malstone_b_mapreduce_resume"
    assert set(row["params"]) >= {
        "backend", "statistic", "engine", "nodes", "records_per_node",
        "sites", "entities", "stream_chunks", "segment_chunks", "resume",
        "inject_faults", "capacity_factor", "exchange_impl"}
    assert row["params"]["engine"] == "resumable"
    derived = row["derived"]
    assert set(JaxReport().to_derived()) | {
        "segment_chunks", "capacity_factor", "shuffle_rounds",
        "shuffle_sent", "shuffle_overflow",
        "shuffle_bytes_exchanged"} == set(derived)
    assert derived["segments_run"] == 4 and derived["fault_events"] > 0
