"""The port's fault layer (``faults/``) against the JAX package's
(``tests/test_faults.py`` mirrored): the plan and its parser, the
injector's coin, kill points and audit trail, the retry policy, the
telemetry buffer's alarms, and resumable runs under fault schedules.

The plan, injector and retry policy are copies of JAX's pure-Python
modules, so their outputs are compared one for one. The telemetry buffer
diagnoses through the port's NodeDoctor; its alarms equal JAX's. Runs
under faults use the port's own generators and are held against the
port's uninterrupted run (the P = 4 schedules against JAX's recovery
reports are in ``tests/test_torch_resume.py``). A process exit only ever
happens in a child process, under a timeout.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (repro.faults imports it first otherwise)
from repro.faults import FaultInjector as JaxInjector
from repro.faults import FaultPlan as JaxPlan
from repro.faults import RetryPolicy as JaxRetry
from repro.faults import SimulatedKill as JaxKill
from repro.faults import TelemetryBuffer as JaxBuffer
from repro.faults import TransientWorkerError as JaxTransient
from repro_torch.core import nodedoctor
from repro_torch.core.resume import ResumableRunner
from repro_torch.faults import (
    FaultInjector,
    FaultPlan,
    NoHealthyHostsError,
    RetryPolicy,
    SegmentRetriesExhausted,
    SimulatedKill,
    TelemetryBuffer,
    TransientWorkerError,
)
from repro_torch.malgen import MalGenConfig, make_seed_streaming

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = MalGenConfig(num_sites=301, num_entities=1000,
                   marked_site_fraction=0.2, marked_event_fraction=0.3)
NUM_CHUNKS, CHUNK = 8, 512
NUM_HOSTS = 4
FAST_RETRY = RetryPolicy(max_attempts=4, backoff_s=0.0)
SPECS = (
    "transient_rate=0.25,seed=5,bad_hosts=1+3,kill_at_segment=2,"
    "kill_mode=raise,straggler_host=0,straggler_delay_s=0.5",
    "kill_mid_checkpoint_step=3",
    " seed = 9 , bad_hosts=2, ",
    "kill_exit_code=3,kill_mode=exit,transient_rate=1",
    "",
)
BAD_SPECS = ("frobnicate=1", "justakey", "transient_rate=1.5",
             "kill_mode=sigterm", "seed=x")


@pytest.fixture(scope="module")
def runner_and_ref():
    seed = make_seed_streaming(7, CFG, NUM_CHUNKS, CHUNK, device="cpu")
    runner = ResumableRunner(seed, CFG, nodes=1, num_chunks=NUM_CHUNKS,
                             chunk_records=CHUNK, segment_chunks=2,
                             backend="streams", device="cpu")
    return runner, runner.run()


def _assert_identical(out, ref, msg):
    for f in ("total", "marked"):
        assert torch.equal(getattr(out.result, f), getattr(ref.result, f)), \
            f"{f} {msg}"
    assert torch.equal(out.result.rho.view(torch.int32),
                       ref.result.rho.view(torch.int32)), f"rho {msg}"


# ------------------------------------------------------- plan and parser
def test_fault_plan_fields_equal_jax():
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(
        FaultPlan)]
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(
        JaxPlan)]
    assert got == want
    assert FaultPlan().kill_mode == "exit" and FaultPlan().kill_exit_code \
        == 17


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_equals_jax(spec):
    got, want = FaultPlan.parse(spec), JaxPlan.parse(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.any_kill == want.any_kill


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_parse_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError) as want:
        JaxPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- injector
def test_injector_coin_equals_jax():
    for seed in (0, 9, 11, 2**40):
        ours, theirs = (FaultInjector(FaultPlan(seed=seed)),
                        JaxInjector(JaxPlan(seed=seed)))
        for ctx in ((1, 2, 3, 4), (0, 0, 0, 1), (7, 3, 1, 6), ("x", -1)):
            a = ours._coin(*ctx)
            assert a == theirs._coin(*ctx) and 0.0 <= a < 1.0
    assert FaultInjector(FaultPlan(seed=9))._coin(1) != FaultInjector(
        FaultPlan(seed=10))._coin(1)


def test_injector_kill_points_equal_jax(tmp_path):
    for make, plan_cls, kill in ((FaultInjector, FaultPlan, SimulatedKill),
                                 (JaxInjector, JaxPlan, JaxKill)):
        inj = make(plan_cls(kill_at_segment=3, kill_mode="raise"))
        inj.before_segment(2)
        with pytest.raises(kill, match="segment 3 boundary"):
            inj.before_segment(3)
        inj2 = make(plan_cls(kill_mid_checkpoint_step=2,
                             kill_mode="raise"))
        assert inj2.checkpoint_hook(1) is None
        with pytest.raises(kill, match="mid-checkpoint step 2"):
            inj2.checkpoint_hook(2)(tmp_path / ".tmp_step_2_x")
        assert inj.events == [("kill", "segment 3 boundary")]


def test_injector_shard_attempts_and_audit_equal_jax():
    """A sweep of (segment, shard, host, attempt) under transients, a bad
    host and a straggler: the same delays, failures and audit trail."""
    fields = dict(seed=5, transient_rate=0.3, bad_hosts=(2,),
                  straggler_host=1, straggler_delay_s=0.01)
    slept = {"port": [], "jax": []}
    ours = FaultInjector(FaultPlan(**fields), sleep=slept["port"].append)
    theirs = JaxInjector(JaxPlan(**fields), sleep=slept["jax"].append)
    for seg in range(3):
        for shard in range(4):
            for host in range(4):
                for attempt in (1, 2, 3):
                    outcome = []
                    for inj, err in ((ours, TransientWorkerError),
                                     (theirs, JaxTransient)):
                        try:
                            outcome.append(inj.shard_attempt(
                                seg, shard, host, attempt))
                        except err as e:
                            outcome.append((e.segment, e.shard, e.host,
                                            str(e)))
                    assert outcome[0] == outcome[1]
    assert ours.events == theirs.events
    assert ours.fault_count == theirs.fault_count > 0
    assert slept["port"] == slept["jax"] and slept["port"]


@pytest.mark.parametrize("mode", ("raise", "exit"))
def test_kill_point_modes(mode, tmp_path):
    """``raise`` raises SimulatedKill in process; the default ``exit``
    ends the process with the plan's code, so it runs in a child."""
    if mode == "raise":
        with pytest.raises(SimulatedKill):
            FaultInjector(FaultPlan(kill_at_segment=0,
                                    kill_mode="raise")).before_segment(0)
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    code = ("from repro_torch.faults.plan import FaultInjector, FaultPlan\n"
            "FaultInjector(FaultPlan(kill_at_segment=0, kill_exit_code=23))"
            ".before_segment(0)\n"
            "print('survived')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 23 and "survived" not in proc.stdout


# ---------------------------------------------------------------- retry
def test_retry_policy_equals_jax():
    for kw in (dict(max_attempts=5, backoff_s=0.1, backoff_factor=2.0,
                    max_backoff_s=0.35), dict(backoff_s=0.0), dict()):
        ours, theirs = RetryPolicy(**kw), JaxRetry(**kw)
        assert [ours.backoff(a) for a in range(1, 7)] == [
            theirs.backoff(a) for a in range(1, 7)]
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    p = RetryPolicy(max_attempts=5, backoff_s=0.1, backoff_factor=2.0,
                    max_backoff_s=0.35)
    assert [p.backoff(a) for a in (1, 2, 3, 4)] == [0.1, 0.2, 0.35, 0.35]
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    slept = []
    assert RetryPolicy(backoff_s=0.5).wait(1, sleep=slept.append) == 0.5
    assert RetryPolicy(backoff_s=0.0).wait(1, sleep=slept.append) == 0.0
    assert slept == [0.5]


# ------------------------------------------------------------ telemetry
def test_telemetry_buckets_and_validation():
    buf = TelemetryBuffer(2, num_buckets=4, bucket_width_s=0.1,
                          device="cpu")
    assert [buf.bucket(x) for x in (0.0, 0.25, 99.0)] == [0, 2, 3]
    with pytest.raises(ValueError, match="out of range"):
        buf.record(2, 0, 0.0, False)
    buf.record(0, 0, 0.0, False)
    buf.record(1, 0, 0.0, True)
    assert len(buf) == 2 and buf.failures == 1
    with pytest.raises(ValueError, match="num_hosts"):
        TelemetryBuffer(0)


def test_clean_fleet_skips_the_diagnosis(monkeypatch):
    """Without a failure the buffer never diagnoses, so a fault-free run
    launches no extra K7 on the card."""
    def no_diagnosis(*args, **kwargs):
        raise AssertionError("diagnosed a clean fleet")

    monkeypatch.setattr(nodedoctor, "diagnose_telemetry", no_diagnosis)
    buf = TelemetryBuffer(NUM_HOSTS)
    assert buf.alarmed_hosts() == []
    for seg in range(8):
        for h in range(NUM_HOSTS):
            buf.record(h, seg, 0.01, False)
    assert buf.alarmed_hosts() == []


def _replay(events, num_hosts, **kw):
    ours = TelemetryBuffer(num_hosts, device="cpu", **kw)
    theirs = JaxBuffer(num_hosts, **kw)
    for e in events:
        ours.record(*e)
        theirs.record(*e)
    return ours, theirs


# (case, hosts, event generator)
def _persistent(num_hosts, bad):
    for seg in range(6):
        yield (bad, seg, 0.0, True)
        for h in range(num_hosts):
            if h != bad:
                yield (h, seg, 0.01, False)


def _single_transient(num_hosts):
    yield (1, 0, 0.0, True)
    for seg in range(6):
        for h in range(num_hosts):
            yield (h, seg, 0.01, False)


def _random_events(num_hosts, seed, n=120):
    rng = np.random.default_rng(seed)
    bad = int(rng.integers(num_hosts))
    for i in range(n):
        h = int(rng.integers(num_hosts))
        p = 0.6 if h == bad else 0.05
        yield (h, i // num_hosts, float(rng.random() * 0.5),
               bool(rng.random() < p))


TELEMETRY = (
    ("persistent_4", 4, lambda: _persistent(4, 0)),
    ("persistent_6", 6, lambda: _persistent(6, 5)),
    ("single_transient", 4, lambda: _single_transient(4)),
    ("random_4", 4, lambda: _random_events(4, 1)),
    ("random_5", 5, lambda: _random_events(5, 2)),
    ("random_8", 8, lambda: _random_events(8, 3, 200)),
)


@pytest.mark.parametrize("case,hosts,events", TELEMETRY,
                         ids=[c[0] for c in TELEMETRY])
def test_telemetry_alarms_equal_jax(case, hosts, events):
    ours, theirs = _replay(list(events()), hosts)
    got, want = ours.alarmed_hosts(), theirs.alarmed_hosts()
    assert got == want, case
    if case.startswith("persistent"):
        assert got == [0 if hosts == 4 else 5]
    if case == "single_transient":
        assert got == []
    # the median baseline (the doctor's default) over the same events
    got = ours.alarmed_hosts(baseline=None)
    assert got == theirs.alarmed_hosts(baseline=None), case


# -------------------------------------------------- runs under faults
def test_any_schedule_completes_identically_or_raises(runner_and_ref):
    """Seeded schedules either complete bit-identically to the fault-free
    run or raise an explicit error, and replay exactly."""
    runner, ref = runner_and_ref
    rng = np.random.default_rng(0)
    outcomes = set()
    for _ in range(10):
        bad_sel = int(rng.integers(0, NUM_HOSTS + 1))
        plan = FaultPlan(seed=int(rng.integers(0, 10_000)),
                         transient_rate=int(rng.integers(0, 41)) / 100.0,
                         bad_hosts=(bad_sel - 1,) if bad_sel else (),
                         kill_mode="raise")

        def attempt():
            try:
                return runner.run(faults=plan, retry=FAST_RETRY,
                                  num_hosts=NUM_HOSTS)
            except (SegmentRetriesExhausted, NoHealthyHostsError) as e:
                return e

        first = attempt()
        outcomes.add(type(first).__name__)
        if isinstance(first, Exception):
            assert type(attempt()) is type(first), plan
            continue
        _assert_identical(first, ref, str(plan))
        assert first.report.fault_events >= first.report.segments_retried
        second = attempt()
        _assert_identical(second, ref, str(plan))
        assert second.report.to_derived() == first.report.to_derived()
    assert "ResumeOutcome" in outcomes


def test_persistent_bad_host_alarms_and_shards_reroute(runner_and_ref):
    runner, ref = runner_and_ref
    out = runner.run(faults=FaultPlan(bad_hosts=(0,), kill_mode="raise"),
                     retry=RetryPolicy(max_attempts=6, backoff_s=0.0),
                     num_hosts=NUM_HOSTS)
    _assert_identical(out, ref, "bad host 0")
    rep = out.report
    assert rep.alarmed_hosts == [0] and rep.rerouted_shards == 1
    assert rep.segments_retried >= 1


def test_all_hosts_bad_raises_no_healthy_hosts(runner_and_ref):
    runner, _ = runner_and_ref
    with pytest.raises(NoHealthyHostsError):
        runner.run(faults=FaultPlan(bad_hosts=(0, 1), kill_mode="raise"),
                   retry=RetryPolicy(max_attempts=8, backoff_s=0.0),
                   num_hosts=2)


def test_retry_budget_exhaustion_is_explicit(runner_and_ref):
    runner, _ = runner_and_ref
    with pytest.raises(SegmentRetriesExhausted) as e:
        runner.run(faults=FaultPlan(bad_hosts=(0,), kill_mode="raise"),
                   retry=RetryPolicy(max_attempts=2, backoff_s=0.0),
                   num_hosts=1)
    assert e.value.segment == 0 and e.value.attempts == 2
    assert isinstance(e.value.last_error, TransientWorkerError)


def test_straggler_completes_identically(runner_and_ref):
    runner, ref = runner_and_ref
    sleeps = []
    injector = FaultInjector(FaultPlan(straggler_host=0,
                                       straggler_delay_s=0.01),
                             sleep=sleeps.append)
    out = runner.run(faults=injector, num_hosts=NUM_HOSTS)
    _assert_identical(out, ref, "straggler")
    assert sleeps and all(s == 0.01 for s in sleeps)
    assert out.report.alarmed_hosts == []     # slow is not failed


def test_a_device_error_is_not_retried(runner_and_ref, monkeypatch):
    """Retry covers the injected faults only: an error raised by the
    segment's own work propagates on the first attempt."""
    runner, _ = runner_and_ref
    calls = []

    def broken(state, start, seg_len):
        calls.append(start)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(runner, "_fold_segment", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        runner.run(faults=FaultPlan(seed=1, transient_rate=0.1,
                                    kill_mode="raise"),
                   retry=RetryPolicy(max_attempts=6, backoff_s=0.0))
    assert len(calls) == 1


def test_the_doctor_diagnoses_on_the_runner_device(runner_and_ref,
                                                   monkeypatch):
    runner, _ = runner_and_ref
    devices = []
    real = nodedoctor.diagnose_telemetry

    def spy(*args, device=None, **kwargs):
        devices.append(device)
        return real(*args, device=device, **kwargs)

    monkeypatch.setattr(nodedoctor, "diagnose_telemetry", spy)
    runner.run(faults=FaultPlan(bad_hosts=(0,), kill_mode="raise"),
               retry=RetryPolicy(max_attempts=6, backoff_s=0.0),
               num_hosts=NUM_HOSTS)
    assert devices and all(str(d) == "cpu" for d in devices)


def test_resume_scenarios_registered_and_in_smoke_preset():
    from repro_torch.bench.registry import SCENARIOS, preset_scenario_names
    names = {"resume_overhead_nockpt", "resume_overhead_ckpt",
             "resume_overhead_resume", "faulty_run_transient",
             "faulty_run_badhost"}
    assert names <= set(SCENARIOS)
    assert names <= set(preset_scenario_names("smoke"))
    for n in names:
        assert SCENARIOS[n].group == "resume"
