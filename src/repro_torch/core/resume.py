"""Checkpointed, fault-tolerant resumable MalStone runs.

Counterpart of ``repro/core/resume.py``. The streaming engine
(``core/streaming.py``) folds regenerated chunks into a carry in one loop:
if the process dies at chunk 9,000 of 10,000, everything is lost. This
module drives the same computation in **segments** of K chunks a node:
each segment is one ``streaming.fold_chunk_range`` call that advances the
``HistogramState`` (histogram carry + merged ``ShuffleStats`` + chunk
cursor), and after every segment the state is saved through
``repro_torch.checkpoint`` (atomic commit, elastic reshard). A preempted
run resumes from ``latest_step()`` and regenerates only the chunks not yet
folded; MalGen is deterministic from the seed, so the final histogram,
statistic and ``ShuffleStats`` are **bit-identical** to an uninterrupted
run (integer accumulation commutes; ``merge_stats`` does not depend on
where the segments split).

Fault tolerance (``repro_torch.faults``): segments run under a bounded
retry-with-backoff policy; every (shard -> host) execution unit feeds
(segment, host, failed, duration-bucket) telemetry into
``nodedoctor.diagnose``, and shards on alarmed hosts are **re-assigned**
to healthy hosts instead of retried forever. The injected faults are
host-side only and are decided before a segment's device work starts, so
the carry is folded once per segment whatever the schedule. A run may fail
(``SegmentRetriesExhausted`` / ``NoHealthyHostsError``), but it never
silently loses records. A real device error is not a fault of the plan: it
propagates and is never retried.

The checkpoint holds the JAX package's dict (``carry`` / ``chunks_done`` /
``fingerprint``, every leaf int32, per-node leaves with a leading ``[P]``
axis) under JAX's leaf names, and the fingerprint is JAX's for the same
run, so a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
from repro_torch.core.runner import (
    _finalize,
    _pad_sites,
    _raise_if_exhausted,
)
from repro_torch.core.streaming import (
    HistogramState,
    STREAM_BACKENDS,
    fold_chunk_range,
    snapshot,
    state_init,
)
from repro_torch.faults.plan import (
    FaultInjector,
    NoHealthyHostsError,
    TransientWorkerError,
)
from repro_torch.faults.retry import RetryPolicy, SegmentRetriesExhausted
from repro_torch.faults.telemetry import TelemetryBuffer

# the JAX package's name of each histogram reducer, for the fingerprint
_JAX_HISTOGRAM_IMPL = {"kernel": "pallas", "segment_sum": "segment_sum"}


@dataclasses.dataclass
class RecoveryReport:
    """Recovery accounting for one ``ResumableRunner.run`` invocation.

    Chunk counts are *global* (across all nodes); segment counts are in
    runner segments (each segment advances every node by up to K chunks).
    """

    segments_total: int = 0
    segments_run: int = 0
    segments_retried: int = 0          # failed attempts that were retried
    resumed_from_step: Optional[int] = None
    chunks_total: int = 0
    chunks_processed: int = 0          # regenerated by THIS invocation
    chunks_skipped: int = 0            # restored from the checkpoint
    checkpoint_save_ms: float = 0.0
    checkpoint_restore_ms: float = 0.0
    fault_events: int = 0
    alarmed_hosts: list = dataclasses.field(default_factory=list)
    rerouted_shards: int = 0

    def to_derived(self) -> dict:
        """BENCH json ``derived`` extras, under the JAX package's keys."""
        return {
            "segments_total": self.segments_total,
            "segments_run": self.segments_run,
            "segments_retried": self.segments_retried,
            "resumed_from_step": (-1 if self.resumed_from_step is None
                                  else self.resumed_from_step),
            "chunks_processed": self.chunks_processed,
            "chunks_skipped": self.chunks_skipped,
            "checkpoint_save_ms": round(self.checkpoint_save_ms, 3),
            "checkpoint_restore_ms": round(self.checkpoint_restore_ms, 3),
            "fault_events": self.fault_events,
            "alarmed_hosts": list(self.alarmed_hosts),
            "rerouted_shards": self.rerouted_shards,
        }


class ResumeOutcome(NamedTuple):
    result: object                     # SpmResult
    shuffle_stats: object              # ShuffleStats | None
    report: RecoveryReport


class ResumableRunner:
    """Segment-at-a-time streaming MalStone with a checkpointable state.

    ``nodes`` stands for the JAX mesh size; ``num_chunks`` is the global
    chunk count and must divide over the nodes. Node d folds chunks ``d *
    cpd + [lo, hi)`` in segment ``[lo, hi)``, the chunk ids of JAX's
    ``axis_index * cpd + start``. Runs on the card unless ``device="cpu"``.
    Build once, run many times (chaos sweeps re-run one workload under
    several fault schedules).
    """

    def __init__(self, seed, cfg, *,
                 nodes: int,
                 num_chunks: int,
                 chunk_records: int,
                 segment_chunks: int,
                 backend: str = "streams",
                 statistic: str = "B",
                 num_sites: Optional[int] = None,
                 num_weeks: int = WEEKS_PER_YEAR,
                 plan: Optional[ExchangePlan] = None,
                 device=None):
        plan = plan or ExchangePlan()
        if backend not in STREAM_BACKENDS:
            raise ValueError(
                f"unknown streaming backend {backend!r}; "
                f"have {STREAM_BACKENDS}")
        parts = nodes
        if num_chunks % parts != 0:
            raise ValueError(
                f"num_chunks ({num_chunks}) must divide over the mesh "
                f"({parts} devices)")
        cpd = num_chunks // parts
        if not 1 <= segment_chunks <= cpd:
            raise ValueError(
                f"segment_chunks ({segment_chunks}) must be in "
                f"[1, chunks_per_device={cpd}]")

        self.device = resolve_device(device)
        self.seed, self.cfg = seed.to(self.device), cfg
        self.backend, self.statistic = backend, statistic
        self.num_chunks, self.chunk_records = num_chunks, chunk_records
        self.parts, self.cpd = parts, cpd
        self.num_sites = num_sites or cfg.num_sites
        self.num_weeks = num_weeks
        self.s_pad = _pad_sites(self.num_sites, parts)
        self.plan = plan

        # per-node segment boundaries: [0, K, 2K, ..., cpd] (the last
        # segment may be shorter)
        self.boundaries = list(range(0, cpd, segment_chunks)) + [cpd]
        self.num_segments = len(self.boundaries) - 1
        self._fingerprint = self._compute_fingerprint()

    def _compute_fingerprint(self) -> np.int32:
        """The JAX package's int32 run digest, refusing another run's
        checkpoint: crc32 of the run's shape, the plan's result-affecting
        fields under JAX's names, the MalGen config and the seed, then the
        key's bytes. ``jax.random.key(k)``'s key data is the uint32 pair
        ``[0, k mod 2^32]``, which is what the port's ``rng_seed`` stands
        for. The statistic is left out: a B checkpoint may finish as A."""
        plan = self.plan
        key_bytes = np.array([0, self.seed.rng_seed & 0xFFFFFFFF],
                             np.uint32).tobytes()
        fields = (plan.impl, plan.capacity_factor, plan.max_shuffle_rounds,
                  _JAX_HISTOGRAM_IMPL[plan.histogram_impl])
        blob = "|".join(map(str, (
            self.backend, self.num_chunks, self.chunk_records, self.parts,
            self.s_pad, self.num_weeks, *fields, tuple(self.cfg),
            self.seed.num_marked_events))).encode()
        return np.int32(np.uint32(zlib.crc32(blob + key_bytes)).view(
            np.int32))

    # ------------------------------------------------------------- device
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fold_segment(self, state: HistogramState, start: int,
                      seg_len: int) -> HistogramState:
        """Every node folds its chunks ``[start, start + seg_len)`` (in
        place), then the device is synchronised, so a checkpoint or a
        return sees the segment done."""
        state = fold_chunk_range(
            state, self.seed, self.cfg,
            [d * self.cpd + start for d in range(self.parts)], seg_len,
            self.chunk_records, s_pad=self.s_pad, num_weeks=self.num_weeks,
            backend=self.backend, plan=self.plan)
        self._sync()
        return state

    # ------------------------------------------------------------ ckpt state
    def _zero_state(self) -> HistogramState:
        return state_init(self.backend, self.parts, self.s_pad,
                          self.num_weeks, self.device)

    def _state_like(self, zero: HistogramState) -> dict:
        return {"carry": zero.carry,
                "chunks_done": np.zeros((), np.int32),
                "fingerprint": np.zeros((), np.int32)}

    def _pack_state(self, state: HistogramState) -> dict:
        # the checkpoint dict IS the HistogramState (carry + cursor) plus
        # the run fingerprint: the JAX package's keys and shapes
        return {"carry": state.carry,
                "chunks_done": np.int32(state.chunks_folded),
                "fingerprint": np.int32(self._fingerprint)}

    # ------------------------------------------------------------------- run
    def run(self, *,
            checkpoint_dir=None,
            resume: bool = True,
            checkpoint_shards: int = 1,
            keep: int = 3,
            faults=None,
            retry: Optional[RetryPolicy] = None,
            num_hosts: Optional[int] = None,
            doctor_baseline: float = 0.05,
            doctor_threshold: float = 6.0,
            telemetry: Optional[TelemetryBuffer] = None) -> ResumeOutcome:
        """Execute (or resume) the run; returns ``(SpmResult,
        ShuffleStats|None, RecoveryReport)``.

        ``faults`` is a ``FaultPlan`` or prebuilt ``FaultInjector``;
        ``num_hosts`` sizes the logical worker pool the fault/telemetry
        layer schedules shards onto (default: one host per node).
        """
        injector = (faults if isinstance(faults, FaultInjector)
                    else FaultInjector(faults) if faults is not None
                    else None)
        retry = retry or RetryPolicy()
        num_hosts = num_hosts or self.parts
        if telemetry is None and injector is not None:
            telemetry = TelemetryBuffer(num_hosts, device=self.device)

        report = RecoveryReport(segments_total=self.num_segments,
                                chunks_total=self.num_chunks)
        mgr = (CheckpointManager(checkpoint_dir, keep=keep,
                                 num_shards=checkpoint_shards)
               if checkpoint_dir else None)

        # shard s starts on host s (mod pool size); reroutes mutate this
        assignment = [s % num_hosts for s in range(self.parts)]
        blocked: set = set()

        state = self._zero_state()
        start_seg = 0
        if mgr is not None and resume:
            t0 = time.perf_counter()
            step, saved = mgr.restore_latest(self._state_like(state))
            report.checkpoint_restore_ms = (time.perf_counter() - t0) * 1e3
            if step is not None:
                if int(saved["fingerprint"]) != int(self._fingerprint):
                    raise ValueError(
                        f"checkpoint at {checkpoint_dir} belongs to a "
                        f"different run configuration (fingerprint "
                        f"{int(saved['fingerprint'])} != "
                        f"{int(self._fingerprint)}); refuse to resume")
                chunks_done = int(saved["chunks_done"])
                if (step > self.num_segments
                        or chunks_done != self.boundaries[step]):
                    raise ValueError(
                        f"checkpoint step {step} / chunk cursor "
                        f"{chunks_done} does not lie on this run's segment "
                        f"boundaries {self.boundaries}")
                state = HistogramState(saved["carry"], chunks_done)
                start_seg = step
                report.resumed_from_step = step
                report.chunks_skipped = chunks_done * self.parts

        for seg in range(start_seg, self.num_segments):
            if injector is not None:
                injector.before_segment(seg)
            lo, hi = self.boundaries[seg], self.boundaries[seg + 1]
            state = self._run_segment(
                state, seg, lo, hi - lo, injector, retry, telemetry,
                assignment, blocked, num_hosts, doctor_baseline,
                doctor_threshold, report)
            report.segments_run += 1
            report.chunks_processed += (hi - lo) * self.parts
            if mgr is not None:
                t0 = time.perf_counter()
                hook = (injector.checkpoint_hook(seg + 1)
                        if injector is not None else None)
                mgr.save(seg + 1, self._pack_state(state),
                         pre_commit_hook=hook)
                report.checkpoint_save_ms += (time.perf_counter() - t0) * 1e3

        hist, stats = snapshot(state, backend=self.backend, s_pad=self.s_pad,
                               num_weeks=self.num_weeks)
        if self.backend == "mapreduce":
            _raise_if_exhausted(stats)
        else:
            stats = None
        if injector is not None:
            report.fault_events = injector.fault_count
        result = _finalize(hist[:self.num_sites], self.statistic)
        self._sync()
        return ResumeOutcome(result, stats, report)

    def _run_segment(self, state: HistogramState, seg: int, start: int,
                     seg_len: int, injector, retry: RetryPolicy, telemetry,
                     assignment: list, blocked: set, num_hosts: int,
                     doctor_baseline: float, doctor_threshold: float,
                     report: RecoveryReport) -> HistogramState:
        """One segment under the retry/reroute loop. The injected faults
        are decided on the host before the segment's device work, which
        runs once, on the attempt without a fault: that is what keeps
        chaotic runs bit-identical."""
        last_error = None
        for attempt in range(1, retry.max_attempts + 1):
            fault = None
            if injector is not None:
                for shard in range(self.parts):
                    host = assignment[shard]
                    try:
                        delay = injector.shard_attempt(seg, shard, host,
                                                       attempt)
                        telemetry.record(host, seg, delay, False)
                    except TransientWorkerError as e:
                        telemetry.record(host, seg, 0.0, True)
                        fault = fault or e
            if fault is None:
                return self._fold_segment(state, start, seg_len)
            last_error = fault
            report.segments_retried += 1
            self._reroute(telemetry, assignment, blocked, num_hosts,
                          doctor_baseline, doctor_threshold, report)
            if attempt < retry.max_attempts:
                retry.wait(attempt)
        raise SegmentRetriesExhausted(
            f"segment {seg} failed on all {retry.max_attempts} attempts "
            f"(last: {last_error}); no records were lost — resume from the "
            f"latest checkpoint once the fleet recovers",
            segment=seg, attempts=retry.max_attempts, last_error=last_error)

    def _reroute(self, telemetry, assignment, blocked, num_hosts,
                 baseline, threshold, report):
        """Ask the doctor which hosts are marking their work; move their
        shards to the healthiest (least-loaded, unalarmed) hosts."""
        alarmed = set(telemetry.alarmed_hosts(
            baseline=baseline, threshold_sigmas=threshold))
        newly = alarmed - blocked
        if not newly:
            return
        blocked |= newly
        report.alarmed_hosts = sorted(blocked)
        healthy = [h for h in range(num_hosts) if h not in blocked]
        if not healthy:
            raise NoHealthyHostsError(
                f"all {num_hosts} hosts are alarmed "
                f"({sorted(blocked)}); nothing to reroute shards onto")
        load = {h: sum(1 for a in assignment if a == h) for h in healthy}
        for shard, host in enumerate(assignment):
            if host in blocked:
                target = min(healthy, key=lambda h: load[h])
                assignment[shard] = target
                load[target] += 1
                report.rerouted_shards += 1


def malstone_run_resumable(seed, cfg, *,
                           nodes: int,
                           num_chunks: int,
                           chunk_records: int,
                           segment_chunks: int,
                           checkpoint_dir=None,
                           resume: bool = True,
                           backend: str = "streams",
                           statistic: str = "B",
                           faults=None,
                           retry: Optional[RetryPolicy] = None,
                           **kw) -> ResumeOutcome:
    """One-shot wrapper around :class:`ResumableRunner`. Runner-level
    kwargs (``num_sites``, ``num_weeks``, ``plan``, ``device``) pass
    through ``kw``; run-level knobs (``checkpoint_shards``, ``num_hosts``,
    ``keep``, doctor thresholds) use :class:`ResumableRunner` directly."""
    runner = ResumableRunner(
        seed, cfg, nodes=nodes, num_chunks=num_chunks,
        chunk_records=chunk_records, segment_chunks=segment_chunks,
        backend=backend, statistic=statistic, **kw)
    return runner.run(checkpoint_dir=checkpoint_dir, resume=resume,
                      faults=faults, retry=retry)
