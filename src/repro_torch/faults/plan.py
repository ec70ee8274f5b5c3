"""Seeded, deterministic fault schedules.

Counterpart of ``repro/faults/plan.py``, copied (the port imports nothing
of the JAX package).

A ``FaultPlan`` describes *what goes wrong*; a ``FaultInjector`` executes
it. Every stochastic decision is a pure function of
``(plan.seed, segment, shard, host, attempt)`` via a hash coin, so a chaos
schedule is exactly replayable: the same plan against the same run either
completes (bit-identically — the injected faults never touch device math)
or raises the same explicit error.

Fault classes:

- **transient**: each (shard, host) flips a seeded coin per attempt;
  below ``transient_rate`` the worker raises ``TransientWorkerError``.
  Retries re-flip (attempt is part of the coin), so transients clear.
- **bad hosts**: hosts in ``bad_hosts`` fail every attempt — only the
  NodeDoctor rerouting their shards (or an exhausted retry budget) ends it.
- **straggler**: ``straggler_host`` sleeps ``straggler_delay_s`` per
  touched shard before answering — visible in duration-bucket telemetry.
- **kills**: ``kill_at_segment`` fires at a segment boundary (before the
  segment runs); ``kill_mid_checkpoint_step`` fires inside the checkpoint
  writer's crash window (shards written, commit marker not). With
  ``kill_mode="exit"`` the process hard-exits with ``kill_exit_code``
  (subprocess crash tests); ``kill_mode="raise"`` raises ``SimulatedKill``
  so in-process tests can observe the interruption and resume.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional, Tuple


class FaultError(RuntimeError):
    """Base class for every injected-fault error."""


class TransientWorkerError(FaultError):
    """An injected worker failure; carries attribution for telemetry."""

    def __init__(self, msg: str, *, segment: int, shard: int, host: int):
        super().__init__(msg)
        self.segment = segment
        self.shard = shard
        self.host = host


class SimulatedKill(FaultError):
    """Raised instead of ``os._exit`` when ``kill_mode='raise'``."""


class NoHealthyHostsError(FaultError):
    """Every host in the pool is alarmed — nothing left to reroute to."""


_KILL_MODES = ("exit", "raise")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic chaos schedule (see module docstring)."""

    seed: int = 0
    transient_rate: float = 0.0
    bad_hosts: Tuple[int, ...] = ()
    straggler_host: Optional[int] = None
    straggler_delay_s: float = 0.0
    kill_at_segment: Optional[int] = None
    kill_mid_checkpoint_step: Optional[int] = None
    kill_mode: str = "exit"
    kill_exit_code: int = 17

    def __post_init__(self):
        if not 0.0 <= self.transient_rate <= 1.0:
            raise ValueError(
                f"transient_rate must be in [0, 1], got {self.transient_rate}")
        if self.kill_mode not in _KILL_MODES:
            raise ValueError(
                f"kill_mode must be one of {_KILL_MODES}, "
                f"got {self.kill_mode!r}")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a CLI spec: comma-separated ``key=value``
        pairs; list values use ``+`` (``bad_hosts=1+3``). Example::

            transient_rate=0.25,seed=5,kill_at_segment=2,bad_hosts=1
        """
        kw: dict = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(
                    f"bad --inject-faults entry {part!r}; expected key=value")
            key, val = (s.strip() for s in part.split("=", 1))
            fields = {f.name: f for f in dataclasses.fields(cls)}
            if key not in fields:
                raise ValueError(
                    f"unknown fault key {key!r}; have {sorted(fields)}")
            typ = fields[key].type
            if key == "bad_hosts":
                kw[key] = tuple(int(v) for v in val.split("+") if v)
            elif key == "kill_mode":
                kw[key] = val
            elif "float" in str(typ):
                kw[key] = float(val)
            else:
                kw[key] = int(val)
        return cls(**kw)

    @property
    def any_kill(self) -> bool:
        return (self.kill_at_segment is not None
                or self.kill_mid_checkpoint_step is not None)


class FaultInjector:
    """Executes a ``FaultPlan``. Host-side only — never traced; the device
    computation is untouched, which is why every completed chaotic run is
    bit-identical to a fault-free one."""

    def __init__(self, plan: FaultPlan, *, sleep=time.sleep):
        self.plan = plan
        self._sleep = sleep
        self.events: list = []   # (kind, segment, shard, host) audit trail

    # ---------------------------------------------------------------- coins
    def _coin(self, *parts) -> float:
        """Deterministic uniform in [0, 1) from the plan seed + context."""
        blob = ("|".join(str(p) for p in (self.plan.seed,) + parts)).encode()
        h = hashlib.sha256(blob).digest()
        return int.from_bytes(h[:8], "big") / 2**64

    # ---------------------------------------------------------------- kills
    def _kill(self, where: str):
        self.events.append(("kill", where))
        if self.plan.kill_mode == "raise":
            raise SimulatedKill(f"injected kill at {where}")
        os._exit(self.plan.kill_exit_code)  # hard exit: no cleanup, as real

    def before_segment(self, segment: int):
        """Segment-boundary kill point: the previous segment's checkpoint
        is committed, this segment has not started."""
        if self.plan.kill_at_segment == segment:
            self._kill(f"segment {segment} boundary")

    def checkpoint_hook(self, step: int):
        """Returns a ``save_checkpoint`` pre-commit hook (or None): the
        kill fires after shard files are written but before the atomic
        rename — the mid-write crash window."""
        if self.plan.kill_mid_checkpoint_step != step:
            return None

        def hook(tmp_dir):
            self._kill(f"mid-checkpoint step {step} ({tmp_dir.name})")
        return hook

    # -------------------------------------------------------------- workers
    def shard_attempt(self, segment: int, shard: int, host: int,
                      attempt: int) -> float:
        """Inject for one (shard -> host) unit of one segment attempt.
        Returns the injected delay in seconds (straggler) or raises
        ``TransientWorkerError``."""
        delay = 0.0
        if host == self.plan.straggler_host and self.plan.straggler_delay_s:
            delay = self.plan.straggler_delay_s
            self.events.append(("straggle", segment, shard, host))
            self._sleep(delay)
        if host in self.plan.bad_hosts:
            self.events.append(("fail_bad_host", segment, shard, host))
            raise TransientWorkerError(
                f"host {host} is down (segment {segment}, shard {shard})",
                segment=segment, shard=shard, host=host)
        if (self.plan.transient_rate > 0.0
                and self._coin(segment, shard, host, attempt)
                < self.plan.transient_rate):
            self.events.append(("fail_transient", segment, shard, host))
            raise TransientWorkerError(
                f"transient failure on host {host} "
                f"(segment {segment}, shard {shard}, attempt {attempt})",
                segment=segment, shard=shard, host=host)
        return delay

    @property
    def fault_count(self) -> int:
        return sum(1 for e in self.events if e[0].startswith("fail"))
