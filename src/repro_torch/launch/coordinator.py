"""Multi-process launch: a ``torch.distributed`` gang over localhost or a
cluster.

Counterpart of ``repro/launch/coordinator.py``. N processes, each holding
``P/N`` of the P nodes (``repro_torch.common.nodes.NodeGroup``), join one
gloo process group, so the mapreduce exchange's ``all_to_all`` and its
gang-wide round termination cross real process boundaries. Gloo, not NCCL:
ranks may share one card (NCCL refuses two ranks on one GPU), and the
collectives are staged through the host (``common/nodes.py``).

Three launch modes, selected by the shared ``--num-processes`` /
``--process-id`` / ``--coordinator`` flags (``add_arguments``), with the
JAX launcher's flags, checks and exit statuses:

- **single-process** (default): ``initialize`` returns at once — nothing
  distributed.
- **worker**: ``--process-id K --coordinator HOST:PORT`` — this process is
  rank K of an externally-launched gang (SLURM, mpirun, or the spawn
  parent below). ``initialize`` joins the gloo group over
  ``tcp://HOST:PORT`` with a timeout, so a rank that never arrives, or a
  collective that one rank never enters, fails the gang instead of hanging
  it.
- **spawn parent**: ``--num-processes N`` *without* ``--process-id`` —
  auto-spawn localhost mode. ``spawn_local`` re-invokes this very command N
  times with ``--coordinator 127.0.0.1:<port> --process-id k`` appended,
  waits for all workers, and returns the first nonzero exit status (124 on
  a timeout). The parent never touches CUDA; with ``build_kernels`` it
  first builds the CUDA kernels once (``kernels/_build.py:build_all``:
  nvcc only, no CUDA context), so that N ranks do not each compile every
  source.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

from repro_torch.common import env

# seconds a rank waits for the gang to form, and for any one collective
DIST_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Parsed distributed-launch configuration."""

    num_processes: int = 1
    process_id: Optional[int] = None
    coordinator: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_spawn_parent(self) -> bool:
        """``--num-processes N`` given without a rank: this invocation's job
        is to fork the N localhost workers, not to compute."""
        return self.num_processes > 1 and self.process_id is None

    @property
    def is_worker(self) -> bool:
        return self.num_processes > 1 and self.process_id is not None


def add_arguments(ap) -> None:
    """Attach the distributed flags to an ``argparse`` parser (keep in sync
    with ``preparse``, which reads the same flags from raw argv)."""
    g = ap.add_argument_group(
        "distributed launch (repro_torch.launch.coordinator)")
    g.add_argument("--num-processes", type=int, default=1, metavar="N",
                   help="run as N cooperating processes joined over gloo;"
                        " without --process-id this invocation becomes a"
                        " spawn parent that forks N localhost workers")
    g.add_argument("--process-id", type=int, default=None, metavar="K",
                   help="this process's rank in [0, N) — set by the spawn"
                        " parent, or by an external launcher (SLURM/mpirun)")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="the gang's rendezvous address (the spawn parent"
                        " picks a free localhost port automatically)")


def preparse(argv: Optional[Sequence[str]] = None) -> DistConfig:
    """Build a :class:`DistConfig` from raw argv, before argparse (mirrors
    ``add_arguments``)."""
    return DistConfig(
        num_processes=env.preparse_int_flag("--num-processes", 1, argv) or 1,
        process_id=env.preparse_int_flag("--process-id", None, argv),
        coordinator=env.preparse_flag("--coordinator", None, argv),
    )


def pick_port() -> int:
    """A free localhost TCP port for the coordinator (bind-to-0 probe)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(cfg: DistConfig, argv: Optional[Sequence[str]] = None, *,
                timeout: Optional[float] = None) -> int:
    """Fork ``cfg.num_processes`` localhost workers of this very command.

    Each worker is ``sys.executable + argv`` with ``--coordinator
    127.0.0.1:<fresh port> --process-id k`` appended (preparse reads the
    LAST occurrence of a flag, so the appended rank wins even if argv
    already mentions one). Workers inherit the environment and stream their
    output directly. Returns the first nonzero worker exit status, in the
    order the workers end (0 when all succeed); once one worker has failed,
    the others are killed rather than left waiting in a collective. On
    timeout every worker is killed and 124 is returned.
    """
    argv = list(sys.argv if argv is None else argv)
    address = cfg.coordinator or f"127.0.0.1:{pick_port()}"
    procs = []
    for rank in range(cfg.num_processes):
        cmd = [sys.executable] + argv + [
            "--coordinator", address, "--process-id", str(rank)]
        procs.append(subprocess.Popen(cmd))
    deadline = None if timeout is None else time.monotonic() + timeout
    status = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            status = next((c for c in codes if c not in (None, 0)), 0)
            if status != 0 or None not in codes:
                break
            if deadline is not None and time.monotonic() > deadline:
                status = 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return status


def run_in_session(cmd: Sequence[str], *, timeout: float,
                   env: Optional[dict] = None, cwd=None) -> tuple:
    """``(exit status, stdout, stderr)`` of ``cmd`` (a gang's spawn parent,
    say) run in a session of its own: at the timeout the whole session,
    the parent and every rank it forked, is killed and the status is 124,
    so no rank is left waiting in a collective."""
    proc = subprocess.Popen(list(cmd), cwd=cwd, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err
    return proc.returncode, out, err

def initialize(cfg: DistConfig) -> bool:
    """Join the gang, if this process is one of its workers.

    Calls ``torch.distributed.init_process_group("gloo", init_method=
    "tcp://<coordinator>", rank=..., world_size=..., timeout=...)``; every
    collective of the group then fails after ``DIST_TIMEOUT_S`` instead of
    hanging. Returns True iff distributed initialization happened. A spawn
    parent must not call this — run :func:`spawn_local` instead (this
    raises to catch that mix-up).
    """
    if cfg.is_spawn_parent:
        raise ValueError(
            "spawn parent must not join the gang — call spawn_local() and"
            " exit with its status; only workers (--process-id) initialize")
    if not cfg.is_distributed:
        return False
    if cfg.coordinator is None:
        raise ValueError(
            "worker needs --coordinator HOST:PORT (the spawn parent appends"
            " it automatically)")
    if not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError(
            f"--process-id {cfg.process_id} out of range for"
            f" --num-processes {cfg.num_processes}")
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{cfg.coordinator}",
        rank=cfg.process_id, world_size=cfg.num_processes,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return True


def process_banner(cfg: DistConfig) -> str:
    """One-line launch description for run logs."""
    if not cfg.is_distributed:
        return "single-process"
    return (f"process {cfg.process_id}/{cfg.num_processes} "
            f"via {cfg.coordinator}")


def bootstrap(argv: Optional[Sequence[str]] = None, *,
              local_devices_for: Optional[int] = None,
              build_kernels: bool = False,
              timeout: Optional[float] = None) -> DistConfig:
    """The one-call entry-point preamble: preparse, spawn-and-exit if this
    is a spawn parent, otherwise initialize and return the config.

    ``local_devices_for`` is the TOTAL node count the run wants (e.g.
    ``--nodes``); it must split evenly over the processes, each holding
    ``total // num_processes`` nodes. A spawn parent with
    ``build_kernels`` builds the CUDA kernels before it forks (the ranks
    then find every library built); ``timeout`` bounds the gang's wall
    time.
    """
    cfg = preparse(argv)
    if local_devices_for is not None and (
            local_devices_for % cfg.num_processes != 0):
        raise SystemExit(
            f"--nodes ({local_devices_for}) must divide evenly over"
            f" --num-processes ({cfg.num_processes})")
    if cfg.is_spawn_parent:
        if build_kernels:
            from repro_torch.kernels._build import build_all

            build_all()
        raise SystemExit(spawn_local(cfg, argv, timeout=timeout))
    initialize(cfg)
    return cfg
