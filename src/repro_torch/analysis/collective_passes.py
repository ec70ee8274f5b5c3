"""Collective passes: the exchanges' collectives, as the backends reach them.

Counterpart of ``repro/analysis/hlo_passes.py`` and ``hlo.py``. The JAX
package checks its exchange loop on the compiled post-SPMD program: one
program serves every device, so the devices cannot disagree on the order
of their collectives. The port runs eagerly, a gang of processes each
running its own Python, so the collectives are *recorded* instead:
:func:`record_collectives` patches the public collectives of
``common/nodes.py`` (``all_to_all``, ``psum``, ``psum_scatter``,
``all_gather``, ``all_gather_unstride``, ``global_count``, and the
pipeline's ``ppermute`` and ``broadcast``) as
``record_pallas_calls`` patches ``pl.pallas_call``, and marks each round
and each exchange of the mapreduce backend. Each record holds the op, the
dtype, the shape, the bytes, the group's world and rank, and whether the
call went through gloo (staged through the host).

The targets run on the context's device (``--device``: the card unless
the caller asks for the CPU) at P = 4 at JAX's live plans (capacity
factor 0.5, and capped at 3 rounds): the mapreduce counting, sort and
columns exchanges, the partitioned route, streams, sphere and the
combiner, and the streaming engine.

- **CL001**: an exchange round's ``all_to_all`` with no ``global_count``
  after it in the same round: nothing tells the ranks that the records
  are all delivered, so the loop cannot stop on a count every rank agrees
  on.
- **CL002**: a collective staged through the host in a group of one
  process: a copy to pinned memory and back that moves nothing.
- **CL003**: the rounds an exchange ran differ from its
  ``ShuffleStats.rounds``, or exceed ``core/plan.py``'s
  ``expected_shuffle_rounds`` for the target's plan.
- **CL004**: a collective dtype missing from ``common.nodes.WIRE_BYTES``,
  the byte table the exchange clock counts with.
- **CL005**: the ranks of a gang of 2 over gloo, on the same device (run
  as the gang tests run theirs, by :mod:`repro_torch.analysis.gang`),
  record different sequences of (op, dtype, shape): a rank would wait in
  a collective the other never enters. This is what JAX gets by
  construction.

``launch/hlo_analysis.py`` and ``hlo.py`` have no counterpart: eager
PyTorch compiles no program to parse, and the recorder takes their
place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import json
import os
import pathlib
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AnalysisContext, register_pass

# the live plans (JAX hlo_passes.py:38-39): tighter buckets than the
# default so the exchange loop runs several rounds, and an explicit cap
LIVE_CAPACITY_FACTOR = 0.5
LIVE_CAPPED_ROUNDS = 3
# the targets' geometry: P = 4 nodes of 256 records over 8 sites and 8
# weeks (3 rounds drain every node at capacity 0.5 on this log), chunks of
# 64 records for the streaming engine
PARTS = 4
SITES = 8
WEEKS = 8
ENTITIES = 16
RECORDS_PER_NODE = 256
CHUNK_RECORDS = 64
LOG_SEED = 0
GANG_RANKS = 2
GANG_TIMEOUT_S = 180.0

PUBLIC_COLLECTIVES = ("all_to_all", "psum", "psum_scatter", "all_gather",
                      "all_gather_unstride", "global_count", "ppermute",
                      "broadcast")


@dataclasses.dataclass
class CollectiveRecord:
    """One public collective call, or a marker of the exchange loop
    (``op`` "round" at each round's start, "exchange" and "exchange_end"
    around each exchange; ``rounds``, ``records`` and ``parts`` on the
    end marker: the exchange's ``ShuffleStats.rounds``, its records a
    node, and P)."""

    op: str
    dtype: str = ""
    shape: tuple = ()
    bytes: int = 0
    world: int = 1
    rank: int = 0
    gloo: bool = False
    rounds: int = 0
    records: int = 0
    parts: int = 0

    def signature(self) -> tuple:
        """What every rank of a gang must agree on, in order."""
        return (self.op, self.dtype, tuple(self.shape))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CollectiveRecord":
        return CollectiveRecord(**{**d, "shape": tuple(d["shape"])})


@contextlib.contextmanager
def record_collectives():
    """Patch the public collectives of ``common.nodes`` and the round and
    exchange functions of the mapreduce backend with recorders; yields the
    list the records land in.

    The backends call the collectives as ``nodes.<op>`` and the round
    functions through their module's globals, so the patch reaches them
    without touching their code. A collective that another one calls
    (``psum_scatter``'s ``psum``) is recorded once, as the outer call.
    ``gloo`` is True where the call reached ``nodes._to_host`` or
    ``nodes._gloo``.
    """
    from repro_torch.common import nodes
    from repro_torch.core.backends import mapreduce

    records: list = []
    state = {"depth": 0, "staged": 0}
    saved = {}

    def patch(module, name, fn):
        saved[(module, name)] = getattr(module, name)
        setattr(module, name, fn)

    def collective(name, real):
        sig = inspect.signature(real)

        @functools.wraps(real)
        def rec(*args, **kwargs):
            if state["depth"]:
                return real(*args, **kwargs)
            bound = sig.bind(*args, **kwargs).arguments
            x = next(iter(bound.values()))
            group = bound.get("group")
            r = CollectiveRecord(
                op=name, dtype=str(x.dtype).replace("torch.", ""),
                shape=tuple(x.shape),
                bytes=x.numel() * nodes.WIRE_BYTES.get(x.dtype, 0),
                world=group.world if group is not None else 1,
                rank=group.rank if group is not None else 0)
            records.append(r)
            staged = state["staged"]
            state["depth"] += 1
            try:
                return real(*args, **kwargs)
            finally:
                state["depth"] -= 1
                r.gloo = state["staged"] > staged

        return rec

    def staging(real):
        @functools.wraps(real)
        def rec(*args, **kwargs):
            state["staged"] += 1
            return real(*args, **kwargs)

        return rec

    def marker(real):
        @functools.wraps(real)
        def rec(*args, **kwargs):
            records.append(CollectiveRecord(op="round"))
            return real(*args, **kwargs)

        return rec

    def exchange(real, log_arg):
        sig = inspect.signature(real)

        @functools.wraps(real)
        def rec(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            x = bound[log_arg]
            x = x if hasattr(x, "shape") else x.site_id
            rows, n = x.shape
            parts = nodes.group_of_rows(bound.get("group"), rows).nodes
            records.append(CollectiveRecord(op="exchange"))
            out = real(*args, **kwargs)
            records.append(CollectiveRecord(
                op="exchange_end", rounds=int(out[1].rounds), records=n,
                parts=parts))
            return out

        return rec

    try:
        for name in PUBLIC_COLLECTIVES:
            patch(nodes, name, collective(name, getattr(nodes, name)))
        patch(nodes, "_to_host", staging(nodes._to_host))
        patch(nodes, "_gloo", staging(nodes._gloo))
        patch(mapreduce, "ship_round", marker(mapreduce.ship_round))
        patch(mapreduce, "ship_columns_round",
              marker(mapreduce.ship_columns_round))
        patch(mapreduce, "exchange_and_reduce",
              exchange(mapreduce.exchange_and_reduce, "words_sorted"))
        patch(mapreduce, "columns_shuffle_histogram",
              exchange(mapreduce.columns_shuffle_histogram, "log"))
        yield records
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


# ---------------------------------------------------------------- checks
def check_records(records: list, target: str, *,
                  plan=None, stats_rounds: Optional[int] = None) -> list:
    """CL001-CL004 over one target's records. ``plan`` gives the round
    bound (``expected_shuffle_rounds``); ``stats_rounds`` is the
    ``ShuffleStats.rounds`` the target returned (the most of any of its
    exchanges), or None where it returned none.

    Exposed separately so tests can feed a seeded sequence (a round with
    no ``global_count``) straight in.
    """
    from repro_torch.common.nodes import WIRE_BYTES
    from repro_torch.core.plan import expected_shuffle_rounds

    known = {str(d).replace("torch.", "") for d in WIRE_BYTES}
    findings = []

    def add(rule, location, message, fix_hint, severity="error"):
        findings.append(Finding(rule=rule, severity=severity, target=target,
                                location=location, message=message,
                                fix_hint=fix_hint))

    exchange, rnd, marked = -1, -1, 0
    a2a_open = False             # an all_to_all this round, no count after
    exchange_rounds = []

    def close_round():
        if a2a_open:
            add("CL001", f"exchange#{exchange}/round{rnd}",
                f"round {rnd} of exchange {exchange} ran an all_to_all "
                f"and no global_count after it: the ranks cannot agree "
                f"that every record was delivered",
                "end each round with the gang-wide global_count of the "
                "records left, and stop the loop on it")

    for i, r in enumerate(records):
        if r.op == "exchange":
            exchange, rnd, marked, a2a_open = exchange + 1, -1, 0, False
        elif r.op == "round":
            close_round()
            rnd, marked, a2a_open = rnd + 1, marked + 1, False
        elif r.op == "exchange_end":
            close_round()
            a2a_open = False
            exchange_rounds.append(r.rounds)
            if marked != r.rounds:
                add("CL003", f"exchange#{exchange}",
                    f"the exchange ran {marked} rounds but its "
                    f"ShuffleStats.rounds is {r.rounds}",
                    "count rounds where the loop runs them")
            if plan is not None:
                bound = expected_shuffle_rounds(plan, r.records, r.parts)
                if r.rounds > bound:
                    add("CL003", f"exchange#{exchange}/bound",
                        f"the exchange ran {r.rounds} rounds, over the "
                        f"plan's bound of {bound} (expected_shuffle_rounds"
                        f" for {r.records} records a node at P = "
                        f"{r.parts})",
                        "the loop must stop at the plan's round bound")
        else:
            if r.op == "all_to_all" and rnd >= 0:
                a2a_open = True
            elif r.op == "global_count":
                a2a_open = False
            if r.gloo and r.world == 1:
                add("CL002", f"{r.op}#{i}",
                    f"{r.op} of {r.dtype} {list(r.shape)} was staged "
                    f"through the host in a group of one process: a copy "
                    f"out and back that moves nothing",
                    "run the tensor op alone when the group is not "
                    "distributed", severity="warning")
            if r.dtype not in known:
                add("CL004", f"dtype:{r.dtype}",
                    f"{r.op} moves {r.dtype}, which common.nodes.WIRE_BYTES"
                    f" does not know: the exchange clock cannot count its "
                    f"bytes", "add the dtype's width to WIRE_BYTES")
    close_round()
    if stats_rounds is not None and exchange_rounds \
            and stats_rounds != max(exchange_rounds):
        add("CL003", "stats",
            f"the target reports ShuffleStats.rounds {stats_rounds}, but "
            f"its exchanges ran at most {max(exchange_rounds)} rounds",
            "merge per-exchange rounds as the worst exchange")
    # one finding a rule and location is enough
    return list({f.key: f for f in findings}.values())


def check_gang(sequences: dict) -> list:
    """CL005: ``{target: [records of rank 0, records of rank 1, ...]}``;
    every rank must record the same (op, dtype, shape) sequence."""
    findings = []
    for target, ranks in sorted(sequences.items()):
        first = [r.signature() for r in ranks[0]]
        for k, recs in enumerate(ranks[1:], start=1):
            got = [r.signature() for r in recs]
            if got == first:
                continue
            i = next((j for j, (a, b) in enumerate(zip(first, got))
                      if a != b), min(len(first), len(got)))
            a = first[i] if i < len(first) else "nothing"
            b = got[i] if i < len(got) else "nothing"
            findings.append(Finding(
                rule="CL005", severity="error",
                target=f"collectives:gang/{target}", location=f"rank{k}",
                message=(f"rank {k} recorded another sequence of "
                         f"collectives than rank 0: at call {i}, {b} "
                         f"against {a} ({len(got)} and {len(first)} "
                         f"calls); one rank would wait in a collective "
                         f"the other never enters"),
                fix_hint=("make every rank run the same collectives in the "
                          "same order: derive loop counts from gang-wide "
                          "values (global_count), never from local ones")))
    return findings


# --------------------------------------------------------------- targets
def live_log():
    """The targets' flat node-major log of ``PARTS * RECORDS_PER_NODE``
    records, made with numpy from ``LOG_SEED`` (as the tests hand JAX the
    same arrays): int32 site, entity, timestamp (in the first ``WEEKS``
    weeks) and mark."""
    from repro_torch.common.types import SECONDS_PER_WEEK

    rng = np.random.default_rng(LOG_SEED)
    n = PARTS * RECORDS_PER_NODE
    return {"site_id": rng.integers(0, SITES, n, dtype=np.int32),
            "entity_id": rng.integers(0, ENTITIES, n, dtype=np.int32),
            "timestamp": rng.integers(0, WEEKS * SECONDS_PER_WEEK, n,
                                      dtype=np.int32),
            "mark": rng.integers(0, 2, n, dtype=np.int32)}


def live_plans() -> dict:
    """``{name: (plan, run kwargs)}`` of the targets."""
    from repro_torch.common.types import ExchangePlan

    def plan(impl="auto", cap=None):
        return ExchangePlan(impl=impl, capacity_factor=LIVE_CAPACITY_FACTOR,
                            max_shuffle_rounds=cap)

    out = {}
    for impl in ("counting", "sort", "columns"):
        out[f"mapreduce/{impl}"] = (plan(impl), {"backend": "mapreduce"})
        out[f"mapreduce/{impl}/capped"] = (plan(impl, LIVE_CAPPED_ROUNDS),
                                           {"backend": "mapreduce"})
    out["partitioned/mapreduce"] = (plan("counting"), {
        "backend": "mapreduce", "partitioned": True})
    for backend in ("streams", "sphere", "mapreduce_combiner"):
        out[backend] = (plan(), {"backend": backend})
    for backend in ("mapreduce", "streams"):
        out[f"streaming/{backend}"] = (plan("counting"), {
            "backend": backend, "engine": "streaming",
            "chunk_records": CHUNK_RECORDS})
    return out


def run_target(name: str, device, group=None):
    """Run target ``name`` on ``device`` under the recorder: ``(records,
    plan, ShuffleStats.rounds or None)``. ``group`` runs it as one rank of
    a gang."""
    from repro_torch.common.types import EventLog
    from repro_torch.core import run

    plan, kwargs = live_plans()[name]
    log = EventLog(**{k: torch.from_numpy(v) for k, v in live_log().items()})
    with record_collectives() as records:
        _, stats = run(log, SITES, nodes=PARTS, plan=plan,
                       num_weeks=WEEKS, device=device, group=group,
                       return_shuffle_stats=True, **kwargs)
    return records, plan, (None if stats is None else int(stats.rounds))


def run_gang(device) -> dict:
    """Run every target in a gang of ``GANG_RANKS`` processes over gloo,
    each on ``device``'s type (``python -m repro_torch.analysis.gang``, in
    a session of its own): ``{target: [records of each rank]}``."""
    from repro_torch.launch import coordinator

    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        status, stdout, stderr = coordinator.run_in_session(
            [sys.executable, "-m", "repro_torch.analysis.gang",
             "--num-processes", str(GANG_RANKS), "--device",
             torch.device(device).type, "--out", str(out)],
            timeout=GANG_TIMEOUT_S, env=env)
        if status != 0:
            raise RuntimeError(f"the gang of {GANG_RANKS} exited {status}:\n"
                               f"{stdout[-2000:]}\n{stderr[-4000:]}")
        per_rank = [json.loads((out / f"rank{k}.json").read_text())
                    for k in range(GANG_RANKS)]
    return {t: [[CollectiveRecord.from_dict(d) for d in pr[t]]
                for pr in per_rank] for t in per_rank[0]}


@register_pass("exchange-collectives", "collectives",
               ("CL001", "CL002", "CL003", "CL004"),
               doc="round structure, staging, round bounds and byte table "
                   "of the recorded collectives of every exchange target")
def exchange_pass(ctx: AnalysisContext) -> list:
    findings = []
    for name in live_plans():
        records, plan, rounds = run_target(name, ctx.device)
        findings.extend(check_records(records, f"collectives:{name}",
                                      plan=plan, stats_rounds=rounds))
    return findings


@register_pass("gang-order", "collectives", ("CL005",),
               doc="every rank of a gang of 2 over gloo records the same "
                   "collectives in the same order")
def gang_pass(ctx: AnalysisContext) -> list:
    sequences = run_gang(ctx.device)
    ctx.note(f"collectives: a gang of {GANG_RANKS} ran {len(sequences)} "
             f"targets, {sum(len(r[0]) for r in sequences.values())} "
             f"records a rank")
    return check_gang(sequences)
