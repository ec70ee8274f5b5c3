"""The one general traffic generator: it reads a traffic mix's parameters
(``traffic/<mix>.json``) and drives the program under them.

Two kinds of mix:

- ``batch``: whole MalStone jobs back to back through
  ``repro_torch.core.api.run`` (seed-mode streaming engine). The window
  ends with the last job that started before the window's seconds ran
  out; every job is held equal, bit for bit, to the first.
- ``serve``: one resident ``repro_torch.serve.MalStoneService`` in seed
  mode. Ingest is a closed loop of one step a call, the next enqueued once
  the last one's device work is done; query batches arrive in an open loop
  at ``rate_per_s``, the gaps being a fixed set of exponential quantiles in
  an order drawn from the seed, so every seed offers the same load. A
  batch is submitted when it is due or as soon as the loop comes round
  after that, and timed from its due time to its answers on the host. At
  the end of the log the service is reset and starts the same log again.

Set-up (the seed tables, the program's objects, one warm-up of every shape
the window uses) comes before the window; nothing compiles inside it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from malbench.stats import percentile

CLOCK = time.perf_counter


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(config: dict):
    """(MalGenConfig, ExchangePlan) of a configuration file."""
    from repro_torch.common.types import ExchangePlan
    from repro_torch.malgen import MalGenConfig

    mg = config["malgen"]
    cfg = MalGenConfig(**{k: mg[k] for k in MalGenConfig._fields})
    return cfg, ExchangePlan(**config["plan"])


def make_seed(run):
    """MalGen phase 1 for the configuration's log, on the device: the site
    tables and the entity mark table, drawn from the seed."""
    from repro_torch.malgen import make_seed_streaming

    c = run.config
    cfg, _ = program_config(c)
    return make_seed_streaming(run.seed, cfg, c["nodes"] * c["steps"],
                               c["chunk_records"], device=run.device)


def run_mix(run) -> None:
    """Set up, warm up and drive the window of ``run.traffic``'s kind."""
    kind = run.traffic["kind"]
    if kind == "batch":
        batch(run)
    elif kind == "serve":
        serve(run)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")


def _same_job(a, b) -> bool:
    (ra, sa), (rb, sb) = a, b
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(ra, rb))
    if sa is not None:
        same = same and all(int(x) == int(y) for x, y in zip(sa, sb))
    return same


def batch(run) -> None:
    from repro_torch.core import api

    c = run.config
    cfg, plan = program_config(c)
    seed = make_seed(run)

    def job(steps: int):
        return api.run(seed, nodes=c["nodes"], engine="streaming", cfg=cfg,
                       num_chunks=c["nodes"] * steps,
                       chunk_records=c["chunk_records"],
                       backend=c["backend"], statistic=c["statistic"],
                       plan=plan, num_weeks=c["num_weeks"],
                       return_shuffle_stats=True, device=run.device)

    job(1)             # one step of the window's shapes: every kernel built
    sync(run.device)
    first, jobs, unequal = None, 0, 0
    with run.window() as t0:
        while True:
            with run.span("malbench.job"):
                out = job(c["steps"])
                if first is None:
                    first = out
                    sync(run.device)
                else:
                    unequal += not _same_job(out, first)
            jobs += 1
            if CLOCK() - t0 >= run.seconds:
                break
    run.counters.update(jobs=jobs, jobs_unequal=unequal,
                        records=jobs * c["nodes"] * c["steps"]
                        * c["chunk_records"])
    run.info = {"jobs": jobs}
    run.outputs = first


def arrivals(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of an open loop at
    ``rate_per_s``: the exponential gaps' quantiles ``(i + 0.5) / n``, in
    an order drawn from ``seed``."""
    n = int(math.ceil(rate_per_s * seconds * 1.5)) + 16
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate_per_s
    np.random.default_rng(seed).shuffle(gaps)
    return np.cumsum(gaps)


def query_specs(queries: list):
    from repro_torch.common.types import WindowSpec
    from repro_torch.serve import QuerySpec

    return [QuerySpec(statistic=q["statistic"],
                      window=WindowSpec(*q["window"]),
                      top_k=q.get("top_k", 0), site=q.get("site"))
            for q in queries]


def serve(run) -> None:
    from repro_torch.serve import MalStoneService

    c, t = run.config, run.traffic
    cfg, plan = program_config(c)
    seed = make_seed(run)
    svc = MalStoneService(nodes=c["nodes"], num_sites=cfg.num_sites,
                          chunk_records=c["chunk_records"],
                          backend=c["backend"], num_weeks=c["num_weeks"],
                          seed=seed, cfg=cfg,
                          num_chunks=c["nodes"] * c["steps"], plan=plan,
                          device=run.device)
    specs = query_specs(t["queries"])
    svc.ingest_chunks(1)          # warm-up: an ingest step, a snapshot and
    svc.wait(svc.submit(specs))   # a query batch of the window's shapes
    svc.reset()
    sync(run.device)

    due = arrivals(t["rate_per_s"], run.seconds, run.seed)
    rng = np.random.default_rng(run.seed + 1)
    expected = int(t["rate_per_s"] * run.seconds)
    keep = set(rng.choice(max(expected, 1), size=min(t["kept_batches"],
                                                     max(expected, 1)),
                          replace=False).tolist())
    cuda = run.device.type == "cuda"
    latency, submit_s, lag, kept = [], [], [], []
    last = None
    steps = resets = nxt = 0
    ingest_done = None
    with run.window() as t0:
        t_end = t0 + run.seconds
        due_abs = t0 + due
        while True:
            now = CLOCK()
            while (nxt < len(due_abs) and due_abs[nxt] <= now
                   and due_abs[nxt] < t_end):
                folded = svc.chunks_folded
                with run.span("malbench.query.submit"):
                    s0 = CLOCK()
                    ticket = svc.submit(specs)
                    s1 = CLOCK()
                with run.span("malbench.query.wait"):
                    answers = svc.wait(ticket)
                now = CLOCK()
                latency.append(now - due_abs[nxt])
                submit_s.append(s1 - s0)
                lag.append(s0 - due_abs[nxt])
                last = (nxt, folded, answers)
                if nxt in keep:
                    kept.append(last)
                nxt += 1
            if now >= t_end and (nxt >= len(due_abs)
                                 or due_abs[nxt] >= t_end):
                break
            if ingest_done is None or ingest_done.query():
                with run.span("malbench.ingest"):
                    if svc.chunks_folded == c["steps"]:
                        svc.reset()
                        resets += 1
                    svc.ingest_chunks(1)
                steps += 1
                if cuda:
                    ingest_done = torch.cuda.Event()
                    ingest_done.record()
        sync(run.device)
    if last is not None and all(k[0] != last[0] for k in kept):
        kept.append(last)
    run.counters.update(
        steps=steps, resets=resets, batches=nxt,
        batches_due=int(np.sum(due < run.seconds)),
        records=steps * c["nodes"] * c["chunk_records"],
        latency_s=latency, submit_s=submit_s, lag_s=lag)
    quarter = max(1, len(lag) // 4)
    run.info = {"steps": steps, "resets": resets, "batches": nxt,
                "query_ms": {f"p{q}": 1e3 * percentile(latency, q)
                             for q in (50, 90, 95, 99)} if latency else {},
                "lag_ms": {"first_quarter_p50": 1e3 * percentile(
                    lag[:quarter], 50), "last_quarter_p50": 1e3 * percentile(
                    lag[-quarter:], 50)} if lag else {}}
    run.outputs = kept
