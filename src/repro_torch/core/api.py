"""One front door for the port's MalStone drivers.

Counterpart of ``repro/core/api.py:run``. The source is a flat
:class:`EventLog` or a MalGen ``SeedInfo``:

==================== ======== ============================================
engine               source   routed to (required kwargs)
==================== ======== ============================================
oneshot              log      ``malstone_run`` (``malstone_run_partitioned``
                              with ``partitioned=True``)
oneshot/generated    seed     ``malstone_run_generated``
                              (``records_per_shard``)
streaming            log      ``malstone_run_streaming``
streaming            seed     ``malstone_run_streaming`` (``num_chunks``; a
                              seed from ``make_seed_streaming``)
generated_streaming  seed     ``malstone_run_generated_streaming``
                              (``records_per_shard``)
resumable            seed     ``malstone_run_resumable`` (``num_chunks``,
                              ``chunk_records``, ``segment_chunks``;
                              returns a ``ResumeOutcome``)
==================== ======== ============================================
"""

from __future__ import annotations

from typing import Optional

from repro_torch.common.types import EventLog, ExchangePlan

ENGINES = ("oneshot", "streaming", "generated", "generated_streaming",
           "resumable")


def run(source, num_sites: Optional[int] = None, *, nodes: int,
        engine: str = "oneshot", plan: Optional[ExchangePlan] = None,
        cfg=None, partitioned: bool = False, device=None, **kwargs):
    """Run MalStone: route ``source`` x ``engine`` to its driver.

    ``nodes`` stands for the JAX mesh size. A log source needs
    ``num_sites``; a seed source needs ``cfg`` (and ``records_per_shard``
    in ``kwargs``), and ``num_sites`` defaults to ``cfg.num_sites``.
    ``partitioned=True`` routes a log source with engine ``"oneshot"`` to
    ``malstone_run_partitioned``. Other keyword arguments (``statistic``,
    ``backend``, ``return_shuffle_stats``, ...) pass through. Runs on the
    card unless ``device="cpu"``.
    """
    from repro_torch.core import resume, runner

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; have {ENGINES}")
    is_log = isinstance(source, EventLog)
    if is_log and num_sites is None:
        raise ValueError("an EventLog source requires num_sites=")
    if partitioned:
        if not (is_log and engine == "oneshot"):
            raise ValueError(
                "partitioned=True is the oneshot EventLog production "
                "layout; other engines re-assemble the full-site result")
        return runner.malstone_run_partitioned(
            source, num_sites, nodes=nodes, plan=plan, device=device,
            **kwargs)
    if is_log:
        if engine in ("generated", "generated_streaming", "resumable"):
            raise ValueError(
                f"engine {engine!r} regenerates records on device and "
                f"needs a MalGen SeedInfo source, not a materialized "
                f"EventLog (use engine='oneshot' or 'streaming')")
        fn = (runner.malstone_run_streaming if engine == "streaming"
              else runner.malstone_run)
        return fn(source, num_sites, nodes=nodes, plan=plan, device=device,
                  **kwargs)
    if cfg is None:
        raise ValueError("a seed source requires cfg= (the MalGenConfig)")
    if engine == "streaming":
        return runner.malstone_run_streaming(
            source, num_sites or cfg.num_sites, nodes=nodes, plan=plan,
            cfg=cfg, device=device, **kwargs)
    if engine == "resumable":
        return resume.malstone_run_resumable(
            source, cfg, nodes=nodes, num_sites=num_sites, plan=plan,
            device=device, **kwargs)
    fn = (runner.malstone_run_generated_streaming
          if engine == "generated_streaming" else runner.malstone_run_generated)
    return fn(source, cfg, nodes=nodes, num_sites=num_sites, plan=plan,
              device=device, **kwargs)
