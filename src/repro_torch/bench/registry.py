"""Scenario registry of the port: every timed unit, named and enumerable.

Counterpart of ``repro/bench/registry.py``, under the same scenario names
and the same ``params``, so one name gives a row from each package and
``repro_torch.bench.compare`` diffs the two documents scenario by
scenario. The registry covers:

- the **MalStone grid** — backend {streams, sphere, mapreduce,
  mapreduce_combiner} x statistic {A, B, B-fixed} x engine {one-shot,
  streaming}: ``malstone_{a|b|bfixed}_{backend}_{oneshot|streaming}``;
- the **lossless shuffle sweep** ``mapreduce_lossless_cf{0p25,0p5,1,2}``
  and ``mapreduce_lossless_streaming_cf0p5`` (the 4-column exchange),
  with its word-exchange twins ``mapreduce_packed_cf{0p5,1}`` (sort) and
  ``mapreduce_counting_cf{0p5,1}`` (counting sort), each recording the
  shuffle accounting in ``derived``;
- the **kernel pairs** ``kernel_{segment_hist,windowed_ratio,
  powerlaw_sample}_{pallas,jnp}``: a ``_pallas`` row runs the
  hand-written kernel (K4, K7, K6; its plain version on the CPU), a
  ``_jnp`` row its plain PyTorch version;
- the **MalGen phases** ``malgen_seed``, ``malgen_generate``,
  ``malgen_encode``, ``malgen_generate_host_sharded`` (the host loop,
  every shard regenerating the marked stream, concatenated) and
  ``malgen_generate_device`` (every node's shard in one call);
- the **end-to-end rows** ``e2e_fused_{oneshot,streaming}`` and
  ``e2e_materialized_oneshot``;
- the **sweeps** ``sweep_records_x{1,2,4}``, ``sweep_mesh_p{1,2,4}`` and
  ``sweep_gen_device_p{1,2,4}``;
- **serving** — ``serving_ingest_latency``, ``serving_query_batch``
  (p50/p95/p99 in ``derived``) and ``serving_sustained_qps``;
- the **overlap pair** ``streaming_overlap_{on,off}``: the double-buffered
  per-chunk runner (``core/overlap.py``) against the same calls
  serialised, in one interleaved measurement;
- **resume** — ``resume_overhead_{nockpt,ckpt,resume}`` (the segmented
  run of ``core/resume.py`` without checkpoints, with one a segment, and
  restoring a complete one) and ``faulty_run_{transient,badhost}`` (the
  same run under a seeded fault schedule, with retry and NodeDoctor
  rerouting over 4 hosts).

- the **multi-process sweep** ``sweep_multiproc_p{1,2,4}``: the launcher
  as a gang of P processes over gloo (``launch/coordinator.py``), one node
  each.

The P nodes are a leading axis on one device, so a mesh sweep runs at any
node count (the JAX package skips sizes above its device count). Random
streams that JAX derives from ``jax.random.key(k)`` come from the port's
integer ``rng_seed=k``: the same seed gives other records than JAX.

``SCENARIOS[name].run(scale, ctx)`` times one scenario under
``repro_torch.bench.timing`` and returns a ``ScenarioResult`` for
``repro_torch.bench.schema.add_result``. A ``BenchContext`` caches logs,
seeds and services, so a sweep generates its data once per shape.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.bench.timing import TimingResult, time_callable
from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import EventLog

BACKENDS = ("streams", "sphere", "mapreduce", "mapreduce_combiner")
STATISTICS = ("A", "B", "B-fixed")
ENGINES = ("oneshot", "streaming")
KERNELS = ("segment_hist", "windowed_ratio", "powerlaw_sample")
KERNEL_PATHS = ("pallas", "jnp")

_STAT_SLUG = {"A": "a", "B": "b", "B-fixed": "bfixed"}


@dataclasses.dataclass(frozen=True)
class Scale:
    """One preset's knob settings; every scenario runs at one."""

    records_per_node: int
    num_sites: int
    num_entities: int
    chunk_records: int        # streaming-engine chunk size
    warmup: int
    iters: int
    marked_event_fraction: float = 0.2

    def as_params(self) -> dict:
        return dataclasses.asdict(self)


PRESETS: Dict[str, Scale] = {
    # the JAX package's numbers: every backend and both engines at a size
    # a CPU runs in minutes
    "smoke": Scale(records_per_node=8_192, num_sites=512,
                   num_entities=4_096, chunk_records=2_048,
                   warmup=1, iters=3),
    "full": Scale(records_per_node=262_144, num_sites=2_048,
                  num_entities=16_384, chunk_records=65_536,
                  warmup=2, iters=3),
}


@dataclasses.dataclass
class ScenarioResult:
    timing: TimingResult
    records: Optional[int] = None
    derived: Optional[dict] = None
    # the run's parameters where they differ from the Scale's (sweeps
    # override nodes / records_per_node), merged last into the params
    effective: Optional[dict] = None


class BenchContext:
    """Per-process cache of logs, seeds and services keyed by shape; the
    ``nodes`` of a run and its device (the card unless ``device="cpu"``)."""

    def __init__(self, nodes: int = 2, device=None):
        if nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {nodes}")
        self.nodes = nodes
        self.device = resolve_device(device)
        self._logs: dict = {}
        self._seeds: dict = {}
        self._services: dict = {}
        self._overlap: dict = {}
        self._overlap_timings: dict = {}

    def cfg(self, scale: Scale):
        from repro_torch.malgen import MalGenConfig
        return MalGenConfig(
            num_sites=scale.num_sites, num_entities=scale.num_entities,
            marked_event_fraction=scale.marked_event_fraction)

    def log(self, scale: Scale, nodes: Optional[int] = None,
            records_per_node: Optional[int] = None) -> EventLog:
        """The flat node-major log of ``nodes`` shards (``rng_seed=1``)."""
        from repro_torch.malgen import generate_shards_device, make_seed
        nodes = nodes or self.nodes
        rpn = records_per_node or scale.records_per_node
        key = (nodes, rpn, scale.num_sites, scale.num_entities,
               scale.marked_event_fraction)
        if key not in self._logs:
            cfg = self.cfg(scale)
            seed = make_seed(1, cfg, nodes * rpn, device=self.device)
            self._logs[key] = generate_shards_device(
                seed, cfg, nodes, rpn, device=self.device).map(
                lambda c: c.reshape(-1))
        return self._logs[key]

    def seed(self, scale: Scale, nodes: Optional[int] = None):
        """(streaming seed, num_chunks): ``records_per_node //
        chunk_records`` chunks a node (at least one), ``rng_seed=4``."""
        from repro_torch.malgen import make_seed_streaming
        nodes = nodes or self.nodes
        num_chunks = nodes * max(
            1, scale.records_per_node // scale.chunk_records)
        key = (num_chunks, scale.chunk_records, scale.num_sites,
               scale.num_entities, scale.marked_event_fraction)
        if key not in self._seeds:
            self._seeds[key] = (make_seed_streaming(
                4, self.cfg(scale), num_chunks, scale.chunk_records,
                device=self.device), num_chunks)
        return self._seeds[key]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, individually runnable benchmark unit."""

    name: str
    group: str
    params: dict              # the grid point (static descriptors)
    runner: Callable[[Scale, BenchContext], ScenarioResult]

    def run(self, scale: Scale, ctx: BenchContext) -> ScenarioResult:
        return self.runner(scale, ctx)


SCENARIOS: Dict[str, Scenario] = {}


class ScenarioSkip(RuntimeError):
    """Raised by a scenario that cannot run in this environment."""


def _register(name: str, group: str, params: dict):
    def deco(fn):
        if name in SCENARIOS:
            raise ValueError(f"duplicate scenario {name!r}")
        SCENARIOS[name] = Scenario(name=name, group=group, params=params,
                                   runner=fn)
        return fn
    return deco


def _concat_logs(logs) -> EventLog:
    return EventLog(*[None if cols[0] is None else torch.cat(cols)
                      for cols in zip(*logs)])


# --------------------------------------------------------------- MalStone grid
def _run_malstone(scale: Scale, ctx: BenchContext, *, backend: str,
                  statistic: str, engine: str,
                  nodes: Optional[int] = None,
                  records_per_node: Optional[int] = None,
                  capacity_factor: float = 2.0,
                  packed: Optional[bool] = None,
                  impl: Optional[str] = None,
                  collect_shuffle_stats: bool = False) -> ScenarioResult:
    """One timed grid point through ``repro_torch.core.run``. ``impl``
    names the exchange; the ``packed`` tri-state maps onto it (True ->
    sort, False -> columns, None -> auto). With ``collect_shuffle_stats``
    the shuffle accounting lands in ``derived``."""
    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import run
    nodes = nodes or ctx.nodes
    rpn = records_per_node or scale.records_per_node
    cfg = ctx.cfg(scale)
    total = nodes * rpn
    if impl is None:
        impl = {True: "sort", False: "columns", None: "auto"}[packed]
    common = dict(nodes=nodes, statistic=statistic, backend=backend,
                  plan=ExchangePlan(impl=impl,
                                    capacity_factor=capacity_factor),
                  device=ctx.device,
                  return_shuffle_stats=collect_shuffle_stats)

    def shape_out(out):
        return (out[0].rho, out[1]) if collect_shuffle_stats else out.rho

    if engine == "oneshot":
        args = (ctx.log(scale, nodes, rpn),)

        def fn(log):
            return shape_out(run(log, cfg.num_sites, **common))
    elif engine == "streaming":
        seed, num_chunks = ctx.seed(scale, nodes)
        args = (seed,)

        def fn(seed):
            return shape_out(run(
                seed, cfg.num_sites, engine="streaming", cfg=cfg,
                chunk_records=scale.chunk_records, num_chunks=num_chunks,
                **common))
        total = num_chunks * scale.chunk_records
    else:
        raise ValueError(f"unknown engine {engine!r}")

    timing, out = time_callable(fn, *args, warmup=scale.warmup,
                                iters=scale.iters)
    derived = None
    if collect_shuffle_stats:
        stats = out[1]
        derived = {"capacity_factor": capacity_factor,
                   "shuffle_rounds": int(stats.rounds),
                   "shuffle_capacity": int(stats.capacity),
                   "shuffle_deferred": int(stats.residual),
                   "shuffle_overflow": int(stats.overflow),
                   "shuffle_bytes_exchanged": int(stats.bytes_exchanged)}
    return ScenarioResult(timing=timing, records=total, derived=derived,
                          effective={"nodes": nodes,
                                     "records_per_node": rpn})


for _stat in STATISTICS:
    for _backend in BACKENDS:
        for _engine in ENGINES:
            _name = f"malstone_{_STAT_SLUG[_stat]}_{_backend}_{_engine}"

            @_register(_name, "malstone",
                       {"backend": _backend, "statistic": _stat,
                        "engine": _engine, "kernel_path": "jnp"})
            def _scenario(scale, ctx, *, _b=_backend, _s=_stat, _e=_engine):
                return _run_malstone(scale, ctx, backend=_b, statistic=_s,
                                     engine=_e)


# ------------------------------------------------- lossless shuffle sweep
# The mapreduce shuffle delivers every record at any capacity factor by
# re-exchanging bucket overflow in extra rounds; each point times MalStone
# B at one factor and records the rounds, the deferred and undelivered
# counts and the bytes shipped.
LOSSLESS_CAPACITY_FACTORS = (0.25, 0.5, 1.0, 2.0)
PACKED_CAPACITY_FACTORS = (0.5, 1.0)
COUNTING_CAPACITY_FACTORS = (0.5, 1.0)


def _cf_slug(cf: float) -> str:
    return f"cf{cf:g}".replace(".", "p")     # 0.25 -> cf0p25, 2.0 -> cf2


def _run_mapreduce_lossless(scale: Scale, ctx: BenchContext, *, cf: float,
                            engine: str = "oneshot", packed: bool = False,
                            impl: Optional[str] = None) -> ScenarioResult:
    """One shuffle-sweep point with an explicit exchange (never auto);
    refuses to record a shuffle that left records undelivered."""
    from repro_torch.core.backends import ShuffleExhaustedError
    res = _run_malstone(scale, ctx, backend="mapreduce", statistic="B",
                        engine=engine, capacity_factor=cf, packed=packed,
                        impl=impl, collect_shuffle_stats=True)
    res.derived["shuffle_impl"] = impl or ("sort" if packed else "columns")
    res.derived["shuffle_packed"] = res.derived["shuffle_impl"] != "columns"
    overflow = res.derived["shuffle_overflow"]
    if overflow != 0:
        raise ShuffleExhaustedError(
            f"mapreduce_lossless cf={cf} ({engine}) finished with "
            f"{overflow} undelivered records")
    return res


for _cf in LOSSLESS_CAPACITY_FACTORS:
    @_register(f"mapreduce_lossless_{_cf_slug(_cf)}", "lossless",
               {"backend": "mapreduce", "statistic": "B",
                "engine": "oneshot", "capacity_factor": _cf,
                "packed": False})
    def _scenario_lossless(scale, ctx, *, _c=_cf):
        return _run_mapreduce_lossless(scale, ctx, cf=_c)


@_register("mapreduce_lossless_streaming_cf0p5", "lossless",
           {"backend": "mapreduce", "statistic": "B",
            "engine": "streaming", "capacity_factor": 0.5,
            "packed": False})
def _scenario_lossless_streaming(scale, ctx):
    return _run_mapreduce_lossless(scale, ctx, cf=0.5, engine="streaming")


for _cf in PACKED_CAPACITY_FACTORS:
    @_register(f"mapreduce_packed_{_cf_slug(_cf)}", "lossless",
               {"backend": "mapreduce", "statistic": "B",
                "engine": "oneshot", "capacity_factor": _cf,
                "packed": True})
    def _scenario_packed(scale, ctx, *, _c=_cf):
        return _run_mapreduce_lossless(scale, ctx, cf=_c, packed=True)


for _cf in COUNTING_CAPACITY_FACTORS:
    @_register(f"mapreduce_counting_{_cf_slug(_cf)}", "lossless",
               {"backend": "mapreduce", "statistic": "B",
                "engine": "oneshot", "capacity_factor": _cf,
                "packed": True, "exchange_impl": "counting"})
    def _scenario_counting(scale, ctx, *, _c=_cf):
        return _run_mapreduce_lossless(scale, ctx, cf=_c, impl="counting")


# ------------------------------------------------------------- kernel paths
def _kernel_inputs(scale: Scale, kernel: str, device) -> tuple:
    """The kernel's inputs on ``device``. segment_hist and windowed_ratio
    draw JAX's numbers (``np.random.default_rng(0)``); the segment_hist
    columns are one node's ``[1, n]`` rows. powerlaw_sample draws ``u``
    from a ``torch.Generator`` seeded 2 (JAX: ``jax.random.key(2)``)."""
    rng = np.random.default_rng(0)
    n = scale.records_per_node
    s = scale.num_sites
    if kernel == "segment_hist":
        cols = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32))
                .to(device).reshape(1, n) for hi in (s, 52, 2)]
        return (*cols, torch.ones(1, n, dtype=torch.bool, device=device))
    if kernel == "windowed_ratio":
        hist = np.stack([rng.integers(0, 50, (s, 52))] * 2, -1)
        return (torch.from_numpy(hist.astype(np.int32)).to(device),)
    if kernel == "powerlaw_sample":
        from repro_torch.malgen import power_law_cdf, power_law_weights
        cdf = power_law_cdf(power_law_weights(s, device=device))
        g = torch.Generator(device=device).manual_seed(2)
        return torch.rand(n, generator=g, device=device), cdf
    raise ValueError(f"unknown kernel {kernel!r}")


def kernel_fns(kernel: str, scale: Scale):
    """(the kernel's wrapper, its plain version), each taking
    ``_kernel_inputs``' tuple."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.kernels.segment_hist import ops as sh
    from repro_torch.kernels.windowed_ratio import ops as wr
    if kernel == "segment_hist":
        return (functools.partial(sh.segment_hist,
                                  num_sites=scale.num_sites),
                functools.partial(sh.segment_hist_plain,
                                  num_sites=scale.num_sites))
    if kernel == "windowed_ratio":
        return wr.windowed_ratio, wr.windowed_ratio_plain
    if kernel == "powerlaw_sample":
        return ps.powerlaw_sample, ps.powerlaw_sample_plain
    raise ValueError(f"unknown kernel {kernel!r}")


def _run_kernel(scale: Scale, ctx: BenchContext, *, kernel: str,
                path: str) -> ScenarioResult:
    args = _kernel_inputs(scale, kernel, ctx.device)
    fn = kernel_fns(kernel, scale)[KERNEL_PATHS.index(path)]
    work = scale.num_sites if kernel == "windowed_ratio" \
        else scale.records_per_node
    timing, _ = time_callable(fn, *args, warmup=scale.warmup,
                              iters=scale.iters)
    return ScenarioResult(timing=timing, records=work)


for _kernel in KERNELS:
    for _path in KERNEL_PATHS:
        @_register(f"kernel_{_kernel}_{_path}", "kernel",
                   {"kernel": _kernel, "kernel_path": _path})
        def _scenario_k(scale, ctx, *, _k=_kernel, _p=_path):
            return _run_kernel(scale, ctx, kernel=_k, path=_p)


# ------------------------------------------------------------ MalGen phases
@_register("malgen_seed", "malgen", {"phase": "seed"})
def _malgen_seed(scale: Scale, ctx: BenchContext) -> ScenarioResult:
    from repro_torch.malgen import make_seed
    cfg = ctx.cfg(scale)
    timing, seed = time_callable(
        lambda: make_seed(0, cfg, scale.records_per_node,
                          device=ctx.device),
        warmup=scale.warmup, iters=scale.iters)
    # phase 1's work unit is entities, not records
    eps = scale.num_entities / (timing.us_per_call / 1e6)
    return ScenarioResult(
        timing=timing,
        derived={"entities_per_s": round(eps, 1),
                 "seed_bytes": int(seed.seed_bytes)})


@_register("malgen_generate", "malgen", {"phase": "generate"})
def _malgen_generate(scale: Scale, ctx: BenchContext) -> ScenarioResult:
    from repro_torch.malgen import generate_shard, make_seed
    cfg = ctx.cfg(scale)
    seed = make_seed(0, cfg, scale.records_per_node, device=ctx.device)
    shard_records = max(1, scale.records_per_node // 8)
    timing, _ = time_callable(
        lambda: generate_shard(seed, cfg, 0, 8, shard_records),
        warmup=scale.warmup, iters=scale.iters)
    return ScenarioResult(timing=timing, records=shard_records)


@_register("malgen_encode", "malgen", {"phase": "encode"})
def _malgen_encode(scale: Scale, ctx: BenchContext) -> ScenarioResult:
    from repro_torch.malgen import encode_records
    log = ctx.log(scale)
    n = min(16_384, scale.records_per_node)
    sl = log.map(lambda c: c[:n].cpu().numpy())
    timing, blob = time_callable(
        lambda: encode_records(sl.event_seq, sl.shard_hash, sl.timestamp,
                               sl.site_id, sl.entity_id, sl.mark),
        warmup=1, iters=max(1, scale.iters - 1))
    return ScenarioResult(timing=timing, records=n,
                          derived={"blob_bytes": len(blob)})


# The host loop against generation in place: the same record budget made
# shard by shard (each regenerating the global marked stream) and
# concatenated, or every node's shard in one call; seeding excluded.
def _malgen_oneshot_seed(scale: Scale, ctx: BenchContext, nodes: int):
    from repro_torch.malgen import make_seed
    return make_seed(3, ctx.cfg(scale), nodes * scale.records_per_node,
                     device=ctx.device)


def _host_sharded_log(seed, cfg, nodes: int, rpn: int) -> EventLog:
    from repro_torch.malgen import generate_shard
    return _concat_logs([generate_shard(seed, cfg, s, nodes, rpn)
                         for s in range(nodes)])


@_register("malgen_generate_host_sharded", "malgen",
           {"phase": "generate", "malgen_path": "host"})
def _malgen_generate_host_sharded(scale: Scale,
                                  ctx: BenchContext) -> ScenarioResult:
    cfg = ctx.cfg(scale)
    nodes = ctx.nodes
    seed = _malgen_oneshot_seed(scale, ctx, nodes)
    timing, _ = time_callable(
        lambda: _host_sharded_log(seed, cfg, nodes, scale.records_per_node),
        warmup=1, iters=scale.iters, max_warmup=1)
    return ScenarioResult(timing=timing,
                          records=nodes * scale.records_per_node,
                          effective={"nodes": nodes})


@_register("malgen_generate_device", "malgen",
           {"phase": "generate", "malgen_path": "device"})
def _malgen_generate_device(scale: Scale,
                            ctx: BenchContext) -> ScenarioResult:
    from repro_torch.malgen import generate_shards_device
    cfg = ctx.cfg(scale)
    nodes = ctx.nodes
    rpn = scale.records_per_node
    seed = _malgen_oneshot_seed(scale, ctx, nodes)
    timing, _ = time_callable(
        lambda: generate_shards_device(seed, cfg, nodes, rpn,
                                       device=ctx.device),
        warmup=scale.warmup, iters=scale.iters)
    return ScenarioResult(timing=timing, records=nodes * rpn,
                          effective={"nodes": nodes})


def _run_e2e(scale: Scale, ctx: BenchContext, *, generation: str,
             engine: str = "oneshot",
             nodes: Optional[int] = None) -> ScenarioResult:
    """End-to-end MalStone B (sphere): generation + statistic per call,
    seeding outside the timing. ``"fused"`` generates every node's shard
    in place and runs on it; ``"materialized"`` is the host shard loop,
    the concatenation and ``malstone_run``."""
    from repro_torch.core import malstone_run, run
    cfg = ctx.cfg(scale)
    nodes = nodes or ctx.nodes
    rpn = scale.records_per_node
    seed = _malgen_oneshot_seed(scale, ctx, nodes)
    common = dict(statistic="B", backend="sphere", device=ctx.device)

    if generation == "fused":
        extra = ({} if engine == "oneshot"
                 else {"chunk_records": scale.chunk_records})
        engine_name = ("generated" if engine == "oneshot"
                       else "generated_streaming")
        timing, _ = time_callable(
            lambda: run(seed, engine=engine_name, nodes=nodes, cfg=cfg,
                        records_per_shard=rpn, **extra, **common).rho,
            warmup=scale.warmup, iters=scale.iters)
    else:
        def materialized():
            log = _host_sharded_log(seed, cfg, nodes, rpn)
            return malstone_run(log, cfg.num_sites, nodes=nodes,
                                **common).rho

        timing, _ = time_callable(materialized, warmup=1, iters=scale.iters,
                                  max_warmup=1)
    return ScenarioResult(timing=timing, records=nodes * rpn,
                          effective={"nodes": nodes})


@_register("e2e_fused_oneshot", "e2e",
           {"backend": "sphere", "statistic": "B", "engine": "oneshot",
            "generation": "fused"})
def _e2e_fused_oneshot(scale, ctx):
    return _run_e2e(scale, ctx, generation="fused", engine="oneshot")


@_register("e2e_fused_streaming", "e2e",
           {"backend": "sphere", "statistic": "B", "engine": "streaming",
            "generation": "fused"})
def _e2e_fused_streaming(scale, ctx):
    return _run_e2e(scale, ctx, generation="fused", engine="streaming")


@_register("e2e_materialized_oneshot", "e2e",
           {"backend": "sphere", "statistic": "B", "engine": "oneshot",
            "generation": "materialized"})
def _e2e_materialized_oneshot(scale, ctx):
    return _run_e2e(scale, ctx, generation="materialized")


# ----------------------------------------------------------- scaling sweeps
SWEEP_RECORD_MULTIPLIERS = (1, 2, 4)
SWEEP_MESH_SIZES = (1, 2, 4)

for _mult in SWEEP_RECORD_MULTIPLIERS:
    @_register(f"sweep_records_x{_mult}", "sweep",
               {"sweep": "records_per_node", "multiplier": _mult,
                "backend": "sphere", "statistic": "B", "engine": "oneshot"})
    def _sweep_records(scale, ctx, *, _m=_mult):
        return _run_malstone(
            scale, ctx, backend="sphere", statistic="B", engine="oneshot",
            records_per_node=scale.records_per_node * _m)

for _p in SWEEP_MESH_SIZES:
    @_register(f"sweep_mesh_p{_p}", "sweep",
               {"sweep": "mesh_size", "nodes": _p, "backend": "sphere",
                "statistic": "B", "engine": "oneshot"})
    def _sweep_mesh(scale, ctx, *, _p=_p):
        return _run_malstone(scale, ctx, backend="sphere", statistic="B",
                             engine="oneshot", nodes=_p)

for _p in SWEEP_MESH_SIZES:
    @_register(f"sweep_gen_device_p{_p}", "sweep",
               {"sweep": "gen_device_mesh", "nodes": _p,
                "backend": "sphere", "statistic": "B", "engine": "oneshot",
                "generation": "fused"})
    def _sweep_gen_device(scale, ctx, *, _p=_p):
        return _run_e2e(scale, ctx, generation="fused", nodes=_p)


# --------------------------------------------------------- overlap pipeline
# The double-buffered per-chunk runner (repro_torch.core.overlap) against
# the same calls serialised. The pair uses many small chunks (the preset's
# chunk size cut to OVERLAP_CHUNK_RECORDS), as the JAX package's does: what
# overlap hides is per-chunk host work (launches, the shuffle's per-round
# count reads) behind device work in flight, so it grows with the chunk
# count. Equality of the two rows is held by tests, not here.
OVERLAP_CHUNK_RECORDS = 64


def _overlap_runner(scale: Scale, ctx: BenchContext):
    from repro_torch.core.overlap import OverlapStreamingRunner
    from repro_torch.malgen import make_seed_streaming
    chunk = min(OVERLAP_CHUNK_RECORDS, scale.chunk_records)
    cpd = max(1, scale.records_per_node // chunk)
    num_chunks = ctx.nodes * cpd
    key = (ctx.nodes, num_chunks, chunk, scale.num_sites,
           scale.num_entities, scale.marked_event_fraction)
    if key not in ctx._overlap:
        seed = make_seed_streaming(6, ctx.cfg(scale), num_chunks, chunk,
                                   device=ctx.device)
        runner = OverlapStreamingRunner(
            seed, ctx.cfg(scale), nodes=ctx.nodes, num_chunks=num_chunks,
            chunk_records=chunk, backend="mapreduce", device=ctx.device)
        ctx._overlap[key] = (runner, chunk, num_chunks)
    return ctx._overlap[key]


def _overlap_timings(scale: Scale, ctx: BenchContext):
    """One interleaved on/off measurement shared by both rows: alternating
    the two per iteration keeps drift in the machine's load out of their
    difference, which is what the pair measures."""
    import time

    from repro_torch.bench.timing import synchronize, timing_from_samples
    key = (ctx.nodes, scale.records_per_node, scale.num_entities,
           scale.marked_event_fraction)
    if key not in ctx._overlap_timings:
        runner, chunk, num_chunks = _overlap_runner(scale, ctx)
        samples = {True: [], False: []}
        stats = {}
        for ov in (True, False):            # build and warm both paths
            runner.run_result("B", overlap=ov)
        for i in range(max(scale.iters * 5, 15)):
            # alternate which path goes first so the order's bias cancels
            for ov in (True, False) if i % 2 == 0 else (False, True):
                synchronize()
                t0 = time.perf_counter()
                _, stats[ov] = runner.run_result("B", overlap=ov)
                synchronize()
                samples[ov].append((time.perf_counter() - t0) * 1e6)
        ctx._overlap_timings[key] = {
            ov: (timing_from_samples(samples[ov], warmup_iters=1,
                                     steady=True),
                 stats[ov], chunk, num_chunks)
            for ov in (True, False)}
    return ctx._overlap_timings[key]


for _ov in (True, False):
    @_register(f"streaming_overlap_{'on' if _ov else 'off'}", "overlap",
               {"backend": "mapreduce", "statistic": "B",
                "engine": "streaming", "overlap": "on" if _ov else "off"})
    def _scenario_overlap(scale, ctx, *, _o=_ov):
        # both rows share one cached runner and one interleaved
        # measurement: the schedule is the only variable
        timing, stats, chunk, num_chunks = _overlap_timings(scale, ctx)[_o]
        return ScenarioResult(
            timing=timing, records=num_chunks * chunk,
            derived={"overlap": _o, "num_chunks": num_chunks,
                     "shuffle_rounds": int(stats.rounds),
                     "shuffle_overflow": int(stats.overflow),
                     "shuffle_bytes_exchanged": int(stats.bytes_exchanged)},
            effective={"nodes": ctx.nodes, "chunk_records": chunk})


# ------------------------------------------------------- multi-process sweep
# Each point runs the port's launcher as a P-process localhost gang over
# gloo (one node a process, streaming mapreduce, statistic B, on the
# context's device) and adopts the samples and shuffle accounting of the
# BENCH document the gang's rank 0 writes; P=1 is the same launcher in one
# process, the curve's baseline. On one card the ranks share it and the
# exchange crosses the host, so the curve measures coordination overhead,
# not speedup (as the JAX package's does on its one-core CI hosts).
SWEEP_MULTIPROC_SIZES = (1, 2, 4)


def _run_multiproc(scale: Scale, ctx: BenchContext, *,
                   procs: int) -> ScenarioResult:
    import os
    import pathlib
    import sys
    import tempfile

    from repro_torch.bench import schema
    from repro_torch.bench.timing import timing_from_samples
    from repro_torch.launch import coordinator

    src_root = str(pathlib.Path(__file__).resolve().parents[2])
    chunks = max(1, scale.records_per_node // scale.chunk_records)
    sub_env = dict(os.environ)
    sub_env["PYTHONPATH"] = (src_root + os.pathsep
                             + sub_env.get("PYTHONPATH", ""))
    # as the JAX package's sweep does: no device forcing leaks into the gang
    sub_env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory(prefix="bench_multiproc_") as tmp:
        out = os.path.join(tmp, f"BENCH_multiproc_p{procs}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.malstone",
               "--nodes", str(procs), "--num-processes", str(procs),
               "--records-per-node", str(scale.records_per_node),
               "--sites", str(scale.num_sites),
               "--entities", str(scale.num_entities),
               "--stream-chunks", str(chunks),
               "--backend", "mapreduce", "--statistic", "B",
               "--runs", str(scale.iters), "--bench-json", out,
               "--device", ctx.device.type]
        rc, out_text, err_text = coordinator.run_in_session(
            cmd, env=sub_env, timeout=1800)
        if rc != 0:
            raise RuntimeError(
                f"sweep_multiproc_p{procs} gang failed ({rc}):\n"
                f"{out_text[-2000:]}\n{err_text[-2000:]}")
        res = schema.load_document(out)["results"][0]
    timing = timing_from_samples(res["samples_us"], warmup_iters=1)
    derived = dict(res.get("derived") or {})
    derived["num_processes"] = procs
    return ScenarioResult(
        timing=timing, records=procs * scale.records_per_node,
        derived=derived,
        effective={"nodes": procs, "num_processes": procs})


for _p in SWEEP_MULTIPROC_SIZES:
    @_register(f"sweep_multiproc_p{_p}", "sweep",
               {"sweep": "multiproc", "nodes": _p, "num_processes": _p,
                "backend": "mapreduce", "statistic": "B",
                "engine": "streaming"})
    def _sweep_multiproc(scale, ctx, *, _p=_p):
        return _run_multiproc(scale, ctx, procs=_p)


# ------------------------------------------------------------------ resume
# The checkpoint tax and fault recovery over repro_torch.core.resume, one
# runner a scenario, over the context's streaming seed.
def _resume_runner(scale: Scale, ctx: BenchContext, *,
                   backend: str = "streams", segment_chunks: int = 1):
    from repro_torch.core.resume import ResumableRunner
    seed, num_chunks = ctx.seed(scale)
    runner = ResumableRunner(
        seed, ctx.cfg(scale), nodes=ctx.nodes, num_chunks=num_chunks,
        chunk_records=scale.chunk_records, segment_chunks=segment_chunks,
        backend=backend, statistic="B", device=ctx.device)
    return runner, num_chunks * scale.chunk_records


def _resume_scenario_result(timing, out, records: int) -> ScenarioResult:
    return ScenarioResult(timing=timing, records=records,
                          derived=out.report.to_derived())


def _time_resumable(scale: Scale, runner, records: int,
                    **run_kw) -> ScenarioResult:
    last = []

    def fn():
        out = runner.run(**run_kw)
        last[:] = [out]
        return out.result.rho

    timing, _ = time_callable(fn, warmup=scale.warmup, iters=scale.iters)
    return _resume_scenario_result(timing, last[0], records)


@_register("resume_overhead_nockpt", "resume",
           {"backend": "streams", "engine": "resumable",
            "checkpoint": "off", "segment_chunks": 1})
def _resume_overhead_nockpt(scale: Scale, ctx: BenchContext):
    """The segmented loop without checkpoint IO: the segmentation's cost
    over ``malstone_b_streams_streaming``."""
    runner, records = _resume_runner(scale, ctx)
    return _time_resumable(scale, runner, records)


@_register("resume_overhead_ckpt", "resume",
           {"backend": "streams", "engine": "resumable",
            "checkpoint": "fresh", "segment_chunks": 1})
def _resume_overhead_ckpt(scale: Scale, ctx: BenchContext):
    """Plus a checkpoint written after every segment, into a fresh
    directory a call, so that every sample computes and saves."""
    import itertools
    import pathlib
    import shutil
    import tempfile

    runner, records = _resume_runner(scale, ctx)
    root = tempfile.mkdtemp(prefix="bench_resume_ckpt_")
    counter = itertools.count()
    last = []

    def fn():
        d = pathlib.Path(root) / f"call{next(counter)}"
        out = runner.run(checkpoint_dir=str(d), resume=False)
        last[:] = [out]
        return out.result.rho

    try:
        timing, _ = time_callable(fn, warmup=scale.warmup, iters=scale.iters)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return _resume_scenario_result(timing, last[0], records)


@_register("resume_overhead_resume", "resume",
           {"backend": "streams", "engine": "resumable",
            "checkpoint": "restore", "segment_chunks": 1})
def _resume_overhead_resume(scale: Scale, ctx: BenchContext):
    """The floor of recovery: restore a complete checkpoint and finalize,
    with no chunk regenerated."""
    import shutil
    import tempfile

    runner, records = _resume_runner(scale, ctx)
    root = tempfile.mkdtemp(prefix="bench_resume_restore_")
    try:
        runner.run(checkpoint_dir=root, resume=False)  # populate
        return _time_resumable(scale, runner, records, checkpoint_dir=root,
                               resume=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run_faulty(scale: Scale, ctx: BenchContext, *, plan,
                num_hosts: int = 4) -> ScenarioResult:
    """A fault schedule is a pure function of (plan seed, segment, shard,
    host, attempt): every timed call replays the same faults."""
    from repro_torch.faults import RetryPolicy
    runner, records = _resume_runner(scale, ctx)
    return _time_resumable(
        scale, runner, records, faults=plan,
        retry=RetryPolicy(max_attempts=6, backoff_s=0.0),
        num_hosts=num_hosts)


@_register("faulty_run_transient", "resume",
           {"backend": "streams", "engine": "resumable", "faults":
            "transient_rate=0.25,seed=11", "num_hosts": 4})
def _faulty_run_transient(scale: Scale, ctx: BenchContext):
    from repro_torch.faults import FaultPlan
    return _run_faulty(scale, ctx,
                       plan=FaultPlan(seed=11, transient_rate=0.25,
                                      kill_mode="raise"))


@_register("faulty_run_badhost", "resume",
           {"backend": "streams", "engine": "resumable",
            "faults": "bad_hosts=0", "num_hosts": 4})
def _faulty_run_badhost(scale: Scale, ctx: BenchContext):
    from repro_torch.faults import FaultPlan
    return _run_faulty(scale, ctx,
                       plan=FaultPlan(bad_hosts=(0,), kill_mode="raise"))


# ----------------------------------------------------------------- serving
# One ingested service per (scale, backend) is cached on the context, so
# the three scenarios share its resident state.
def _serving_service(scale: Scale, ctx: BenchContext, *,
                     backend: str = "streams", ingested: bool = True):
    from repro_torch.serve import MalStoneService
    key = (backend, ingested, ctx.nodes, scale.num_sites,
           scale.num_entities, scale.chunk_records, scale.records_per_node)
    if key not in ctx._services:
        seed, num_chunks = ctx.seed(scale)
        svc = MalStoneService(
            nodes=ctx.nodes, num_sites=scale.num_sites,
            chunk_records=scale.chunk_records, backend=backend, seed=seed,
            cfg=ctx.cfg(scale), num_chunks=num_chunks, device=ctx.device)
        if ingested:
            svc.ingest_chunks(svc.cpd)
        ctx._services[key] = svc
    return ctx._services[key]


def _serving_mix(scale: Scale):
    from repro_torch.serve import default_query_mix
    return default_query_mix(num_sites=scale.num_sites,
                             top_k=min(8, scale.num_sites))


@_register("serving_ingest_latency", "serving",
           {"backend": "streams", "engine": "serving", "phase": "ingest"})
def _serving_ingest(scale: Scale, ctx: BenchContext) -> ScenarioResult:
    """Latency of one ingest step (one chunk of every node folded into
    the resident state); the service resets when its stream runs out."""
    from repro_torch.bench import schema
    svc = _serving_service(scale, ctx, ingested=False)
    svc.reset()

    def fn():
        if svc.chunks_folded >= svc.cpd:
            svc.reset()
        svc.ingest_chunks(1)
        return svc.chunks_folded

    timing, _ = time_callable(fn, warmup=scale.warmup, iters=scale.iters)
    return ScenarioResult(
        timing=timing, records=ctx.nodes * scale.chunk_records,
        derived={"latency_percentiles":
                 schema.latency_percentiles(timing.samples_us)})


@_register("serving_query_batch", "serving",
           {"backend": "streams", "engine": "serving", "phase": "query",
            "query_mix": "default", "kernel_path": "pallas"})
def _serving_query_batch(scale: Scale, ctx: BenchContext) -> ScenarioResult:
    """Latency of one mixed query batch (one K5 launch) over the resident
    snapshot, answers on the host; p50/p95/p99 in ``derived``."""
    from repro_torch.bench import schema
    svc = _serving_service(scale, ctx)
    specs = _serving_mix(scale)
    timing, _ = time_callable(lambda: svc.query(specs),
                              warmup=scale.warmup, iters=scale.iters)
    return ScenarioResult(
        timing=timing, records=len(specs),
        derived={"latency_percentiles":
                 schema.latency_percentiles(timing.samples_us),
                 "batch_queries": len(specs)})


@_register("serving_sustained_qps", "serving",
           {"backend": "streams", "engine": "serving", "phase": "sustained",
            "query_mix": "default", "kernel_path": "pallas"})
def _serving_sustained(scale: Scale, ctx: BenchContext) -> ScenarioResult:
    """Sustained throughput: submit every batch, then drain; queries/s
    over the whole pipeline."""
    svc = _serving_service(scale, ctx)
    specs = _serving_mix(scale)
    batches = max(4, scale.iters)

    def fn():
        tickets = [svc.submit(specs) for _ in range(batches)]
        for t in tickets:
            svc.wait(t)
        return batches * len(specs)

    timing, queries = time_callable(fn, warmup=scale.warmup,
                                    iters=scale.iters)
    qps = queries / (timing.us_per_call / 1e6)
    return ScenarioResult(
        timing=timing, records=queries,
        derived={"queries_per_s": round(qps, 1), "batches": batches,
                 "batch_queries": len(specs)})


# ------------------------------------------------------------------ selection
def preset_scenario_names(preset: str) -> list:
    """The scenarios a preset runs by default: ``full`` runs all;
    ``smoke`` (the JAX package's selection) keeps every backend and both
    engines for B, one point per other statistic, no x4 sweep point, no
    four-process gang and one point of each shuffle code path."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; have {list(PRESETS)}")
    names = []
    for name, sc in SCENARIOS.items():
        if preset == "smoke":
            if sc.group == "malstone" and sc.params["statistic"] != "B":
                if not (sc.params["backend"] == "streams"
                        and sc.params["engine"] == "oneshot"):
                    continue
            if sc.group == "sweep" and sc.params.get("multiplier") == 4:
                continue
            if (sc.params.get("sweep") == "multiproc"
                    and sc.params["num_processes"] > 2):
                # p4 forks four processes: full preset only
                continue
            if (sc.group == "lossless"
                    and name not in ("mapreduce_lossless_cf0p25",
                                     "mapreduce_packed_cf0p5",
                                     "mapreduce_counting_cf0p5")):
                continue
        names.append(name)
    return names


def iter_scenarios(names: Optional[Iterable[str]] = None):
    for name in (names if names is not None else SCENARIOS):
        if name not in SCENARIOS:
            raise KeyError(
                f"unknown scenario {name!r}; run with --list to enumerate")
        yield SCENARIOS[name]
