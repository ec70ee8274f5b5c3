"""MalStone query-service launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve_malstone \\
        --nodes 2 --sites 512 --entities 4096 \\
        --ingest-chunks 4 --chunk-records 2048 --query-mix default

The flags are those of ``repro.launch.serve_malstone`` except
``--kernel-path`` (the port always answers with the masked window-ratio
kernel, K5 on the card), plus ``--device cuda|cpu`` (default: the card).
Three phases against one :class:`repro_torch.serve.MalStoneService`:

1. **seed**: a MalGen streaming seed for ``--nodes * --ingest-chunks``
   chunks of ``--chunk-records`` records (the log is never materialized;
   each ingest regenerates its chunks on the device).
2. **ingest**: fold the stream one chunk per node at a time into the
   resident state; each sample ends in a synchronize, so it holds the
   fold's device time.
3. **query**: answer a batch of ``--query-mix`` specs per call: a latency
   loop (``--query-batches`` timed calls -> p50/p95/p99), then a sustained
   loop (every batch submitted, optionally paced to ``--qps``, then
   drained).

``--check`` recomputes the same stream through the port's one-shot
streaming engine (``repro_torch.core.run``) and requires the rho bits of
A, B and B-fixed to be equal, and every ``ShuffleStats`` field on
mapreduce. ``--bench-json PATH`` writes the three phases as one BENCH
document (``repro_torch/bench/schema.py``).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

from repro_torch.bench import schema
from repro_torch.bench.timing import (
    synchronize,
    time_callable,
    timing_from_samples,
)
from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import EXCHANGE_IMPLS, ExchangePlan
from repro_torch.core.streaming import STREAM_BACKENDS
from repro_torch.malgen import MalGenConfig, make_seed_streaming
from repro_torch.serve import (
    MalStoneService,
    default_query_mix,
    growing_window_specs,
)


def build_query_mix(name: str, *, num_sites: int, top_k: int) -> list:
    """``default``: the 5-spec mixed batch (A / B / B-fixed, partial
    windows, top-k, drill-down); ``growing``: the paper's 52 nested B
    windows; ``mixed``: both (default + every 13th growing window)."""
    if name == "default":
        return list(default_query_mix(num_sites=num_sites, top_k=top_k))
    if name == "growing":
        return list(growing_window_specs("B"))
    if name == "mixed":
        return (list(default_query_mix(num_sites=num_sites, top_k=top_k))
                + list(growing_window_specs("B"))[12::13])
    raise ValueError(f"unknown query mix {name!r}")


def check_bit_identity(service, seed, cfg, num_chunks: int) -> None:
    """The resident snapshot must equal the one-shot streaming engine over
    the same stream: rho bits for A, B and B-fixed, and on mapreduce every
    ShuffleStats field. SystemExit on a mismatch."""
    from repro_torch.core import run

    want_stats = service.backend == "mapreduce"
    for stat in ("A", "B", "B-fixed"):
        out, ref_stats = run(
            seed, service.num_sites, nodes=service.parts, engine="streaming",
            statistic=stat, backend=service.backend,
            chunk_records=service.chunk_records, cfg=cfg,
            num_chunks=num_chunks, plan=service.plan, device=service.device,
            return_shuffle_stats=True)
        got = service.result(stat).rho
        if not torch.equal(got.view(torch.int32), out.rho.view(torch.int32)):
            raise SystemExit(
                f"check FAILED: MalStone {stat} diverges from the one-shot "
                f"streaming run (max |delta| = "
                f"{float((got - out.rho).abs().max())})")
    if want_stats:
        _, svc_stats = service.snapshot()
        for field, ref_val in zip(ref_stats._fields, ref_stats):
            got_val = int(getattr(svc_stats, field))
            if got_val != int(ref_val):
                raise SystemExit(f"check FAILED: ShuffleStats.{field} = "
                                 f"{got_val} != one-shot {int(ref_val)}")
    print("check OK: resident snapshot bit-identical to the one-shot "
          "streaming run (A, B, B-fixed"
          + (", ShuffleStats)" if want_stats else ")"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve_malstone",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--sites", type=int, default=512)
    ap.add_argument("--entities", type=int, default=4_096)
    ap.add_argument("--chunk-records", type=int, default=2_048)
    ap.add_argument("--ingest-chunks", type=int, default=4, metavar="N",
                    help="chunks per node streamed into the resident state"
                         " (total records = nodes * N * chunk-records)")
    ap.add_argument("--backend", default="streams", choices=STREAM_BACKENDS)
    ap.add_argument("--exchange-impl", default="auto", choices=EXCHANGE_IMPLS,
                    help="mapreduce per-chunk exchange (see"
                         " repro_torch.launch.malstone)")
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    ap.add_argument("--query-mix", default="default",
                    choices=("default", "growing", "mixed"),
                    help="specs per batch: the 5-spec mixed workload, the"
                         " 52 nested growing-B windows, or both")
    ap.add_argument("--top-k", type=int, default=8,
                    help="top-k sites in the default mix's ranking query")
    ap.add_argument("--query-batches", type=int, default=8, metavar="B",
                    help="timed batch calls in the latency loop and"
                         " batches submitted in the sustained loop")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="target query rate of the sustained loop"
                         " (queries/s; 0 = open throttle)")
    ap.add_argument("--check", action="store_true",
                    help="require the resident snapshot to equal the"
                         " one-shot streaming engine bit for bit")
    ap.add_argument("--bench-json", default=None, metavar="PATH",
                    help="also write the three phases as a BENCH document")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.ingest_chunks < 1:
        ap.error("--ingest-chunks must be >= 1")
    if args.query_batches < 1:
        ap.error("--query-batches must be >= 1")

    device = resolve_device(args.device)
    cfg = MalGenConfig(num_sites=args.sites, num_entities=args.entities)
    num_chunks = args.nodes * args.ingest_chunks
    total = num_chunks * args.chunk_records
    plan = ExchangePlan(impl=args.exchange_impl,
                        capacity_factor=args.capacity_factor)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {kind}; backend: {args.backend}")
    print(f"MalGen (service seed): {total:,} records over {args.nodes} "
          f"nodes x {args.ingest_chunks} chunks of {args.chunk_records:,}"
          f" — log never materialized")
    t0 = time.perf_counter()
    seed = make_seed_streaming(0, cfg, num_chunks, args.chunk_records,
                               device=device)
    synchronize()
    print(f"  seeded in {time.perf_counter() - t0:.1f}s "
          f"(scatter payload {seed.seed_bytes / 1e6:.1f} MB)")

    service = MalStoneService(
        nodes=args.nodes, num_sites=args.sites,
        chunk_records=args.chunk_records, backend=args.backend, seed=seed,
        cfg=cfg, num_chunks=num_chunks, plan=plan, device=device)

    # ---------------------------------------------------------- ingest
    # one chunk per node per call; the first call also builds and loads
    # the kernels on the card (reported, left out of the statistics)
    per_ingest = args.nodes * args.chunk_records
    ingest_samples = []
    for step in range(args.ingest_chunks):
        synchronize()
        t0 = time.perf_counter()
        service.ingest_chunks(1)
        synchronize()
        us = (time.perf_counter() - t0) * 1e6
        ingest_samples.append(us)
        print(f"  ingest {service.chunks_folded}/{args.ingest_chunks}: "
              f"{us / 1e3:.3f} ms ({per_ingest / (us / 1e6) / 1e6:.2f}M "
              f"records/s)" + (" [first call]" if step == 0 else ""),
              flush=True)
    steady = ingest_samples[1:] or ingest_samples
    ingest_timing = timing_from_samples(steady)
    print(f"ingest [{args.backend}] median "
          f"{ingest_timing.us_per_call / 1e3:.3f} ms/chunk-step over "
          f"{len(steady)} steady steps (first step "
          f"{ingest_samples[0] / 1e3:.3f} ms)")

    if args.check:
        check_bit_identity(service, seed, cfg, num_chunks)

    # ----------------------------------------------------- query latency
    specs = build_query_mix(args.query_mix, num_sites=args.sites,
                            top_k=min(args.top_k, args.sites))
    nq = len(specs)
    query_timing, answers = time_callable(
        lambda: service.query(specs), warmup=1, iters=args.query_batches,
        max_warmup=1)
    pcts = schema.latency_percentiles(query_timing.samples_us)
    print(f"query [{args.query_mix}, {nq} specs/batch] p50 "
          f"{pcts['p50'] / 1e3:.3f} ms  p95 {pcts['p95'] / 1e3:.3f} ms  "
          f"p99 {pcts['p99'] / 1e3:.3f} ms per batch over "
          f"{args.query_batches} calls")
    top = next((a for a in answers if a.top_sites is not None), None)
    if top is not None:
        print(f"  top-{len(top.top_sites)} sites by rho: "
              f"{top.top_sites.tolist()}")

    # -------------------------------------------------------- sustained
    interval = nq / args.qps if args.qps > 0 else 0.0
    synchronize()
    t0 = time.perf_counter()
    tickets = []
    for b in range(args.query_batches):
        if interval:
            lag = t0 + b * interval - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        tickets.append(service.submit(specs))
    for ticket in tickets:
        service.wait(ticket)
    wall_s = time.perf_counter() - t0
    queries = nq * args.query_batches
    achieved = queries / wall_s
    sustained_timing = timing_from_samples([wall_s * 1e6])
    print(f"sustained: {queries} queries ({args.query_batches} batches) in "
          f"{wall_s * 1e3:.3f} ms -> {achieved:.0f} queries/s"
          + (f" (target {args.qps:.0f})" if args.qps > 0 else ""))

    st = service.stats()
    print(f"service: {st.chunks_folded} chunks/node folded, "
          f"{st.records_ingested:,} records, {st.batches_answered} batches /"
          f" {st.queries_answered} queries answered, {st.pending} pending")

    if args.bench_json:
        base = {"backend": args.backend, "nodes": args.nodes,
                "sites": args.sites, "entities": args.entities,
                "chunk_records": args.chunk_records,
                "ingest_chunks": args.ingest_chunks,
                "query_mix": args.query_mix, "kernel_path": "kernel",
                "exchange_impl": args.exchange_impl, "device": kind}
        doc = schema.new_document(
            pathlib.Path(args.bench_json).stem.removeprefix("BENCH_"),
            env={"source": "repro_torch.launch.serve_malstone"})
        schema.add_result(
            doc, f"launch_serve_ingest_{args.backend}",
            dict(base, phase="ingest"), ingest_timing, records=per_ingest,
            derived={"latency_percentiles":
                     schema.latency_percentiles(steady),
                     "first_call_us": ingest_samples[0]})
        schema.add_result(
            doc, f"launch_serve_query_{args.backend}",
            dict(base, phase="query", batch_queries=nq), query_timing,
            records=nq, derived={"latency_percentiles": pcts})
        schema.add_result(
            doc, f"launch_serve_sustained_{args.backend}",
            dict(base, phase="sustained", batch_queries=nq,
                 qps_target=args.qps),
            sustained_timing, records=queries,
            derived={"queries_per_s": achieved,
                     "batches": args.query_batches})
        print(f"wrote {schema.write_document(doc, args.bench_json)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
