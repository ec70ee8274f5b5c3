"""MalStone benchmark launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.malstone --nodes 8 \\
        --records-per-node 1048576 --gen-device

The flags are those of ``repro.launch.malstone`` that the port supports;
``--backend`` picks one of the four stacks (``streams``, ``sphere``,
``mapreduce``, ``mapreduce_combiner``).
The P nodes are a leading axis of tensors on one device (``--device cuda``,
the default, or ``cpu`` for the plain PyTorch path). ``--gen-device`` fuses
MalGen into the run: every node generates its shard in place and the timed
run includes generation; without it the shards are generated once, before
the timed runs, and the runs start from the materialized log.
``--stream-chunks N`` runs the streaming engine: each node folds its
records in N chunks, regenerated from a streaming seed in every run
(``engine="streaming"``), or, with ``--gen-device``, cut from the shard it
generates in place (``engine="generated_streaming"``). On the card each
run is timed with CUDA events and a synchronize.

``--overlap {on,off}`` drives the seed-mode streaming run through the
double-buffered per-chunk runner (``repro_torch.core.overlap``: on the
card, chunk k+1 generated on a second CUDA stream while chunk k is
exchanged and reduced; ``off`` the same calls serialised). ``--check``
asserts that the run's rho bit-equals the single-device oracle computed on
the CPU over the same records (exit 1 on a mismatch), and ``--bench-json
PATH`` writes the run as a BENCH document (``repro_torch/bench/
schema.py``).

``--checkpoint-dir DIR`` makes the streaming run resumable: it runs in
segments of ``--segment-chunks`` chunks a node, saving the state after each
(``repro_torch.core.resume``); ``--resume`` continues a preempted run from
the latest committed checkpoint, regenerating only the chunks not yet
folded, bit-identical to an uninterrupted run. ``--inject-faults`` runs a
seeded fault schedule (``repro_torch.faults.FaultPlan.parse``) under the
bounded retry (``--retry-attempts``) and NodeDoctor rerouting. These flags
need ``--stream-chunks``; with ``--gen-device``, ``--check`` or
``--overlap on|off`` they are an argparse error (the JAX launcher ignores
the last two on this path).

Multi-process runs: add ``--num-processes N`` and the launcher forks N
localhost workers joined over gloo (``repro_torch.launch.coordinator``),
each holding ``nodes/N`` of the nodes; the collectives (the mapreduce
``all_to_all`` and its round termination, the psums and gathers) cross
the processes, and every rank finalizes the full result. ``--coordinator
HOST:PORT --process-id K`` instead joins an externally-launched gang. Rank
k runs on ``cuda:{k % device_count}`` (ranks share a card; gloo, not NCCL,
joins them), or on the CPU with ``--device cpu``. Each timed run starts
after a barrier; ``--check`` runs on every rank against its own CPU
oracle, and rank 0 alone writes ``--bench-json``. ``--gen-device`` and
``--checkpoint-dir/--inject-faults`` are single-process, as in the JAX
launcher.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time

import torch

from repro_torch.bench import schema
from repro_torch.bench.timing import timing_from_samples
from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import (
    EXCHANGE_IMPLS,
    HISTOGRAM_IMPLS,
    ExchangePlan,
    WEEKS_PER_YEAR,
)
from repro_torch.core import malstone_single_device, run
from repro_torch.core.backends import resolve_exchange_impl
from repro_torch.core.overlap import OverlapStreamingRunner
from repro_torch.core.runner import RUN_BACKENDS, _pad_sites
from repro_torch.launch import coordinator, mesh
from repro_torch.malgen import (
    MalGenConfig,
    generate_chunked_log,
    generate_shards_device,
    make_seed,
    make_seed_streaming,
)


def _timed(fn, device: torch.device):
    """(result, milliseconds) of one call, ended by a synchronize."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _device(name: str, cfg: coordinator.DistConfig) -> torch.device:
    """The run's device; rank k of a gang takes card ``k % count``."""
    device = resolve_device(name)
    if device.type == "cuda" and cfg.is_distributed:
        device = torch.device(
            "cuda", cfg.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    coordinator.add_arguments(ap)
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--records-per-node", type=int, default=262_144)
    ap.add_argument("--sites", type=int, default=10_000)
    ap.add_argument("--entities", type=int, default=100_000)
    ap.add_argument("--backend", default="mapreduce", choices=RUN_BACKENDS,
                    help="the dataflow: streams (combine + all-reduce),"
                         " sphere (combine + reduce-scatter), mapreduce (the"
                         " record shuffle) or mapreduce_combiner (combine +"
                         " shuffle of histogram blocks); default mapreduce"
                         " (the JAX launcher's default is sphere)")
    ap.add_argument("--statistic", default="B",
                    choices=("A", "B", "B-fixed"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--capacity-factor", type=float, default=2.0,
                    help="bucket capacity as a multiple of records/nodes;"
                         " any value is lossless")
    ap.add_argument("--max-shuffle-rounds", type=int, default=None,
                    metavar="R",
                    help="cap the shuffle rounds (default: the provably"
                         " sufficient bound); an exhausted cap is an error")
    ap.add_argument("--exchange-impl", default="auto",
                    choices=EXCHANGE_IMPLS,
                    help="mapreduce only: 'counting' orders the packed words"
                         " with the counting-sort kernels, 'sort' with a"
                         " stable argsort, 'columns' ships four columns a"
                         " record; 'auto' = counting where the word"
                         " represents the workload, else columns")
    ap.add_argument("--histogram-impl", default="kernel",
                    choices=HISTOGRAM_IMPLS,
                    help="'kernel' reduces with the hand-written kernels"
                         " (segment_hist, and the fused unpack+histogram"
                         " for shuffled words); 'segment_sum' uses"
                         " index_add_")
    ap.add_argument("--gen-device", action="store_true",
                    help="generate every node's shard in place inside the"
                         " timed run")
    ap.add_argument("--stream-chunks", type=int, default=0, metavar="N",
                    help="stream each node's records in N chunks (0 ="
                         " one-shot)")
    ap.add_argument("--overlap", default="auto",
                    choices=("auto", "on", "off"),
                    help="streaming execution strategy: 'auto' runs the"
                         " streaming engine's loop; 'on' double-buffers per"
                         " chunk (chunk k+1 generated on a second CUDA"
                         " stream while chunk k is exchanged and reduced;"
                         " repro_torch.core.overlap); 'off' runs the same"
                         " per-chunk calls strictly serialised (the control"
                         " for measuring the overlap). All three give the"
                         " same bits; requires --stream-chunks")
    ap.add_argument("--check", action="store_true",
                    help="after the timed runs, assert the computed rho"
                         " bit-equals the single-device oracle run on the"
                         " CPU over the same records (exit 1 on mismatch)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="make the streaming run resumable: run it in"
                         " segments, checkpointing the state after each"
                         " into DIR (requires --stream-chunks; incompatible"
                         " with --gen-device)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest committed checkpoint in"
                         " --checkpoint-dir (default: start fresh)")
    ap.add_argument("--segment-chunks", type=int, default=0, metavar="K",
                    help="chunks per checkpointed segment (default:"
                         " --stream-chunks, i.e. one segment)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="seeded fault schedule, e.g. 'transient_rate=0.2,"
                         "seed=5,bad_hosts=1+3,kill_at_segment=2' (see"
                         " repro_torch.faults.FaultPlan.parse)")
    ap.add_argument("--retry-attempts", type=int, default=3,
                    help="total tries per segment before"
                         " SegmentRetriesExhausted (resumable runs)")
    ap.add_argument("--bench-json", default=None, metavar="PATH",
                    help="also write this run as a BENCH_*.json document"
                         " (schema: repro_torch/bench/schema.py) for"
                         " repro_torch.bench.compare")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.num_processes > 1:
        # the JAX launcher's refusals, checked before any rank is forked
        if args.checkpoint_dir is not None or args.inject_faults:
            ap.error("--checkpoint-dir/--inject-faults are single-process"
                     " for now (multi-writer checkpoints over"
                     " jax.distributed are a separate work item)")
        if args.gen_device:
            ap.error("--gen-device is single-process for now (its seed"
                     " closes over per-shard static layout; use the"
                     " streaming engine for multi-process runs)")
    if args.runs < 1:
        ap.error("--runs must be >= 1")
    if args.stream_chunks < 0 or (
            args.stream_chunks
            and args.records_per_node % args.stream_chunks):
        ap.error("--stream-chunks must divide --records-per-node")
    if args.overlap != "auto" and not args.stream_chunks:
        ap.error("--overlap on/off pipelines the streaming engine;"
                 " pass --stream-chunks")
    if args.overlap != "auto" and args.gen_device:
        ap.error("--overlap on/off pipelines the seed-mode streaming"
                 " engine, which regenerates its chunks; --gen-device cuts"
                 " them from shards generated in place")
    if args.check and args.gen_device:
        ap.error("--check compares against the single-device oracle over"
                 " the materialized records; it does not cover"
                 " --gen-device")
    resumable = args.checkpoint_dir is not None or args.inject_faults
    if resumable:
        if not args.stream_chunks:
            ap.error("--checkpoint-dir/--inject-faults need --stream-chunks"
                     " (resumable runs segment the streaming scan)")
        if args.gen_device:
            ap.error("--checkpoint-dir/--inject-faults are incompatible"
                     " with --gen-device")
        if args.check:
            ap.error("--check is not run on the resumable path"
                     " (--checkpoint-dir/--inject-faults)")
        if args.overlap != "auto":
            ap.error("--overlap on/off is not run on the resumable path"
                     " (--checkpoint-dir/--inject-faults)")
    chunk = (args.records_per_node // args.stream_chunks
             if args.stream_chunks else 0)

    # a spawn parent forks the ranks of this command and exits with the
    # gang's status; a rank joins the gang and runs on
    dist_cfg = coordinator.bootstrap(
        ["-m", "repro_torch.launch.malstone", *argv],
        local_devices_for=args.nodes, build_kernels=args.device == "cuda")
    device = _device(args.device, dist_cfg)
    group = mesh.global_nodes(args.nodes)
    cfg = MalGenConfig(num_sites=args.sites, num_entities=args.entities)
    total = args.nodes * args.records_per_node
    plan = ExchangePlan(impl=args.exchange_impl,
                        capacity_factor=args.capacity_factor,
                        max_shuffle_rounds=args.max_shuffle_rounds,
                        histogram_impl=args.histogram_impl)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {kind}; backend: {args.backend}")
    if group.distributed:
        print(f"[{coordinator.process_banner(dist_cfg)}] {group.local} "
              f"local of {group.nodes} global nodes on {device}", flush=True)
    if resumable:
        return _run_resumable(args, device, cfg, chunk, plan)

    streaming_seed = args.stream_chunks and not args.gen_device
    if streaming_seed:
        num_chunks = args.nodes * args.stream_chunks
        seed, ms = _timed(lambda: make_seed_streaming(
            0, cfg, num_chunks, chunk, device=device), device)
    else:
        seed, ms = _timed(lambda: make_seed(0, cfg, total, device=device),
                          device)
    seed = mesh.replicate(seed, group)
    print(f"MalGen seed: {total:,} records ({total * 100 / 1e6:.0f} MB "
          f"logical) over {args.nodes} nodes, seeded in {ms:.1f} ms "
          f"(scatter payload {seed.seed_bytes / 1e6:.1f} MB)")
    kw = dict(nodes=args.nodes, plan=plan, statistic=args.statistic,
              backend=args.backend, device=device, return_shuffle_stats=True,
              group=group)
    if streaming_seed and args.overlap != "auto":
        print(f"  streaming: {args.stream_chunks} chunks of {chunk:,} per "
              f"node, regenerated in every run, "
              + ("overlap pipeline" if args.overlap == "on"
                 else "per-chunk serialised"))
        # one runner for every timed run
        runner = OverlapStreamingRunner(
            seed, cfg, nodes=args.nodes, num_chunks=num_chunks,
            chunk_records=chunk, num_sites=cfg.num_sites,
            backend=args.backend, plan=plan, device=device, group=group)
        overlap_on = args.overlap == "on"

        def fn():
            return runner.run_result(args.statistic, overlap=overlap_on)
    elif streaming_seed:
        print(f"  streaming: {args.stream_chunks} chunks of {chunk:,} per "
              f"node, regenerated in every run")

        def fn():
            return run(seed, cfg.num_sites, engine="streaming", cfg=cfg,
                       num_chunks=num_chunks, chunk_records=chunk, **kw)
    elif args.gen_device:
        engine = ("generated_streaming" if args.stream_chunks
                  else "generated")
        extra = {"chunk_records": chunk} if args.stream_chunks else {}

        def fn():
            return run(seed, engine=engine, cfg=cfg,
                       records_per_shard=args.records_per_node, **extra,
                       **kw)
    else:
        log, ms = _timed(lambda: generate_shards_device(
            seed, cfg, args.nodes, args.records_per_node, device=device),
            device)
        log = log.map(lambda c: c.reshape(-1))
        print(f"  generated in {ms:.1f} ms")

        def fn():
            return run(log, cfg.num_sites, **kw)

    fn()  # warm-up: builds and loads the kernels on first CUDA use
    group.clock.reset()
    samples = []
    for r in range(args.runs):
        if group.distributed:
            torch.distributed.barrier()       # the ranks start together
        (result, stats), ms = _timed(fn, device)
        samples.append(ms)
        print(f"  run {r + 1}: {ms:.3f} ms "
              f"({total / (ms / 1e3) / 1e6:.1f}M records/s)", flush=True)
    mode = "gen-device" if args.gen_device else "one-shot"
    if args.stream_chunks:
        mode = (f"gen-device stream x{args.stream_chunks}" if args.gen_device
                else f"stream x{args.stream_chunks}")
        if args.overlap != "auto":
            mode += f" overlap={args.overlap}"
    print(f"MalStone {args.statistic} [{args.backend}, {mode}] median "
          f"{statistics.median(samples):.3f} ms over {args.runs} runs")
    shuffle_derived = None
    if stats is not None:
        impl = resolve_exchange_impl(plan.impl,
                                     _pad_sites(args.sites, args.nodes),
                                     WEEKS_PER_YEAR)
        print(f"  shuffle: impl={impl} rounds={stats.rounds} "
              f"capacity={stats.capacity}/dest sent={int(stats.sent)} "
              f"deferred={int(stats.residual)} "
              f"bytes={int(stats.bytes_exchanged):,} "
              f"overflow={int(stats.overflow)}")
        shuffle_derived = {
            "capacity_factor": args.capacity_factor,
            "shuffle_impl": impl,
            "shuffle_packed": impl != "columns",
            "shuffle_rounds": int(stats.rounds),
            "shuffle_capacity": int(stats.capacity),
            "shuffle_sent": int(stats.sent),
            "shuffle_deferred": int(stats.residual),
            "shuffle_overflow": int(stats.overflow),
            "shuffle_bytes_exchanged": int(stats.bytes_exchanged),
        }
    print(f"  rho {tuple(result.rho.shape)} mean "
          f"{float(result.rho.double().mean()):.6f}")
    if group.distributed:
        clock = group.clock
        print(f"  exchange, rank {group.rank}, over {args.runs} runs: "
              f"{clock.bytes:,} bytes in {clock.calls} gloo calls; "
              f"gloo {clock.gloo_ms:.3f} ms, to host {clock.d2h_ms:.3f} ms, "
              f"back {clock.h2d_ms:.3f} ms, waiting for the device "
              f"{clock.wait_ms:.3f} ms")

    if args.check:
        # the oracle's records are the run's, made on the run's device; the
        # oracle itself runs on a CPU copy, so it shares no kernel with the
        # run it checks
        t0 = time.perf_counter()
        olog = (generate_chunked_log(seed, cfg, num_chunks, chunk)
                if streaming_seed else log)
        olog = olog.map(lambda c: c.cpu())
        oracle = malstone_single_device(olog, cfg.num_sites, args.statistic)
        got = result.rho.cpu().numpy()
        ref = oracle.rho.numpy()
        if not (got.shape == ref.shape
                and (got.view("int32") == ref.view("int32")).all()):
            raise SystemExit(
                f"--check FAILED: rho {got!r} != single-device oracle "
                f"{ref!r}")
        print(f"--check: rho[{ref.size}] bit-equals the single-device "
              f"oracle (mean {float(ref.mean()):.6f})")
        print(f"  oracle: {olog.num_records:,} records, made on "
              f"{device.type} and reduced on the CPU in "
              f"{time.perf_counter() - t0:.3f} s")

    # only rank 0 writes the document in a gang (every rank would otherwise
    # race on the same path with identical content)
    if args.bench_json and group.rank == 0:
        engine = "streaming" if args.stream_chunks else "oneshot"
        stat_slug = args.statistic.lower().replace("-", "")
        scenario = f"launch_malstone_{stat_slug}_{args.backend}_{engine}"
        if args.gen_device:
            scenario += "_gendev"
        doc = schema.new_document(
            pathlib.Path(args.bench_json).stem.removeprefix("BENCH_"),
            device=device, env={"source": "repro_torch.launch.malstone"})
        schema.add_result(
            doc, scenario,
            {"backend": args.backend, "statistic": args.statistic,
             "engine": engine, "gen_device": args.gen_device,
             "nodes": args.nodes,
             "records_per_node": args.records_per_node,
             "sites": args.sites, "entities": args.entities,
             "stream_chunks": args.stream_chunks,
             "overlap": args.overlap,
             "num_processes": args.num_processes,
             "capacity_factor": args.capacity_factor,
             "exchange_impl": args.exchange_impl,
             # the port has no deprecated --packed-shuffle alias: the key
             # holds that flag's default
             "packed_shuffle": "auto",
             "histogram_impl": args.histogram_impl},
            timing_from_samples([ms * 1e3 for ms in samples],
                                warmup_iters=1),
            records=total, derived=shuffle_derived)
        out = schema.write_document(doc, path=args.bench_json)
        print(f"wrote {out}")
    if group.distributed:
        torch.distributed.destroy_process_group()


def _run_resumable(args, device, cfg, chunk, exchange_plan):
    """The --checkpoint-dir / --inject-faults path: one segment-at-a-time
    run through ``repro_torch.core.resume`` (bit-identical to the
    uninterrupted streaming engine), wall-clocked once: re-running it
    would resume instead of compute, so the single sample goes through
    ``timing_from_samples`` into the same BENCH document."""
    from repro_torch.bench.timing import synchronize
    from repro_torch.core.resume import ResumableRunner
    from repro_torch.faults import FaultPlan, RetryPolicy

    total = args.nodes * args.records_per_node
    num_chunks = args.nodes * args.stream_chunks
    seg = args.segment_chunks or args.stream_chunks
    plan = FaultPlan.parse(args.inject_faults) if args.inject_faults else None

    print(f"MalGen (streaming, resumable): {total:,} records "
          f"({total * 100 / 1e6:.0f} MB logical) over {args.nodes} nodes "
          f"x {args.stream_chunks} chunks of {chunk:,}; checkpoint every "
          f"{seg} chunks"
          + (f" -> {args.checkpoint_dir}" if args.checkpoint_dir else
             " (no checkpoint dir — faults only)"))
    seed, ms = _timed(lambda: make_seed_streaming(
        0, cfg, num_chunks, chunk, device=device), device)
    print(f"  seeded in {ms / 1e3:.1f}s "
          f"(scatter payload {seed.seed_bytes / 1e6:.1f} MB)")
    if plan is not None:
        print(f"  fault schedule: {plan}")

    runner = ResumableRunner(
        seed, cfg, nodes=args.nodes, num_chunks=num_chunks,
        chunk_records=chunk, segment_chunks=seg, backend=args.backend,
        statistic=args.statistic, plan=exchange_plan, device=device)
    synchronize()
    t0 = time.perf_counter()
    out = runner.run(checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                     faults=plan,
                     retry=RetryPolicy(max_attempts=args.retry_attempts))
    synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    timing = timing_from_samples([wall_us])
    rep = out.report

    print(f"MalStone {args.statistic} [{args.backend}, resumable "
          f"x{args.stream_chunks}/seg{seg}] {wall_us / 1e3:.1f} ms "
          f"({rep.segments_run}/{rep.segments_total} segments run, "
          f"{rep.chunks_skipped} chunks restored)")
    if rep.resumed_from_step is not None:
        print(f"  resumed from checkpoint step {rep.resumed_from_step}")
    print(f"  checkpoint: save {rep.checkpoint_save_ms:.1f} ms total, "
          f"restore {rep.checkpoint_restore_ms:.1f} ms")
    if plan is not None:
        print(f"  recovery: {rep.fault_events} injected faults, "
              f"{rep.segments_retried} segment retries, alarmed hosts "
              f"{rep.alarmed_hosts}, {rep.rerouted_shards} shards rerouted")

    derived = rep.to_derived()
    derived["segment_chunks"] = seg
    if out.shuffle_stats is not None:
        stats = out.shuffle_stats
        derived.update(
            capacity_factor=args.capacity_factor,
            shuffle_rounds=int(stats.rounds),
            shuffle_sent=int(stats.sent),
            shuffle_overflow=int(stats.overflow),
            shuffle_bytes_exchanged=int(stats.bytes_exchanged))
        print(f"  shuffle: rounds={derived['shuffle_rounds']} "
              f"sent={derived['shuffle_sent']} overflow=0 (lossless)")

    if args.bench_json:
        stat_slug = args.statistic.lower().replace("-", "")
        scenario = f"launch_malstone_{stat_slug}_{args.backend}_resume"
        doc = schema.new_document(
            pathlib.Path(args.bench_json).stem.removeprefix("BENCH_"),
            device=device, env={"source": "repro_torch.launch.malstone"})
        schema.add_result(
            doc, scenario,
            {"backend": args.backend, "statistic": args.statistic,
             "engine": "resumable", "nodes": args.nodes,
             "records_per_node": args.records_per_node,
             "sites": args.sites, "entities": args.entities,
             "stream_chunks": args.stream_chunks, "segment_chunks": seg,
             "resume": args.resume,
             "inject_faults": args.inject_faults or "",
             "capacity_factor": args.capacity_factor,
             "exchange_impl": args.exchange_impl},
            timing, records=rep.chunks_processed * chunk, derived=derived)
        path = schema.write_document(doc, path=args.bench_json)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
