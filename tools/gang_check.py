#!/usr/bin/env python3
"""MalStone cases in a gang of processes: each rank saves what it got.

    PYTHONPATH=src python tools/gang_check.py --num-processes 2 --nodes 4 8 \\
        --device cpu --out DIR [--width small|full] [--cases NAME ...] \\
        [--runs R] [--timeout S]

Without ``--process-id`` (and with ``--num-processes N > 1``) this is a
spawn parent: it builds the CUDA kernels once (on the card), forks N ranks
of itself joined over gloo (``repro_torch.launch.coordinator``) and exits
with the gang's status (124 on a timeout). ``--num-processes 1`` runs the
same cases in this one process. For each node count P of ``--nodes`` and
each case, every rank (holding ``P/N`` of the nodes) builds the same
streaming seed from rng seed 9, checks it against the gang's
(``launch.mesh.replicate``), and runs the case once with the kernels'
launch counters set to 0 just before and read just after; then ``--runs``
timed runs, each after a barrier (CUDA events on the card), with the
exchange's clock (``common.nodes.ExchangeClock``) summed over them; then,
on the card, one run profiled on rank 0 for its idle share. Rank k writes
``DIR/rank{k}.npz``: for every ``P{P}/{case}/`` its rho, histogram (the
weekly differences of MalStone B's cumulative counts), every
``ShuffleStats`` field, each kernel's launches, the timed runs' ms, the
clock, peak device memory and rank 0's idle share.

``--collectives`` also runs each collective of ``common.nodes`` over the
rank's rows of seeded ``[P, ...]`` inputs (``P{P}/collective/``), and
``mesh.replicate`` over seeds that differ by rank.

``case_result(name, inputs, nodes, device, group)`` is the one code path
the gang and a one-process reference both run (the tests and
``chip_smoke.py`` phase 11 call it with ``group=None``).

Widths: ``small`` is ``tests/md_scripts/multiproc_check.py``'s (301
sites, 1,000 entities, 2 chunks of 512 records a node); ``full`` is
``MalGenConfig()`` (100,000 sites, 1,000,000 entities, 52 weeks) with 8
chunks of 2^20 records a node.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.common.nodes import resolve_device  # noqa: E402
from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.core import run  # noqa: E402
from repro_torch.core.overlap import OverlapStreamingRunner  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import coordinator, mesh  # noqa: E402
from repro_torch.malgen import (  # noqa: E402
    MalGenConfig,
    generate_chunked_log,
    make_seed_streaming,
)

RNG_SEED = 9
WIDTHS = {
    "small": dict(cfg=dict(num_sites=301, num_entities=1000,
                           marked_site_fraction=0.2,
                           marked_event_fraction=0.3),
                  chunks_per_node=2, chunk_records=512),
    "full": dict(cfg={}, chunks_per_node=8, chunk_records=1 << 20),
}
STATS_FIELDS = ("sent", "overflow", "capacity", "rounds", "residual",
                "bytes_exchanged")
# a log streamed in chunks of this fraction of a node's records gets
# padding rows, which move the node boundaries of the flat log
LOG_STREAM_CHUNK = 3 / 8


def _case(source, backend, impl="auto", overlap=None):
    return dict(source=source, backend=backend, impl=impl, overlap=overlap)


# source "seed": the streaming engine regenerating chunks from the seed;
# "log": the one-shot engine over the materialized log; "logstream": the
# streaming engine over that log
CASES = {
    "seed_streams": _case("seed", "streams"),
    "seed_sphere": _case("seed", "sphere"),
    "seed_mapreduce_sort": _case("seed", "mapreduce", "sort"),
    "seed_mapreduce_counting": _case("seed", "mapreduce", "counting"),
    "seed_mapreduce_columns": _case("seed", "mapreduce", "columns"),
    "seed_mapreduce_combiner": _case("seed", "mapreduce_combiner"),
    "seed_mapreduce_counting_overlap_on": _case("seed", "mapreduce",
                                                "counting", True),
    "seed_mapreduce_counting_overlap_off": _case("seed", "mapreduce",
                                                 "counting", False),
    "seed_streams_overlap_on": _case("seed", "streams", overlap=True),
    "log_streams": _case("log", "streams"),
    "log_sphere": _case("log", "sphere"),
    "log_mapreduce_sort": _case("log", "mapreduce", "sort"),
    "log_mapreduce_counting": _case("log", "mapreduce", "counting"),
    "log_mapreduce_columns": _case("log", "mapreduce", "columns"),
    "log_mapreduce_combiner": _case("log", "mapreduce_combiner"),
    "logstream_mapreduce_counting": _case("logstream", "mapreduce",
                                          "counting"),
    "logstream_sphere": _case("logstream", "sphere"),
}


class Inputs(NamedTuple):
    cfg: MalGenConfig
    seed: object            # the streaming seed (a SeedInfo)
    log: Optional[EventLog]  # the flat log it materializes
    num_chunks: int
    chunk_records: int


def make_inputs(width: str, nodes: int, device,
                with_log: bool = True) -> Inputs:
    """The inputs of a width at P = ``nodes``: the streaming seed of
    ``nodes * chunks_per_node`` chunks and the log it materializes (node d
    holding chunks ``[d * cpn, (d+1) * cpn)``)."""
    w = WIDTHS[width]
    cfg = MalGenConfig(**w["cfg"])
    num_chunks = nodes * w["chunks_per_node"]
    seed = make_seed_streaming(RNG_SEED, cfg, num_chunks, w["chunk_records"],
                               device=device)
    log = (generate_chunked_log(seed, cfg, num_chunks, w["chunk_records"])
           if with_log else None)
    return Inputs(cfg, seed, log, num_chunks, w["chunk_records"])


def case_result(name: str, inputs: Inputs, nodes: int, device, group=None):
    """``(SpmResult of statistic B, ShuffleStats or None)`` of case
    ``name`` over the nodes of ``group`` (default: all ``nodes`` in this
    process)."""
    c = CASES[name]
    cfg = inputs.cfg
    plan = ExchangePlan(impl=c["impl"], histogram_impl="kernel")
    kw = dict(nodes=nodes, plan=plan, statistic="B", backend=c["backend"],
              device=device, return_shuffle_stats=True, group=group)
    if c["source"] == "seed" and c["overlap"] is not None:
        runner = OverlapStreamingRunner(
            inputs.seed, cfg, nodes=nodes, num_chunks=inputs.num_chunks,
            chunk_records=inputs.chunk_records, backend=c["backend"],
            plan=plan, device=device, group=group)
        return runner.run_result("B", overlap=c["overlap"])
    if c["source"] == "seed":
        return run(inputs.seed, cfg.num_sites, engine="streaming", cfg=cfg,
                   num_chunks=inputs.num_chunks,
                   chunk_records=inputs.chunk_records, **kw)
    if c["source"] == "log":
        return run(inputs.log, cfg.num_sites, **kw)
    per_node = inputs.log.num_records // nodes
    return run(inputs.log, cfg.num_sites, engine="streaming",
               chunk_records=int(per_node * LOG_STREAM_CHUNK), **kw)


def result_arrays(result, stats) -> dict:
    """The saved fields of one result: rho, the histogram and the
    ShuffleStats."""
    def weekly(cum):
        return torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[..., :1]))

    out = {"rho": result.rho.cpu().numpy(),
           "hist": torch.stack([weekly(result.total), weekly(result.marked)],
                               dim=-1).cpu().numpy()}
    if stats is not None:
        for f in STATS_FIELDS:
            out[f"stats_{f}"] = np.asarray(int(getattr(stats, f)))
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_ms(fn, device, group) -> float:
    if group.distributed:
        torch.distributed.barrier()
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def idle_share(fn, device) -> float:
    """1 - (the union of the card's kernel, copy and set spans) / wall,
    over one call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory(prefix="gang_check_trace_") as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return 1.0 - busy / wall_us


def collective_inputs(nodes: int) -> dict:
    """Every node's input of each collective, ``[P, ...]`` int32 from a
    numpy seed (the same on every process); psum's values lie near 2^31,
    so that its int32 sums wrap."""
    rng = np.random.default_rng(nodes)

    def ints(*shape, lo=-1000, hi=1000):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int32))

    return {"all_to_all": ints(nodes, nodes, 3),
            "psum": ints(nodes, 5, 2, lo=2**31 - 9, hi=2**31 - 1),
            "psum_scatter": ints(nodes, 2 * nodes, 3),
            "all_gather": ints(nodes, 2, 3),
            "all_gather_unstride": ints(nodes, 3, 4, 2),
            "global_count": ints(nodes, 7, lo=0, hi=100)}


def collective_arrays(group, device) -> dict:
    """Each collective of ``common.nodes`` over this process's rows of
    ``collective_inputs``; and whether ``mesh.replicate`` refused seeds
    that differ by rank (1) or not (0)."""
    from repro_torch.common import nodes as nodes_lib

    x = {k: group.rows(v.reshape(-1)).reshape(group.local, *v.shape[1:])
         .to(device) for k, v in collective_inputs(group.nodes).items()}
    out = {
        "all_to_all": nodes_lib.all_to_all(x["all_to_all"], group),
        "psum": nodes_lib.psum(x["psum"], group=group),
        "psum_scatter": nodes_lib.psum_scatter(x["psum_scatter"], group),
        "all_gather": nodes_lib.all_gather(x["all_gather"], group),
        "all_gather_unstride": nodes_lib.all_gather_unstride(
            x["all_gather_unstride"], group),
        "global_count": torch.tensor(nodes_lib.global_count(
            x["global_count"], group))}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    try:
        mesh.replicate((group.rank, torch.full((3,), group.rank)), group)
        out["replicate_refused"] = np.asarray(0)
    except RuntimeError:
        out["replicate_refused"] = np.asarray(1)
    return out


def run_rank(args, device) -> dict:
    """Every case at every node count on this rank -> the arrays to
    save."""
    out = {}
    for nodes in args.nodes:
        group = mesh.global_nodes(nodes)
        if args.collectives:
            out.update({f"P{nodes}/collective/{k}": v for k, v in
                        collective_arrays(group, device).items()})
        if not args.cases:
            continue
        with_log = any(CASES[c]["source"] != "seed" for c in args.cases)
        inputs = make_inputs(args.width, nodes, device, with_log)
        mesh.replicate(inputs.seed, group)
        for name in args.cases:
            key = f"P{nodes}/{name}/"

            def once(name=name, group=group, inputs=inputs, nodes=nodes):
                return case_result(name, inputs, nodes, device, group)

            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            _sync(device)
            if group.distributed:
                torch.distributed.barrier()
            reset_launch_counts()
            result, stats = once()
            _sync(device)
            launches = launch_counts()
            arrays = result_arrays(result, stats)
            arrays.update({f"launches_{k}": np.asarray(v)
                           for k, v in launches.items()})
            if device.type == "cuda":
                arrays["peak_bytes"] = np.asarray(
                    torch.cuda.max_memory_allocated(device))
            group.clock.reset()
            arrays["ms"] = np.asarray([_timed_ms(once, device, group)
                                       for _ in range(args.runs)])
            for k, v in group.clock.as_dict().items():
                arrays[f"clock_{k}"] = np.asarray(v)
            if device.type == "cuda" and args.profile:
                if group.distributed:
                    torch.distributed.barrier()
                if group.rank == 0:
                    arrays["idle_share"] = np.asarray(idle_share(once, device))
                else:
                    once()
                    _sync(device)
            out.update({key + k: v for k, v in arrays.items()})
            print(f"[rank {group.rank}/{group.world}] P={nodes} {name}: "
                  f"launches {json.dumps(launches)}; ms "
                  f"{arrays['ms'].tolist()}", flush=True)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    coordinator.add_arguments(ap)
    ap.add_argument("--nodes", type=int, nargs="+", required=True)
    ap.add_argument("--cases", nargs="*", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--collectives", action="store_true",
                    help="also run each collective of common.nodes on"
                         " seeded inputs")
    ap.add_argument("--width", default="small", choices=list(WIDTHS))
    ap.add_argument("--runs", type=int, default=0,
                    help="timed runs of each case after the counted one")
    ap.add_argument("--profile", action="store_true",
                    help="profile one run of each case on rank 0 (card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", required=True, metavar="DIR")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the spawn parent waits for the gang")
    args = ap.parse_args(argv)
    for nodes in args.nodes:
        if nodes % args.num_processes:
            ap.error(f"--nodes {nodes} must divide evenly over "
                     f"--num-processes {args.num_processes}")
    cfg = coordinator.bootstrap([__file__, *argv],
                                build_kernels=args.device == "cuda",
                                timeout=args.timeout)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", (cfg.process_id or 0)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    print(f"[{coordinator.process_banner(cfg)}] on {device}", flush=True)
    arrays = run_rank(args, device)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"rank{cfg.process_id or 0}.npz", **arrays)
    if cfg.is_distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
