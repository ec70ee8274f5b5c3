#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc/`` with nvcc (sm_90a) and prints the
   build time and the ptxas report.
2. Holds each kernel (K1 count, K2 stable scatter, K3 fused word reducer)
   against its plain PyTorch version on the card, exactly, on edge cases.
3. Drives the port's main path once through ``repro_torch.core.run``:
   MalStone B over MalGen records generated on the card (``MalGenConfig()``
   defaults: 100,000 sites, 1,000,000 entities, 52 weeks), 8 nodes x 2^23
   records, the counting exchange at capacity factor 2.0 and the fused
   reducer. Every kernel's launch counter must rise in that run. Then timed
   runs, a per-stage breakdown, a profile, peak memory and the checks:
   lossless shuffle, byte accounting, and the histogram against a direct
   ``torch.bincount`` over the generated log.
4. Times each kernel at the main path's shapes against its plain version,
   one library call computing the same function (a yardstick the port
   never calls) and its byte bound at 3.35 TB/s, after checking it equal.
5. At 8 x 2^20 records, the card's result equals the port's own CPU run of
   the same log (histogram, rho bits, every ShuffleStats field).

Prints one JSON line of per-kernel numbers, then the card's name and power
limit as nvidia-smi gives them, then ``{"ok": true, "device": ...}`` as the
last line. Exits non-zero, printing no result, without a CUDA device or
when the repository's ``src/`` is not beside this file; any failed check
exits non-zero.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM HBM3, NVIDIA data sheet. Each kernel does a few integer
# operations per 4-byte element it reads, so its operation time at any of
# the card's ALU rates is far below its byte time: bound_ms is the byte time
# (inputs read once, outputs written once) at this rate.
HBM_BYTES_PER_S = 3.35e12
NODES, RPS = 8, 1 << 23            # main path: 67,108,864 records
EQ_RPS = 1 << 20                   # equality phase: 8,388,608 records
CAPACITY_FACTOR = 2.0
KERNEL_INFO = {
    "count_scatter.count": (
        "src/repro_torch/kernels/csrc/count_scatter.cu",
        "src/repro/kernels/count_scatter/count_scatter.py:52"),
    "count_scatter.scatter": (
        "src/repro_torch/kernels/csrc/count_scatter.cu",
        "src/repro/kernels/count_scatter/count_scatter.py:78"),
    "segment_hist.packed": (
        "src/repro_torch/kernels/csrc/segment_hist_packed.cu",
        "src/repro/kernels/segment_hist/segment_hist.py:87"),
}


class CheckFailed(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events around ``iters`` calls
    after ``warmup`` calls, ended by a synchronize (host clock on CPU)."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def exact(name: str, got, want) -> float:
    """Require bit equality; return the max absolute difference (0)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.to(torch.int64) - b.to(torch.int64))
                                 .abs().max()))
    check(err == 0.0, f"{name}: kernel differs from its plain version "
                      f"(max abs err {err})")
    return err


# ------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    log("build", f"{len(reports)} sources built in "
                 f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("build", f"{name}.cu: {line.strip()}")


# ------------------------------------------------------------- phase 2
def packed_words_case(seed: int, p: int, length: int, s_local: int,
                      num_weeks: int, device) -> torch.Tensor:
    """Shipped words with every kind of slot: owned and foreign words,
    zero words, and words whose site sets bit 31."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    site = torch.randint(0, s_local * p, (p, length), generator=g)
    week = torch.randint(0, num_weeks, (p, length), generator=g)
    mark = torch.randint(0, 2, (p, length), generator=g)
    words = (site << 8) | (week << 2) | (mark << 1) | 1
    kind = torch.rand((p, length), generator=g)
    big = (torch.randint(1 << 23, 1 << 24, (p, length), generator=g) << 8) | 3
    words = torch.where(kind < 0.15, torch.zeros_like(words), words)
    words = torch.where((kind >= 0.15) & (kind < 0.25), big, words)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).to(device)


def kernel_edge_cases(device) -> None:
    from repro_torch.kernels.count_scatter import count_scatter_ref
    from repro_torch.kernels.count_scatter import ops as cs
    from repro_torch.kernels.segment_hist import ops as sh

    g = torch.Generator(device="cpu").manual_seed(7)
    cases = [(1, 1000, 3), (1, 100, 4), (2, 5000, 1), (3, 70_000, 3),
             (4, 4 * cs.TILE, 4), (8, 100_000, 8), (2, 30_000, 16)]
    for rows, n, p in cases:
        dest = torch.randint(0, p + 1, (rows, n), generator=g,
                             dtype=torch.int32)
        words = torch.randint(-2**31, 2**31 - 1, (rows, n), generator=g,
                              dtype=torch.int32)
        variants = {"random": dest,
                    "one dest": torch.full_like(dest, p // 2),
                    "pseudo dest": torch.full_like(dest, p)}
        invalid = torch.rand((rows, n), generator=g) < 0.3
        variants["invalid rows"] = torch.where(invalid, p, dest)
        for name, d in variants.items():
            w = torch.where(invalid, 0, words) if name == "invalid rows" \
                else words
            w, d = w.to(device), d.to(device)
            exact(f"count_scatter {name} rows={rows} n={n} P={p}",
                  cs.count_scatter(w, d, p), count_scatter_ref(w, d, p))
            counts = cs.count_tiles(d, p + 1)
            exact(f"count_tiles {name} n={n} P={p}", counts,
                  cs.count_tiles_plain(d, p + 1))
            base, _ = cs.tile_bases(counts)
            exact(f"scatter_tiles {name} n={n} P={p}",
                  cs.scatter_tiles(w, d, base),
                  cs.scatter_tiles_plain(w, d, base))
    for p, s_local in ((1, 37), (3, 300), (8, 12_500)):
        words = packed_words_case(p, p, 50_000, s_local, 52, device)
        kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=52)
        exact(f"packed hist P={p}", sh.segment_hist_packed_words(words, **kw),
              sh.segment_hist_packed_words_plain(words, **kw))
    # bit-31 sites that this node owns and counts
    p, s_local = 2, 1 << 23
    site = torch.randint((1 << 24) - 64, 1 << 24, (p, 4000), generator=g)
    words = (site << 8) | 3
    words = torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32).to(device)
    kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=1)
    hist = sh.segment_hist_packed_words(words, **kw)
    exact("packed hist bit-31 sites", hist,
          sh.segment_hist_packed_words_plain(words, **kw))
    check(int(hist.sum()) == 2 * int((site % p == torch.arange(p)[:, None])
                                     .sum()), "bit-31 sites were dropped")
    log("kernel", f"K1/K2 bit-equal to plain on {len(cases) * 4} edge "
                  f"cases, K3 on 4")


# ------------------------------------------------------------- phase 3
def main_path(device, nodes: int, rps: int, runs: int = 3) -> dict:
    """Drive the main path through ``repro_torch.core.run`` and check it.
    Returns what later phases and the summary need."""
    from repro_torch.common import nodes as nodes_lib
    from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
    from repro_torch.core import run
    from repro_torch.core import spm
    from repro_torch.core.backends.mapreduce import (
        exchange_and_reduce,
        order_words,
        shuffle_round_bound,
        static_capacity,
    )
    from repro_torch.core.plan import resolve_word_histogram_fn
    from repro_torch.core.runner import _finalize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    cfg = MalGenConfig()
    total = nodes * rps
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR,
                        histogram_impl="kernel")
    seed = make_seed(0, cfg, total, device=device)
    sync(device)

    def drive():
        return run(seed, engine="generated", nodes=nodes, cfg=cfg,
                   records_per_shard=rps, statistic="B", plan=plan,
                   device=device, return_shuffle_stats=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    result, stats = drive()
    sync(device)
    launches = launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log("main", f"{total:,} records on {nodes} nodes, {cfg.num_sites:,} "
                f"sites, {cfg.num_entities:,} entities; launches {launches}")
    log("main", f"peak device memory {peak / 2**30:.3f} GiB")

    capacity = static_capacity(rps, nodes, CAPACITY_FACTOR)
    log("main", f"shuffle rounds={stats.rounds} capacity={stats.capacity} "
                f"sent={int(stats.sent)} residual={int(stats.residual)} "
                f"overflow={int(stats.overflow)} "
                f"bytes_exchanged={int(stats.bytes_exchanged)}")
    check(int(stats.overflow) == 0, "shuffle left records undelivered")
    check(int(stats.sent) == total, f"sent {int(stats.sent)} != {total}")
    check(stats.capacity == capacity, "capacity differs from the formula")
    check(int(stats.bytes_exchanged) == stats.rounds * nodes * capacity * 4
          * nodes, "bytes_exchanged != rounds * P * C * 4 summed over nodes")
    check(1 <= stats.rounds <= 3, f"{stats.rounds} rounds (expected <= 3)")
    check(stats.rounds <= shuffle_round_bound(rps, capacity),
          "rounds exceed the static bound")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")

    # MapReduce must equal the plain site-week histogram of the same log
    log_t = generate_shards_device(seed, cfg, nodes, rps, device=device)
    keys = (log_t.site_id.reshape(-1).to(torch.int64) * WEEKS_PER_YEAR
            + log_t.week().reshape(-1))
    size = cfg.num_sites * WEEKS_PER_YEAR
    hist = torch.stack(
        [torch.bincount(keys, minlength=size),
         torch.bincount(keys[log_t.mark.reshape(-1) > 0], minlength=size)],
        -1).to(torch.int32).reshape(cfg.num_sites, WEEKS_PER_YEAR, 2)
    want = spm.malstone_b(hist)
    check(torch.equal(result.total, want.total)
          and torch.equal(result.marked, want.marked),
          "histogram differs from a direct bincount over the log")
    check(torch.equal(result.rho.view(torch.int32),
                      want.rho.view(torch.int32)), "rho bits differ")
    check(bool(torch.isfinite(result.rho).all())
          and result.rho.shape == (cfg.num_sites, WEEKS_PER_YEAR),
          "rho not finite or of the wrong shape")
    log("main", "histogram equals a direct bincount over the generated log;"
                f" rho {tuple(result.rho.shape)} finite, mean "
                f"{float(result.rho.double().mean()):.6f}")
    del log_t, keys, hist, want

    samples = []
    for _ in range(runs):
        samples.append(time_ms(drive, device, iters=1, warmup=0))
    med = statistics.median(samples)
    log("main", f"run ms {samples}; median {med:.3f} ms = "
                f"{total / (med / 1e3):.1f} records/s")

    # stages, each timed on its own (the sum runs the path once)
    word_fn = resolve_word_histogram_fn(plan)
    s_pad = -(-cfg.num_sites // nodes) * nodes
    stage = {}
    box = {}
    stage["generate"] = time_ms(lambda: box.__setitem__(
        "log", generate_shards_device(seed, cfg, nodes, rps, device=device)),
        device, iters=1, warmup=0)
    stage["order"] = time_ms(lambda: box.__setitem__(
        "ordered", order_words(box["log"], WEEKS_PER_YEAR, "counting")),
        device, iters=1, warmup=0)
    stage["exchange+reduce"] = time_ms(lambda: box.__setitem__(
        "owned", exchange_and_reduce(
            *box["ordered"], num_sites=s_pad, num_weeks=WEEKS_PER_YEAR,
            capacity=capacity, max_rounds=shuffle_round_bound(rps, capacity),
            word_histogram_fn=word_fn)[0]), device, iters=1, warmup=0)
    stage["finalize"] = time_ms(lambda: _finalize(
        nodes_lib.all_gather_unstride(box["owned"])[:cfg.num_sites], "B"),
        device, iters=1, warmup=0)
    log("main", "stage ms " + json.dumps(stage))
    main_log = box["log"]
    ordered = box["ordered"]
    del box

    prof = {}
    if device.type == "cuda":
        prof = profile(drive, device)
    return dict(seed=seed, cfg=cfg, launches=launches, log=main_log,
                ordered=ordered, capacity=capacity, run_ms=samples,
                records_per_s=total / (med / 1e3), stage_ms=stage,
                peak_bytes=peak, rounds=stats.rounds, profile=prof)


def profile(drive, device) -> dict:
    """Device busy time and the top kernels of one main-path run: the sum
    of the device-side (kernel and memcpy/memset) events, against the wall
    time of the run inside the profiler (its start-up excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", f"wall {wall_ms:.3f} ms (profiled), device busy "
                   f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}")
    for ms, count, key in rows[:12]:
        log("profile", f"{ms:10.4f} ms x{count:<3d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                top=[(key[:90], ms, count) for ms, count, key in rows[:12]])


# ------------------------------------------------------------- phase 4
def kernels_at_main_shapes(device, mp: dict) -> list:
    from repro_torch.common.types import (
        WEEKS_PER_YEAR,
        pack_site_week_mark,
        unpack_site_week_mark,
    )
    from repro_torch.core.backends.mapreduce import ship_round
    from repro_torch.kernels.count_scatter import ops as cs
    from repro_torch.kernels.segment_hist import ops as sh

    lg = mp["log"]
    p, n = lg.site_id.shape
    words_sorted, starts = mp["ordered"]
    dest = (lg.site_id % p).to(torch.int32).contiguous()
    words = pack_site_week_mark(lg.site_id, lg.week(), lg.mark,
                                lg.valid_mask()).contiguous()
    num_dests = p + 1
    t = cs.num_tiles(n)
    out = []

    def entry(name, err, ms, plain_ms, library_ms, bytes_moved):
        source, replaces = KERNEL_INFO[name]
        bound = bytes_moved / HBM_BYTES_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": mp["launches"][name],
               "max_abs_err": err, "ms": ms, "kernel_ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
               "library_ms": library_ms, "match": err == 0.0}
        log("kernel", json.dumps(row))
        out.append(row)

    # K1: per-tile destination histogram of the main path's destinations
    counts = cs.count_tiles(dest, num_dests)
    err = exact("K1 main shapes", counts, cs.count_tiles_plain(dest,
                                                               num_dests))
    tile = torch.arange(n, device=device) // cs.TILE
    node = torch.arange(p, device=device).unsqueeze(1)
    keys = ((node * t + tile) * num_dests + dest).reshape(-1)
    entry("count_scatter.count", err,
          time_ms(lambda: cs.count_tiles(dest, num_dests), device, 10, 2),
          time_ms(lambda: cs.count_tiles_plain(dest, num_dests), device,
                  2, 1),
          time_ms(lambda: torch.bincount(keys, minlength=p * t * num_dests),
                  device, 10, 2),
          4 * p * n + 4 * p * t * num_dests)
    del tile, keys

    # K2: the stable scatter, given the bases K1's counts give
    base, _ = cs.tile_bases(counts)
    got = cs.scatter_tiles(words, dest, base)
    err = exact("K2 main shapes", got, cs.scatter_tiles_plain(words, dest,
                                                              base))
    exact("K2 vs the ordered words of the main path", got, words_sorted)

    def library_sort():
        order = torch.sort(dest, dim=1, stable=True).indices
        return words.gather(1, order)

    entry("count_scatter.scatter", err,
          time_ms(lambda: cs.scatter_tiles(words, dest, base), device, 10, 2),
          time_ms(lambda: cs.scatter_tiles_plain(words, dest, base), device,
                  2, 1),
          time_ms(library_sort, device, 5, 1),
          4 * p * n * 3 + 4 * p * t * num_dests)
    del got, base, counts

    # K3: round 0's shipped words, reduced per receiving node
    shipped, _ = ship_round(words_sorted, starts, 0, mp["capacity"])
    s_local = -(-mp["cfg"].num_sites // p)
    kw = dict(num_sites_local=s_local, num_partitions=p,
              num_weeks=WEEKS_PER_YEAR)
    err = exact("K3 main shapes", sh.segment_hist_packed_words(shipped, **kw),
                sh.segment_hist_packed_words_plain(shipped, **kw))
    site, week, mark, valid = unpack_site_week_mark(shipped)
    own = valid & (site % p == node)
    flat = ((node * s_local + site // p) * WEEKS_PER_YEAR + week).to(
        torch.int64) * 2
    hkeys = torch.cat([flat[own], flat[own & (mark > 0)] + 1])
    entry("segment_hist.packed", err,
          time_ms(lambda: sh.segment_hist_packed_words(shipped, **kw),
                  device, 10, 2),
          time_ms(lambda: sh.segment_hist_packed_words_plain(shipped, **kw),
                  device, 2, 1),
          time_ms(lambda: torch.bincount(
              hkeys, minlength=p * s_local * WEEKS_PER_YEAR * 2),
              device, 10, 2),
          4 * shipped.numel() + 4 * p * s_local * WEEKS_PER_YEAR * 2)
    return out


# ------------------------------------------------------------- phase 5
def card_equals_cpu(device, nodes: int, rps: int) -> None:
    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import malstone_run
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    cfg = MalGenConfig()
    seed = make_seed(1, cfg, nodes * rps, device=device)
    lg = generate_shards_device(seed, cfg, nodes, rps, device=device).map(
        lambda c: c.reshape(-1))
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR,
                        histogram_impl="kernel")
    got, gs = malstone_run(lg, cfg.num_sites, nodes=nodes, plan=plan,
                           device=device, return_shuffle_stats=True)
    want, ws = malstone_run(lg.to("cpu"), cfg.num_sites, nodes=nodes,
                            plan=plan, device="cpu",
                            return_shuffle_stats=True)
    for f in ("total", "marked"):
        check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
              f"card {f} != CPU {f}")
    check(torch.equal(got.rho.cpu().view(torch.int32),
                      want.rho.view(torch.int32)), "card rho bits != CPU")
    for f in gs._fields:
        check(int(getattr(gs, f)) == int(getattr(ws, f)),
              f"card ShuffleStats.{f} != CPU")
    log("equal", f"{nodes * rps:,} records: card == CPU (histogram, rho "
                 f"bits, all ShuffleStats; rounds={gs.rounds})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repository's src/repro_torch is not beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log("card", card)
    log("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
                f"{torch.cuda.get_device_name(0)} x "
                f"{torch.cuda.device_count()}")
    try:
        build_kernels()
        kernel_edge_cases(device)
        mp = main_path(device, NODES, RPS)
        kernels = kernels_at_main_shapes(device, mp)
        del mp["log"], mp["ordered"]
        card_equals_cpu(device, NODES, EQ_RPS)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
