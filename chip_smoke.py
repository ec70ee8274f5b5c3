#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc/`` with nvcc (sm_90a) and prints the
   build time and the ptxas report.
2. Holds each kernel (K1 count, K2 stable scatter, K3 fused word reducer,
   K4 column histogram) against its plain PyTorch version on the card,
   exactly, on edge cases (K5 in phase 7, K6 and K7 in phase 8). K1 and K2
   at D in {1, 2, 9, 257, 1025} destinations, rows ragged across their
   4,096-record tile, rows of a length that is no multiple of 4, every
   record on one destination, invalid rows and destinations out of
   range. K3 and K4
   also on the cases of their hot-site design at P in {1, 4, 8}: every
   record on one cell or one site, more hot sites than a tile holds, a
   hot list that misses every record, empty rows, sites and weeks out of
   range (and bit-31 words for K3); their hot lists equal the plain
   selection.
3. Drives the port's main path once through ``repro_torch.core.run``:
   MalStone B over MalGen records generated on the card (``MalGenConfig()``
   defaults: 100,000 sites, 1,000,000 entities, 52 weeks), 8 nodes x 2^23
   records, the counting exchange at capacity factor 2.0 and the fused
   reducer. Every kernel's launch counter must rise in that run: K1-K3,
   K6 (the generated records' sites: one launch a node and one for the
   marked stream) and K7 (the MalStone B finalize, once). Then timed runs,
   a per-stage breakdown (with the part of generation that is
   ``sample_sites``), a profile, peak memory and the checks: lossless
   shuffle, byte accounting, and the histogram against a direct
   ``torch.bincount`` over the generated log.
4. Times each kernel at the main path's shapes against its plain version,
   one library call computing the same function (a yardstick the port
   never calls) and its byte bound at 3.35 TB/s, after checking it equal;
   K3 also over the same records with sites drawn uniformly; K1 and K2
   also beside their first design (``tools/first_designs.py``, a tile of
   1,024 records) on the same records, K2 also as a CUDA graph (no host
   work) and cold (after its inputs were evicted from the L2).
5. Drives the other backends at the same width, each with the launch
   counts set to 0 just before it and read just after: ``streams``,
   ``sphere`` and ``mapreduce_combiner`` over the same generated records,
   and ``mapreduce`` with the columns exchange, ``partitioned=True``, over
   the same shards as a log. Histograms and the rho bits of A, B and
   B-fixed equal the counting path's; the columns exchange's shuffle stats
   equal its (``bytes_exchanged`` at 17 bytes a slot). Each run launches
   exactly its kernels: K4 (and K1, K2 a round for columns), K6 nodes + 1
   times where it generates, K7 once for statistic B. Prints each
   backend's stage times, records/s, peak memory and profile, then checks
   and times K4 at these shapes as in 4, over sites drawn uniformly and
   at a service step's 2^20 records a node.
6. At 8 x 2^20 records, the card's result equals the port's own CPU run of
   the same log (histogram, rho bits, every ShuffleStats field).
7. The query service: (a) K5, the masked window-ratio kernel, bit-equal to
   its plain version on edge cases (N, W and S sweeps; every mask shape:
   none, one run at either end, all weeks, alternating weeks, a window,
   random, at N up to 129; zero denominators; counts above 2^24 and past
   2^31); (b) ``MalStoneService`` at full width, each backend
   with the launch counts set to 0 just before it is driven and read just
   after: ``streams`` and ``mapreduce`` (counting exchange) fold 8 ingest
   steps of 8 x 2^20 records from a streaming seed, ``sphere`` and
   ``mapreduce_combiner`` 2 steps. The resident snapshot equals the
   streaming engine (rho bits of A, B and B-fixed, every ShuffleStats
   field) and the one-shot counting run over ``generate_chunked_log``;
   each ingest step launches K6 twice a node (a chunk's marked and
   unmarked draws) and each B result K7 once;
   the ``mixed`` and ``growing`` query batches launch K5 once each, equal
   its plain version, and the 52 growing B answers equal ``malstone_b``'s
   rho columns. Prints ingest and query latency percentiles, records/s,
   sustained queries/s, peak memory, a profile, and K5 against its plain
   version, its first design, a matmul yardstick and its bound, at N = 52,
   N = 9 and over 52 alternating-week masks (the worst shape): on the
   device (a CUDA graph), with the wrapper's host work, and cold.
8. The bench (``repro_torch.bench``): (a) K6, the power-law sampler, and
   K7, the MalStone B finalizer, bit-equal to their plain versions on edge
   cases (K6: S in {1, 7, 2048, 100,000}, n in {1, 1023, 2^18 - 1, 2^18,
   2^23}, ties, runs of equal entries, NaN, +-inf, -0.0, the MalGen CDFs
   with draws on their entries and on the guide's bucket edges, u at an
   odd offset, a last entry below 1, entries outside [0, 1]; K7: W in {1,
   2, 31, 32, 33, 52, 64, 65, 130}, S in {1, 7, 1001, 100,000}, zero
   weeks, sums above 2^24 and past 2^31, a histogram at an odd offset);
   (b) the six ``kernel_*`` scenarios at n = 2^23, S = 100,000 through
   ``run_scenarios``, each with the launch counts set to 0 just before it
   and read just after (K4, K6 and K7 launch only in their ``_pallas``
   rows), each kernel equal to its plain version on the scenario's inputs,
   and K6 and K7 timed against their plain versions, a library yardstick,
   their first designs (``tools/first_designs.py``) and their bounds; K6
   also on the MalGen unmarked CDF at a node's draws and at a service
   step's chunk sizes, the wrapper against ``torch.searchsorted`` with
   the host work of both; (c) the
   port's ``smoke`` selection (38 scenarios) at the same widths, 8 nodes x
   2^20 records, into a document that must validate and compare clean
   against itself; prints its records/s and queries/s.

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
# H100 SXM HBM3, NVIDIA data sheet. K1-K4 do a few integer operations per
# 4-byte element they read, so their operation time at any of the card's
# ALU rates is far below their byte time: their bound_ms is the byte time
# (inputs read once, outputs written once) at this rate. K5's integer adds,
# K6's search steps and K7's adds and divides are counted too, at the
# card's 32-bit rate outside the tensor cores (the data sheet's float32
# 67 T/s; it gives no separate INT32 rate); a bound is the larger of the
# two times.
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12
NODES, RPS = 8, 1 << 23            # main path: 67,108,864 records
EQ_RPS = 1 << 20                   # equality phase: 8,388,608 records
SERVE_CHUNK, SERVE_STEPS = 1 << 20, 8   # service: 8 x 8 x 2^20 records
SERVE_SMALL_STEPS = 2                   # sphere and the combiner
QUERY_BATCHES = 20
# phase 8: the bench's kernel pairs at the MalGenConfig() widths, then its
# smoke selection at the same widths and a smaller depth
BENCH_WIDTHS = dict(num_sites=100_000, num_entities=1_000_000,
                    marked_event_fraction=0.1, warmup=1)
BENCH_KERNELS = dict(records_per_node=1 << 23, chunk_records=1 << 20,
                     iters=5, **BENCH_WIDTHS)
BENCH_SMOKE = dict(records_per_node=1 << 20, chunk_records=1 << 18,
                   iters=3, **BENCH_WIDTHS)
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
    "segment_hist": (
        "src/repro_torch/kernels/csrc/segment_hist.cu",
        "src/repro/kernels/segment_hist/segment_hist.py:66"),
    "windowed_ratio.masked": (
        "src/repro_torch/kernels/csrc/windowed_ratio_masked.cu",
        "src/repro/kernels/windowed_ratio/windowed_ratio.py:53"),
    "powerlaw_sample": (
        "src/repro_torch/kernels/csrc/powerlaw_sample.cu",
        "src/repro/kernels/powerlaw_sample/powerlaw_sample.py:32"),
    "windowed_ratio": (
        "src/repro_torch/kernels/csrc/windowed_ratio.cu",
        "src/repro/kernels/windowed_ratio/windowed_ratio.py:29"),
}
# the kernels of the counting main path (phase 3): K6 samples the sites of
# the generated records, K7 finalizes MalStone B
MAIN_KERNELS = ("count_scatter.count", "count_scatter.scatter",
                "segment_hist.packed", "powerlaw_sample", "windowed_ratio")
STATISTICS = ("A", "B-fixed", "B")     # B last: its run is the one read


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


def graph_ms(fn, device, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed, so that no host work is timed (the best
    of three replays). The port runs eagerly; this is a kernel's time
    without its wrapper's Python."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def cold_ms(fn, device, calls: int = 5) -> float:
    """Median milliseconds of single calls of ``fn``, each timed alone with
    CUDA events right after a write of 256 MB has evicted its inputs from
    the card's 50 MB L2."""
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    fn()
    out = []
    for _ in range(calls):
        scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def first_designs():
    """``tools/first_designs.py``: the first designs of K2 and K5, the
    yardsticks timed beside them (built with the port's flags)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import first_designs as fd

    return fd


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
    # (rows, n, P): D = P + 1 destinations; rows ragged across the tile,
    # and rows whose length is no multiple of 4 (16-byte loads only where
    # a row is aligned)
    tile = cs.TILE
    cases = [(1, 1000, 3), (1, 100, 4), (2, 5000, 1), (3, 70_000, 3),
             (4, 4 * tile, 4), (8, 100_000, 8), (2, 30_000, 16),
             (1, tile - 1, 0), (2, tile + 1, 1), (3, 3 * tile + 77, 8),
             (2, 2 * tile + 5, 256), (3, 3 * tile + 77, 1024)]
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
        # K1/K2 only: destinations outside [0, P] land nowhere
        k = torch.randint(0, 7, (rows, n), generator=g, dtype=torch.int32)
        variants["out of range"] = torch.where(
            invalid, torch.where(k % 2 == 0, -1 - k, p + 1 + k), dest)
        for name, d in variants.items():
            w = torch.where(invalid, 0, words) if name == "invalid rows" \
                else words
            w, d = w.to(device), d.to(device)
            if name != "out of range":
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
    k4 = k4_edge_cases(g, device)
    hot = hot_site_cases(device)
    log("kernel", f"K1/K2 bit-equal to plain on {len(cases) * 5} edge "
                  f"cases, K3 on {4 + hot['K3']}, K4 on {k4 + hot['K4']}; "
                  f"the hot lists equal their plain version on "
                  f"{hot['lists']}")


def k4_edge_cases(g, device) -> int:
    """K4 on invalid rows, sites below 0 and at num_sites or above, weeks
    out of range, marks in {-1, 0, 1, 2}, every record on one site,
    record counts that are not a multiple of the block and site offsets.
    Returns the number of cases."""
    from repro_torch.kernels.segment_hist import ops as sh

    cases = [(1, 1, 5, 52, 0), (1, 1000, 37, 52, 0), (3, 70_001, 300, 52, 0),
             (8, 100_000, 12_500, 52, 0), (2, 257, 10, 65, 17),
             (4, 5000, 40, 52, -3)]
    for rows, n, num_sites, num_weeks, offset in cases:
        site = torch.randint(offset - 3, offset + num_sites + 3, (rows, n),
                             generator=g, dtype=torch.int32)
        week = torch.randint(-2, num_weeks + 2, (rows, n), generator=g,
                             dtype=torch.int32)
        mark = torch.randint(-1, 3, (rows, n), generator=g, dtype=torch.int32)
        valid = torch.rand((rows, n), generator=g) < 0.8
        kw = dict(num_sites=num_sites, num_weeks=num_weeks,
                  site_offset=offset)
        for name, st in (("edges", site), ("one site", torch.full_like(
                site, offset + num_sites - 1))):
            cols = [c.to(device) for c in (st, week, mark, valid)]
            exact(f"segment_hist {name} rows={rows} n={n} S={num_sites} "
                  f"W={num_weeks} offset={offset}",
                  sh.segment_hist(*cols, **kw),
                  sh.segment_hist_plain(*cols, **kw))
    return 2 * len(cases)


HOT_CASES = ("random", "one cell", "one site", "many hot sites",
             "sample misses", "empty rows")


def hist_case(name: str, p: int, n: int, num_sites: int, num_weeks: int,
              g, owned: bool = False):
    """K4's columns for one case of the hot-site design, on the CPU:
    ``random`` has invalid rows, sites and weeks out of range and marks in
    {-1, 0, 1, 2}; ``one cell`` and ``one site`` put every record on one;
    ``many hot sites`` spreads valid records evenly over 100 sites (50
    past 64 weeks), all of them hot at n = 2^22 and more than a tile holds
    (with ``owned``, row r's sites are r modulo P, as K3's owned words);
    ``sample misses`` puts every sampled
    record on one site that no other record has, so the hot list misses
    almost every record; ``empty rows`` has every other row invalid."""
    from repro_torch.kernels.segment_hist import ops as sh

    site = torch.randint(-3, num_sites + 3, (p, n), generator=g,
                         dtype=torch.int32)
    week = torch.randint(-2, num_weeks + 2, (p, n), generator=g,
                         dtype=torch.int32)
    mark = torch.randint(-1, 3, (p, n), generator=g, dtype=torch.int32)
    valid = torch.rand((p, n), generator=g) < 0.9
    if name == "one cell":
        site.fill_(num_sites // 2)
        week.fill_(num_weeks - 1)
        valid.fill_(True)
    elif name == "one site":
        site.fill_(num_sites // 2)
    elif name == "many hot sites":
        site = torch.randint(0, 100 if num_weeks <= 64 else 50, (p, n),
                             generator=g, dtype=torch.int32)
        week = torch.randint(0, num_weeks, (p, n), generator=g,
                             dtype=torch.int32)
        valid.fill_(True)
        if owned:
            site = site * p + torch.arange(p, dtype=torch.int32)[:, None]
    elif name == "sample misses":
        site = torch.randint(0, num_sites - 1, (p, n), generator=g,
                             dtype=torch.int32)
        sample = min(n, sh.SAMPLE)
        site[:, torch.arange(sample) * n // sample] = num_sites - 1
    elif name == "empty rows":
        valid[1::2] = False
    return site, week, mark, valid


def case_words(cols, p: int, s_local: int):
    """K3's words from a case's columns: sites folded into [0, P * S_local
    + 3P) (owned, foreign and out-of-block words), weeks into [0, 64)."""
    site, week, mark, valid = cols
    site = site.to(torch.int64) % (p * s_local + 3 * p)
    week = week.to(torch.int64) % 64
    words = ((site << 8) | (week << 2) | ((mark > 0).to(torch.int64) << 1)
             | valid.to(torch.int64))
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def hot_site_cases(device) -> dict:
    """K3 and K4 bit-equal to their plain versions on every case of
    ``hist_case`` at P in {1, 4, 8}, n = 2^20 (W = 52; for K4 also W = 130,
    whose tile holds 39 sites), and with a hot list that names only sites
    no record has; each hot list equal to its plain version. Returns the
    number of cases of each."""
    from repro_torch.kernels.segment_hist import ops as sh

    g = torch.Generator(device="cpu").manual_seed(16)
    count = {"K3": 0, "K4": 0, "lists": 0}
    num_sites = 12_500
    for p in (1, 4, 8):
        for name in HOT_CASES:
            n = 1 << (22 if name == "many hot sites" else 20)
            for weeks in (52, 130):
                cols = [c.to(device) for c in hist_case(name, p, n, num_sites,
                                                        weeks, g)]
                kw = dict(num_sites=num_sites, num_weeks=weeks)
                what = f"{name} P={p} W={weeks}"
                exact(f"K4 {what}", sh.segment_hist(*cols, **kw),
                      sh.segment_hist_plain(*cols, **kw))
                geo = sh.launch_geometry(cols[0], n, weeks)
                hot = sh.segment_hist_hot_sites(cols[0], cols[1], cols[3],
                                                **kw)
                exact(f"K4 hot list {what}", hot, sh.hot_sites_plain(
                    sh.record_sites(cols[0], cols[1], cols[3], **kw),
                    geo.sample, geo.threshold))
                count["K4"] += 1
                count["lists"] += 1
                if name == "many hot sites":
                    check(int(hot[0, 0]) > geo.hot_capacity
                          or int(hot[0, 0]) == sh.HOT_SITES,
                          f"K4 {what}: {int(hot[0, 0])} hot sites listed, "
                          f"the tile holds {geo.hot_capacity}")
            absent = torch.full((p, sh.HOT_LIST), -1, dtype=torch.int32)
            absent[:, 0] = sh.HOT_SITES
            absent[:, 1:] = num_sites + torch.arange(sh.HOT_SITES)
            words = case_words(hist_case(name, p, n, num_sites, 52, g,
                                         owned=True), p, num_sites).to(device)
            kw = dict(num_sites_local=num_sites, num_partitions=p,
                      num_weeks=52)
            want = sh.segment_hist_packed_words_plain(words, **kw)
            exact(f"K3 {name} P={p}",
                  sh.segment_hist_packed_words(words, **kw), want)
            exact(f"K3 {name} P={p}, a hot list of absent sites",
                  sh.segment_hist_packed_words_tiled(
                      words, absent.to(device), **kw), want)
            geo = sh.launch_geometry(words, n, 52)
            hot = sh.segment_hist_packed_hot_sites(words, **kw)
            exact(f"K3 hot list {name} P={p}", hot,
                  sh.hot_sites_plain(sh.word_sites(words, **kw), geo.sample,
                                     geo.threshold))
            if name == "many hot sites":
                check(int(hot[:, 0].min()) == sh.HOT_SITES,
                      f"K3 {name} P={p}: hot lists {hot[:, 0].tolist()}")
            cols = [c.to(device) for c in hist_case(name, p, n, num_sites,
                                                    52, g)]
            kw = dict(num_sites=num_sites, num_weeks=52)
            exact(f"K4 {name} P={p}, a hot list of absent sites",
                  sh.segment_hist_tiled(*cols, absent.to(device), **kw),
                  sh.segment_hist_plain(*cols, **kw))
            count["K3"] += 2
            count["K4"] += 1
            count["lists"] += 1
    return count


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
    from repro_torch.core.plan import resolve_histogram_fns
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
    for name in MAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the main path")
    check(launches["segment_hist"] == 0, "K4 ran on the counting path")
    # one K6 launch a node's unmarked draws plus the marked stream's, one
    # K7 launch for the finalize
    check(launches["powerlaw_sample"] == nodes + 1,
          f"{launches['powerlaw_sample']} K6 launches, expected {nodes + 1}")
    check(launches["windowed_ratio"] == 1,
          f"{launches['windowed_ratio']} K7 launches, expected 1")

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
    _, word_fn = resolve_histogram_fns(plan)
    s_pad = -(-cfg.num_sites // nodes) * nodes
    stage = {}
    box = {}
    stage["generate"] = time_ms(lambda: box.__setitem__(
        "log", generate_shards_device(seed, cfg, nodes, rps, device=device)),
        device, iters=1, warmup=0)
    stage["generate.sample_sites"] = sample_sites_ms(seed, cfg, nodes, rps,
                                                     device)
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


def sample_sites_ms(seed, cfg, nodes: int, rps: int, device) -> float:
    """The part of a generation that is ``sample_sites`` (K6 on the card):
    the marked stream's draws on the marked CDF and each node's unmarked
    draws on the unmarked CDF, timed alone on draws of the same sizes."""
    from repro_torch.malgen import sample_sites

    g = torch.Generator(device=device).manual_seed(5)
    n_unmarked = rps - len(range(0, seed.num_marked_events, nodes))
    marked = torch.rand(seed.num_marked_events, generator=g, device=device)
    unmarked = torch.rand(n_unmarked, generator=g, device=device)

    def calls():
        sample_sites(seed.marked_cdf, marked)
        for _ in range(nodes):
            sample_sites(seed.unmarked_cdf, unmarked)

    return time_ms(calls, device, iters=3, warmup=1)


def profile(drive, device, top: int = 12) -> dict:
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
    for ms, count, key in rows[:top]:
        log("profile", f"{ms:10.4f} ms x{count:<3d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                top=[(key[:90], ms, count) for ms, count, key in rows[:top]])


# ------------------------------------------------------------- phase 4
def kernel_row(name, launches, err, ms, plain_ms, library_ms, bytes_moved,
               ops: int = 0, **extra) -> dict:
    """One kernel's entry of the kernels line; the bound is the larger of
    its bytes (inputs read once, outputs written once) at the card's memory
    rate and its ``ops`` at the 32-bit rate."""
    source, replaces = KERNEL_INFO[name]
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS32_PER_S * 1e3
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "match": err == 0.0, **extra}
    log("kernel", json.dumps(row))
    return row


def kernels_at_main_shapes(device, mp: dict) -> list:
    from repro_torch.common.types import (
        WEEKS_PER_YEAR,
        pack_site_week_mark,
        unpack_site_week_mark,
    )
    from repro_torch.core.backends.mapreduce import order_words, ship_round
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

    # K1: per-tile destination histogram of the main path's destinations
    counts = cs.count_tiles(dest, num_dests)
    err = exact("K1 main shapes", counts, cs.count_tiles_plain(dest,
                                                               num_dests))
    tile = torch.arange(n, device=device) // cs.TILE
    node = torch.arange(p, device=device).unsqueeze(1)
    keys = ((node * t + tile) * num_dests + dest).reshape(-1)
    fd = first_designs()
    out.append(kernel_row(
        "count_scatter.count", mp["launches"]["count_scatter.count"], err,
        time_ms(lambda: cs.count_tiles(dest, num_dests), device, 10, 2),
        time_ms(lambda: cs.count_tiles_plain(dest, num_dests), device, 2,
                1),
        time_ms(lambda: torch.bincount(keys, minlength=p * t * num_dests),
                device, 10, 2),
        4 * p * n + 4 * p * t * num_dests, tile=cs.TILE,
        graph_ms=graph_ms(lambda: cs.count_tiles(dest, num_dests), device),
        first_design_tile=fd.TILE,
        first_design_ms=time_ms(lambda: fd.count_tiles(dest, num_dests),
                                device, 10, 2),
        tile_bases_ms=time_ms(lambda: cs.tile_bases(counts), device, 10,
                              2)))
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

    # the first design (tile of 1,024 records) on the same records
    fbase = fd.tile_bases(fd.count_tiles(dest, num_dests))
    exact("K2 first design", fd.scatter_tiles(words, dest, fbase), got)
    out.append(kernel_row(
        "count_scatter.scatter", mp["launches"]["count_scatter.scatter"],
        err,
        time_ms(lambda: cs.scatter_tiles(words, dest, base), device, 10, 2),
        time_ms(lambda: cs.scatter_tiles_plain(words, dest, base), device,
                2, 1),
        time_ms(library_sort, device, 5, 1),
        4 * p * n * 3 + 4 * p * t * num_dests,
        graph_ms=graph_ms(lambda: cs.scatter_tiles(words, dest, base),
                          device),
        cold_ms=cold_ms(lambda: cs.scatter_tiles(words, dest, base),
                        device),
        first_design_ms=time_ms(lambda: fd.scatter_tiles(words, dest, fbase),
                                device, 10, 2)))
    del got, base, counts, fbase

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
    del site, week, mark, valid, own, flat
    # the same records with sites drawn uniformly, ordered and shipped as
    # the main path does: what the power law's hot sites cost K3
    uniform_log = lg._replace(site_id=torch.randint(
        0, mp["cfg"].num_sites, lg.site_id.shape, device=device,
        dtype=torch.int32))
    uniform, _ = ship_round(*order_words(uniform_log, WEEKS_PER_YEAR,
                                         "counting"), 0, mp["capacity"])
    del uniform_log
    exact("K3 uniform sites", sh.segment_hist_packed_words(uniform, **kw),
          sh.segment_hist_packed_words_plain(uniform, **kw))
    out.append(kernel_row(
        "segment_hist.packed", mp["launches"]["segment_hist.packed"], err,
        time_ms(lambda: sh.segment_hist_packed_words(shipped, **kw),
                device, 10, 2),
        time_ms(lambda: sh.segment_hist_packed_words_plain(shipped, **kw),
                device, 2, 1),
        time_ms(lambda: torch.bincount(
            hkeys, minlength=p * s_local * WEEKS_PER_YEAR * 2),
            device, 10, 2),
        4 * shipped.numel() + 4 * p * s_local * WEEKS_PER_YEAR * 2,
        hot_sites=sh.segment_hist_packed_hot_sites(shipped, **kw)[:, 0]
        .tolist(),
        uniform_sites_ms=time_ms(
            lambda: sh.segment_hist_packed_words(uniform, **kw), device, 10,
            2),
        uniform_sites_plain_ms=time_ms(
            lambda: sh.segment_hist_packed_words_plain(uniform, **kw),
            device, 2, 1)))
    return out


# ------------------------------------------------------------- phase 5
def other_backends(device, nodes: int, rps: int, runs: int = 3):
    """Drive streams, sphere and mapreduce_combiner over the main path's
    generated records, and mapreduce with the columns exchange,
    partitioned, over the same shards as a log; check each against the
    counting path and K4's launches; time stages and runs. Returns K4's
    kernels-line entry."""
    from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
    from repro_torch.core import run
    from repro_torch.core.backends.mapreduce import static_capacity
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.segment_hist import ops as sh
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    cuda = device.type == "cuda"
    cfg = MalGenConfig()
    total, num_sites, weeks = nodes * rps, cfg.num_sites, WEEKS_PER_YEAR
    s_pad = -(-num_sites // nodes) * nodes
    capacity = static_capacity(rps, nodes, CAPACITY_FACTOR)
    seed = make_seed(0, cfg, total, device=device)     # the main path's
    gen = dict(engine="generated", nodes=nodes, cfg=cfg,
               records_per_shard=rps, device=device,
               return_shuffle_stats=True)
    want = {stat: run(seed, backend="mapreduce", statistic=stat,
                      plan=ExchangePlan(impl="counting",
                                        capacity_factor=CAPACITY_FACTOR),
                      **gen)
            for stat in STATISTICS}
    flat = generate_shards_device(seed, cfg, nodes, rps, device=device).map(
        lambda c: c.reshape(-1))
    columns = ExchangePlan(impl="columns", capacity_factor=CAPACITY_FACTOR)

    def drive(path, stat):
        if path == "mapreduce+columns":
            return run(flat, num_sites, nodes=nodes, backend="mapreduce",
                       plan=columns, partitioned=True, statistic=stat,
                       device=device, return_shuffle_stats=True)
        return run(seed, backend=path, statistic=stat, **gen)

    k4_launches = {}
    for path in ("streams", "sphere", "mapreduce_combiner",
                 "mapreduce+columns"):
        blocks = path == "mapreduce+columns"
        for stat in STATISTICS:
            sync(device)
            base = peak = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            reset_launch_counts()
            result, stats = drive(path, stat)
            sync(device)
            launches = launch_counts()
            if cuda:
                peak = torch.cuda.max_memory_allocated(device)
            ref, ref_stats = want[stat]
            for f in ("total", "marked", "rho"):
                got = getattr(result, f)
                if blocks:     # [P, s_pad/P, ...] blocks in node order
                    got = got.reshape(-1, *got.shape[2:])[:num_sites]
                check(torch.equal(got.view(torch.int32),
                                  getattr(ref, f).view(torch.int32)),
                      f"{path} {stat}: {f} differs from the counting path")
            rounds = 1
            if blocks:
                rounds = stats.rounds
                for f in ("sent", "overflow", "capacity", "rounds",
                          "residual"):
                    check(int(getattr(stats, f)) == int(getattr(ref_stats,
                                                                 f)),
                          f"columns ShuffleStats.{f} differs from counting")
                per_node = rounds * nodes * capacity * 17
                check(int(stats.bytes_exchanged) == (
                    per_node * nodes + 2**31) % 2**32 - 2**31,
                    "columns bytes_exchanged != rounds * P * C * 17 summed "
                    "over the nodes (int32, wrapping as the psum does)")
            else:
                check(stats is None, f"{path} returned ShuffleStats")
            # K6 samples the sites of a generation (a node's unmarked
            # draws each and the marked stream); the columns path is
            # handed its log. K7 finalizes statistic B.
            expect = {"segment_hist": rounds, "segment_hist.packed": 0,
                      "count_scatter.count": rounds if blocks else 0,
                      "count_scatter.scatter": rounds if blocks else 0,
                      "windowed_ratio.masked": 0,
                      "powerlaw_sample": 0 if blocks else nodes + 1,
                      "windowed_ratio": int(stat == "B")}
            check(launches == expect, f"{path} {stat}: launches "
                                      f"{launches}, expected {expect}")
        k4_launches[path] = launches["segment_hist"]
        samples = [time_ms(lambda: drive(path, "B"), device, iters=1,
                           warmup=0) for _ in range(runs)]
        med = statistics.median(samples)
        stage = backend_stages(path, seed, cfg, flat, nodes, rps, s_pad,
                               capacity, device)
        row = dict(run_ms=samples, median_ms=med,
                   records_per_s=total / (med / 1e3), stage_ms=stage,
                   peak_bytes=peak, allocated_before_bytes=base,
                   k4_launches=launches["segment_hist"], rounds=rounds)
        log("path", f"{path}: " + json.dumps(row))
        if cuda:
            profile(lambda: drive(path, "B"), device, top=6)
    log("path", "streams, sphere, mapreduce_combiner and mapreduce+columns "
                "equal the counting path (histograms, A/B/B-fixed rho bits, "
                "columns shuffle stats)")

    # K4 at these shapes: the local combine of the generated records
    lg = flat.map(lambda c: c.reshape(nodes, -1))
    cols = (lg.site_id, lg.week(), lg.mark, lg.valid_mask())
    kw = dict(num_sites=s_pad, num_weeks=weeks)
    err = exact("K4 main shapes", sh.segment_hist(*cols, **kw),
                sh.segment_hist_plain(*cols, **kw))
    node = torch.arange(nodes, device=device).unsqueeze(1)
    flat_key = ((node * s_pad + cols[0]) * weeks + cols[1]).to(
        torch.int64) * 2
    keys = torch.cat([flat_key.reshape(-1),
                      flat_key[cols[2] > 0].reshape(-1) + 1])
    del flat_key
    # the same columns with sites drawn uniformly: what the power law's
    # hot sites cost K4 and its plain version
    uniform = (torch.randint(0, num_sites, cols[0].shape, device=device,
                             dtype=torch.int32),) + cols[1:]
    exact("K4 uniform sites", sh.segment_hist(*uniform, **kw),
          sh.segment_hist_plain(*uniform, **kw))
    # a service ingest step's chunk: the first 2^20 records of each node
    chunk = [c[:, :SERVE_CHUNK].contiguous() for c in cols]
    exact("K4 at 2^20 records a node", sh.segment_hist(*chunk, **kw),
          sh.segment_hist_plain(*chunk, **kw))
    k4 = kernel_row(
        "segment_hist", sum(k4_launches.values()), err,
        time_ms(lambda: sh.segment_hist(*cols, **kw), device, 10, 2),
        time_ms(lambda: sh.segment_hist_plain(*cols, **kw), device, 2, 1),
        time_ms(lambda: torch.bincount(
            keys, minlength=nodes * s_pad * weeks * 2), device, 10, 2),
        13 * total + 4 * nodes * s_pad * weeks * 2,
        launches_by_path=k4_launches,
        hot_sites=sh.segment_hist_hot_sites(cols[0], cols[1], cols[3], **kw)
        [:, 0].tolist(),
        uniform_sites_ms=time_ms(lambda: sh.segment_hist(*uniform, **kw),
                                 device, 10, 2),
        uniform_sites_plain_ms=time_ms(
            lambda: sh.segment_hist_plain(*uniform, **kw), device, 2, 1),
        chunk_2_20_ms=time_ms(lambda: sh.segment_hist(*chunk, **kw), device,
                              10, 2))
    return k4


def backend_stages(path, seed, cfg, flat, nodes, rps, s_pad, capacity,
                   device) -> dict:
    """Each stage of one backend's run timed on its own (one pass each):
    generate, the local combine (K4) or the columns exchange, the
    collective, the finalize."""
    from repro_torch.common import nodes as nodes_lib
    from repro_torch.common.types import WEEKS_PER_YEAR as weeks
    from repro_torch.core.backends import (
        mapreduce_combiner_histogram,
        shuffle_stats,
        sphere_histogram,
        streams_histogram,
    )
    from repro_torch.core.backends.mapreduce import (
        columns_shuffle_histogram,
        shuffle_round_bound,
    )
    from repro_torch.core.runner import _finalize
    from repro_torch.kernels.segment_hist import segment_hist_eventlog
    from repro_torch.malgen import generate_shards_device

    box, stage = {}, {}

    def timed(name, key, fn):
        stage[name] = time_ms(lambda: box.__setitem__(key, fn()), device,
                              iters=1, warmup=0)

    if path == "mapreduce+columns":
        lg = flat.map(lambda c: c.reshape(nodes, -1))
        timed("exchange+reduce", "out", lambda: columns_shuffle_histogram(
            lg, num_sites=s_pad, num_weeks=weeks, capacity=capacity,
            max_rounds=shuffle_round_bound(rps, capacity),
            histogram_fn=segment_hist_eventlog))
        owned, stats = box["out"]
        timed("collective", "stats", lambda: shuffle_stats(stats))
        timed("finalize", "result", lambda: _finalize(
            nodes_lib.all_gather_unstride(owned).reshape(
                nodes, s_pad // nodes, weeks, 2), "B"))
        return stage
    timed("generate", "log", lambda: generate_shards_device(
        seed, cfg, nodes, rps, device=device))
    timed("local combine", "local", lambda: segment_hist_eventlog(
        box["log"], s_pad, weeks))
    local = box["local"]
    backend_fn, gather = {
        "streams": (streams_histogram, lambda h: h),
        "sphere": (sphere_histogram, nodes_lib.all_gather),
        "mapreduce_combiner": (mapreduce_combiner_histogram,
                               nodes_lib.all_gather_unstride)}[path]
    timed("collective", "out", lambda: backend_fn(
        box["log"], s_pad, weeks, histogram_fn=lambda *_: local))
    timed("finalize", "result", lambda: _finalize(
        gather(box["out"])[:cfg.num_sites], "B"))
    return stage


# ------------------------------------------------------------- phase 6
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


# ------------------------------------------------------------- phase 7
def k5_case(seed: int, n: int, w: int, s: int, device, *, high: int = 1000,
            density: float = 0.5):
    """A histogram with empty sites and random masks (int32 counts in
    ``[0, high)``)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hist = torch.randint(0, high, (s, w, 2), generator=g, dtype=torch.int32)
    hist[torch.rand(s, generator=g) < 0.2] = 0
    nm = torch.rand((n, w), generator=g) < density
    dm = torch.rand((n, w), generator=g) < density
    return hist.to(device), nm.to(device), dm.to(device)


def k5_exact(name: str, got, want) -> float:
    """K5 against its plain version: rho by its bits, num, den."""
    return exact(name, (got[0].view(torch.int32), got[1], got[2]),
                 (want[0].view(torch.int32), want[1], want[2]))


K5_MASK_KINDS = ("none", "first", "last", "all", "alternating", "window",
                 "random")


def k5_masks(kind: str, n: int, w: int, g) -> torch.Tensor:
    """N masks of one shape (on the CPU): no week; one run from the first
    week or to the last; every week; alternating weeks (both phases, 26
    runs at W = 52); one run anywhere; or each week at random."""
    weeks = torch.arange(w)[None, :]
    k = torch.randint(0, w + 1, (n, 1), generator=g)
    if kind == "none":
        return torch.zeros(n, w, dtype=torch.bool)
    if kind == "first":
        return weeks < k.clamp(min=1)
    if kind == "last":
        return weeks >= k.clamp(max=w - 1)
    if kind == "all":
        return torch.ones(n, w, dtype=torch.bool)
    if kind == "alternating":
        return (weeks + torch.arange(n)[:, None]) % 2 == 0
    if kind == "window":
        a = torch.randint(0, w, (n, 1), generator=g)
        return (weeks >= a) & (weeks < a + 1 + k % (w - a))
    return torch.rand((n, w), generator=g) < 0.5


def k5_edge_cases(device) -> int:
    """K5 over N in {1, 9, 52, 57}, W in {1, 52, 64, 65} and S in {1, 700,
    1000} (1000 is no multiple of the 64-site tile), every mask shape at N
    in {1, 9, 52, 57, 129} (129: three query blocks) and the same W, S =
    1000, all-zero denominators, and sums above 2^24 and past 2^31 (int32
    wrap). Returns the number of cases."""
    from repro_torch.kernels.windowed_ratio import ops as wr

    count = 0
    for n in (1, 9, 52, 57):
        for w in (1, 52, 64, 65):
            for s in (1, 700, 1000):
                args = k5_case(n * 10_000 + w * 100 + s, n, w, s, device)
                k5_exact(f"K5 N={n} W={w} S={s}",
                         wr.masked_window_ratio(*args),
                         wr.masked_window_ratio_plain(*args))
                count += 1
    g = torch.Generator(device="cpu").manual_seed(5)
    for n in (1, 9, 52, 57, 129):
        for w in (1, 52, 64, 65):
            hist = k5_case(n + w, 1, w, 1000, device)[0]
            for kind in K5_MASK_KINDS:
                nm = k5_masks(kind, n, w, g).to(device)
                dm = k5_masks(kind, n, w, g).to(device)
                k5_exact(f"K5 {kind} N={n} W={w} S=1000",
                         wr.masked_window_ratio(hist, nm, dm),
                         wr.masked_window_ratio_plain(hist, nm, dm))
                count += 1
    hist, nm, _ = k5_case(1, 57, 52, 700, device)
    zero = torch.zeros_like(nm)
    got = wr.masked_window_ratio(hist, nm, zero)
    k5_exact("K5 zero denominators", got,
             wr.masked_window_ratio_plain(hist, nm, zero))
    check(not bool(got[0].any()), "K5: rho != 0 where den == 0")
    for name, high in (("above 2^24", 1 << 20), ("past 2^31", 1 << 27)):
        hist, nm, dm = k5_case(2, 52, 65, 1000, device, high=high,
                               density=0.9)
        got = wr.masked_window_ratio(hist, nm, dm)
        k5_exact(f"K5 sums {name}", got,
                 wr.masked_window_ratio_plain(hist, nm, dm))
        check(int(got[1].max()) > 1 << 24, f"K5 {name}: no sum above 2^24")
        for kind in ("alternating", "last"):
            m = k5_masks(kind, 52, 65, g).to(device)
            k5_exact(f"K5 sums {name}, {kind} masks",
                     wr.masked_window_ratio(hist, m, m),
                     wr.masked_window_ratio_plain(hist, m, m))
            count += 1
    check(int(got[1].min()) < 0, "K5 past 2^31: no sum wrapped")
    count += 3
    log("kernel", f"K5 bit-equal to plain on {count} cases")
    return count


def timed_samples(fn, n: int, device) -> list:
    """Milliseconds of ``n`` calls, each between two synchronizes."""
    out = []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serving(device, nodes: int, chunk: int, steps: int,
            small_steps: int) -> dict:
    """Drive ``MalStoneService`` for every backend and check it; returns
    K5's kernels-line entry."""
    from repro_torch.bench.schema import latency_percentiles as percentiles
    from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
    from repro_torch.core import malstone_run, run
    from repro_torch.core import spm
    from repro_torch.core.backends.mapreduce import (
        shuffle_round_bound,
        static_capacity,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve_malstone import build_query_mix
    from repro_torch.malgen import (
        MalGenConfig,
        generate_chunked_log,
        make_seed_streaming,
    )
    from repro_torch.serve import MalStoneService, encode_query_batch

    cuda = device.type == "cuda"
    cfg = MalGenConfig()
    num_sites, weeks = cfg.num_sites, WEEKS_PER_YEAR
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR)
    mixes = {m: build_query_mix(m, num_sites=num_sites, top_k=8)
             for m in ("mixed", "growing")}
    seeds, oneshot = {}, {}
    k5_launches, k5_inputs, k7_launches = 0, None, 0
    round_bound = shuffle_round_bound(
        chunk, static_capacity(chunk, nodes, CAPACITY_FACTOR))
    for backend, n_steps in (("streams", steps), ("mapreduce", steps),
                             ("sphere", small_steps),
                             ("mapreduce_combiner", small_steps)):
        num_chunks = nodes * n_steps
        if n_steps not in seeds:
            seeds[n_steps] = make_seed_streaming(2, cfg, num_chunks, chunk,
                                                 device=device)
            lg = generate_chunked_log(seeds[n_steps], cfg, num_chunks, chunk)
            oneshot[n_steps] = {
                stat: malstone_run(lg, num_sites, nodes=nodes,
                                   backend="mapreduce", statistic=stat,
                                   plan=plan, device=device)
                for stat in STATISTICS}
            del lg
        seed = seeds[n_steps]
        svc = MalStoneService(nodes=nodes, num_sites=num_sites,
                              chunk_records=chunk, backend=backend,
                              seed=seed, cfg=cfg, num_chunks=num_chunks,
                              plan=plan, device=device)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device) if cuda else 0
        # the main path of this phase: ingest every step, snapshot, answer
        # both batches; launch counts read per step and per batch
        ingest_ms, per_step = [], []
        for _ in range(n_steps):
            reset_launch_counts()
            ingest_ms += timed_samples(lambda: svc.ingest_chunks(1), 1,
                                       device)
            per_step.append(launch_counts())
        hist, stats = svc.snapshot()
        answers = {}
        for mix, specs in mixes.items():
            reset_launch_counts()
            answers[mix] = svc.query(specs)
            got = launch_counts()
            check(got == dict.fromkeys(got, 0) | {"windowed_ratio.masked": 1},
                  f"{backend} {mix} batch: launches {got}")
            k5_launches += got["windowed_ratio.masked"]
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        for i, got in enumerate(per_step):
            k3 = got["segment_hist.packed"]
            if backend == "mapreduce":
                want = {"count_scatter.count": 1, "count_scatter.scatter": 1,
                        "segment_hist.packed": k3, "segment_hist": 0}
                check(1 <= k3 <= round_bound,
                      f"mapreduce step {i}: {k3} K3 launches (rounds)")
            else:
                want = {"count_scatter.count": 0, "count_scatter.scatter": 0,
                        "segment_hist.packed": 0, "segment_hist": 1}
            # each node's chunk samples its marked and unmarked draws
            want.update({"windowed_ratio.masked": 0,
                         "powerlaw_sample": 2 * nodes, "windowed_ratio": 0})
            check(got == want, f"{backend} ingest step {i}: launches {got}, "
                               f"expected {want}")

        # the snapshot equals the streaming engine and the one-shot run
        for stat in STATISTICS:
            reset_launch_counts()
            res = svc.result(stat)
            got = launch_counts()
            check(got == dict.fromkeys(got, 0) | {
                "windowed_ratio": int(stat == "B")},
                f"{backend} result {stat}: launches {got}")
            k7_launches += got["windowed_ratio"]
            ref, ref_stats = run(seed, num_sites, nodes=nodes,
                                 engine="streaming", cfg=cfg,
                                 num_chunks=num_chunks, chunk_records=chunk,
                                 backend=backend, statistic=stat, plan=plan,
                                 device=device, return_shuffle_stats=True)
            for want, what in ((ref, "streaming engine"),
                               (oneshot[n_steps][stat], "one-shot run")):
                for f in ("total", "marked", "rho"):
                    check(torch.equal(getattr(res, f).view(torch.int32),
                                      getattr(want, f).view(torch.int32)),
                          f"{backend} {stat}: {f} differs from the {what}")
            if backend == "mapreduce":
                for f in ref_stats._fields:
                    check(int(getattr(stats, f)) == int(getattr(ref_stats, f)),
                          f"{backend}: ShuffleStats.{f} differs from the "
                          f"streaming engine")
                check(int(stats.overflow) == 0 and int(stats.sent)
                      == nodes * n_steps * chunk, "service shuffle lost "
                                                  "records")
            else:
                check(stats is None, f"{backend} returned ShuffleStats")

        # the answers: K5 equals its plain version, B columns, top-k
        from repro_torch.kernels.windowed_ratio import ops as wr

        b_rho = spm.malstone_b(hist).rho.cpu().numpy()
        for mix, specs in mixes.items():
            batch = encode_query_batch(specs, weeks, num_sites)
            nm = torch.from_numpy(batch.num_masks).to(device)
            dm = torch.from_numpy(batch.den_masks).to(device)
            got = [torch.from_numpy(getattr(a, f)).to(device)
                   for f in ("rho", "num", "den") for a in answers[mix]]
            n = len(specs)
            got = [torch.stack(got[i * n:(i + 1) * n]) for i in range(3)]
            k5_exact(f"{backend} {mix}: the answers",
                     got, wr.masked_window_ratio_plain(hist, nm, dm))
            if mix == "growing":
                for i, a in enumerate(answers[mix]):
                    check((a.rho.view("int32")
                           == b_rho[:, i].view("int32")).all(),
                          f"{backend}: growing B answer {i} != malstone_b")
                k5_inputs = (hist, nm, dm)
            else:
                a = answers[mix][3]                # B over the year, top-8
                order = (-a.rho).argsort(kind="stable")[:8]
                check((a.top_sites == order).all(),
                      f"{backend}: top-k {a.top_sites} != stable order "
                      f"{order}")
        row = {"steps": n_steps,
               "records": nodes * n_steps * chunk,
               "ingest_ms": ingest_ms,
               "ingest_ms_pct": percentiles(ingest_ms[1:] or ingest_ms),
               "records_per_s": nodes * chunk / (
                   statistics.median(ingest_ms[1:] or ingest_ms) / 1e3),
               "peak_bytes": peak, "allocated_before_bytes": base}
        for mix, specs in mixes.items():
            lat = timed_samples(lambda: svc.query(specs), QUERY_BATCHES,
                                device)
            sync(device)
            t0 = time.perf_counter()
            tickets = [svc.submit(specs) for _ in range(QUERY_BATCHES)]
            for t in tickets:
                svc.wait(t)
            wall = time.perf_counter() - t0
            row[f"query_{mix}_ms_pct"] = percentiles(lat)
            row[f"sustained_{mix}_queries_per_s"] = (
                len(specs) * QUERY_BATCHES / wall)
        row["stage_ms"] = serve_stages(svc, cfg, chunk, mixes, device)
        log("serve", f"{backend}: " + json.dumps(row))
        if cuda:
            def window():
                svc.reset()
                svc.ingest_chunks(1)
                svc.query(mixes["mixed"])
            profile(window, device, top=6)
        del svc
    log("serve", "the resident snapshot of every backend equals the "
                 "streaming engine and the one-shot counting run; every "
                 "ingest step launched K6 twice a node, every B result K7 "
                 f"once ({k7_launches} in all), every batch launched K5 "
                 "once and equals its plain version")
    return k5_at_service_shapes(device, k5_inputs, k5_launches)


def serve_stages(svc, cfg, chunk: int, mixes: dict, device) -> dict:
    """Each layer of one ingest step and one query batch, timed on its
    own: generating the step's chunks, folding them (the backend's
    dataflow), the snapshot; encoding a batch on the host, its device work
    (``batched_query``: K5, the top-k sort, the drill-down gather), and
    decoding it (the copy to the host)."""
    from repro_torch.core.streaming import fold_chunk, snapshot, state_init
    from repro_torch.malgen import generate_chunks
    from repro_torch.serve import (
        batched_query,
        decode_answers,
        encode_query_batch,
    )

    stage, box = {}, {}

    def timed(name, key, fn):
        stage[name] = time_ms(lambda: box.__setitem__(key, fn()), device,
                              iters=1, warmup=0)

    ids = [d * svc.cpd for d in range(svc.parts)]
    timed("generate", "chunk",
          lambda: generate_chunks(svc.seed, cfg, ids, chunk))
    state = state_init(svc.backend, svc.parts, svc.s_pad, svc.num_weeks,
                       device)
    timed("fold", "state", lambda: fold_chunk(
        state, box["chunk"], backend=svc.backend, s_pad=svc.s_pad,
        num_weeks=svc.num_weeks, plan=svc.plan))
    timed("snapshot", "snap", lambda: snapshot(
        box["state"], backend=svc.backend, s_pad=svc.s_pad,
        num_weeks=svc.num_weeks))
    hist = svc.snapshot()[0]
    for mix, specs in mixes.items():
        sync(device)
        t0 = time.perf_counter()
        batch = encode_query_batch(specs, svc.num_weeks, svc.num_sites)
        args = [torch.from_numpy(x).to(device) for x in
                (batch.num_masks, batch.den_masks, batch.sites)]
        sync(device)
        stage[f"encode_{mix}"] = (time.perf_counter() - t0) * 1e3
        timed(f"query_{mix}", "out", lambda: batched_query(
            hist, *args, max_top_k=batch.max_top_k))
        t0 = time.perf_counter()
        decode_answers(batch, box["out"])
        stage[f"decode_{mix}"] = (time.perf_counter() - t0) * 1e3
    return stage


def k5_at_service_shapes(device, inputs, launches: int) -> dict:
    """K5 timed on the service's full-width snapshot with the growing batch
    (N = 52), the mixed batch's size (N = 9, its first 9 masks) and 52
    alternating-week masks (26 runs each, the worst shape): on the device
    (calls replayed as a CUDA graph), with the wrapper's host work and
    cold (each call after the 41.6 MB snapshot was evicted from the L2),
    beside the first design and a matmul yardstick in the same call."""
    from repro_torch.kernels.windowed_ratio import ops as wr

    fd = first_designs()
    hist, nm, dm = inputs
    s, w, _ = hist.shape
    weeks = torch.arange(w, device=hist.device)
    alt = ((weeks[None, :] + torch.arange(52, device=hist.device)[:, None])
           % 2 == 0).contiguous()
    extra = {}

    def library(nmask, dmask):
        # one batched f32 matmul of both mask sets with both count columns
        # (exact below 2^24; the ratio is left out)
        masks = torch.stack([dmask, nmask]).float()
        cols = hist.permute(2, 1, 0).float()
        return lambda: torch.bmm(masks, cols)

    for key, a, b in (("n52", nm, dm), ("n9", nm[:9].contiguous(),
                                        dm[:9].contiguous()),
                      ("alternating", alt, alt)):
        n = a.shape[0]
        got = wr.masked_window_ratio(hist, a, b)
        err = k5_exact(f"K5 service shapes {key}", got,
                       wr.masked_window_ratio_plain(hist, a, b))
        k5_exact(f"K5 first design {key}", fd.masked_window_ratio(hist, a, b),
                 got)
        runs = sum(int(((m[:, 1:] != m[:, :-1]).sum() + m[:, 0].sum()
                        + m[:, -1].sum()) // 2) for m in (a, b))
        # ms: the device's time (a CUDA graph of the calls); a call's host
        # work (checks, allocations, two launches) is 40-70 us, so events
        # around repeated wrapper calls (wrapper_ms) time the host at N = 9
        extra[key] = dict(
            ms=graph_ms(lambda: wr.masked_window_ratio(hist, a, b), device),
            wrapper_ms=time_ms(lambda: wr.masked_window_ratio(hist, a, b),
                               device, 20, 3),
            cold_ms=cold_ms(lambda: wr.masked_window_ratio(hist, a, b),
                            device),
            first_design_ms=graph_ms(lambda: fd.masked_window_ratio(
                hist, a, b), device),
            plain_ms=time_ms(lambda: wr.masked_window_ratio_plain(
                hist, a, b), device, 3, 1),
            library_ms=graph_ms(library(a, b), device),
            bytes=4 * s * w * 2 + 2 * n * w + 12 * n * s,
            # the running sums of both channels, a subtract and an add per
            # run and site, one divide per answer
            ops=2 * s * w + 2 * runs * s + n * s, runs=runs, err=err)
    main = extra.pop("n52")
    for e in extra.values():
        e["bound_ms"] = max(e.pop("bytes") / HBM_BYTES_PER_S,
                            e.pop("ops") / OPS32_PER_S) * 1e3
        e.pop("err")
    return kernel_row(
        "windowed_ratio.masked", launches, main.pop("err"), main.pop("ms"),
        main.pop("plain_ms"), main.pop("library_ms"), main.pop("bytes"),
        ops=main.pop("ops"), shape="S=100000 W=52 N=52 (growing)", **main,
        n9=extra["n9"], alternating_n52=extra["alternating"])


# ------------------------------------------------------------- phase 8
def k6_case(seed: int, n: int, s: int, device):
    """A CDF with runs of equal entries (zero-weight sites) and draws on
    and between its entries, with NaN, +-inf, -0.0, 0.0, 1.0 and 2.0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.rand(s, generator=g)
    w[torch.rand(s, generator=g) < 0.3] = 0
    cdf = torch.cumsum(w, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-30)
    u = torch.rand(n, generator=g)
    on = torch.rand(n, generator=g) < 0.3
    u[on] = cdf[torch.randint(0, s, (int(on.sum()),), generator=g)]
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                          0.0, 1.0, 2.0])
    k = min(n, len(edges))
    u[torch.randperm(n, generator=g)[:k]] = edges[:k]
    return u.to(device), cdf.to(device)


def k7_outputs(out):
    """K7's outputs with rho as its bits, for ``exact``."""
    return (out[0].view(torch.int32), out[1], out[2])


def k6_malgen_cdfs(device) -> dict:
    """The marked and unmarked CDFs of ``MalGenConfig()`` (seed 0): permuted
    power laws restricted to a mask, so with leading zero entries, runs of
    equal entries and a last run of 1.0."""
    from repro_torch.malgen import MalGenConfig, make_seed

    seed = make_seed(0, MalGenConfig(), NODES << 20, device=device)
    return {"marked": seed.marked_cdf, "unmarked": seed.unmarked_cdf}


def k6_cases(device):
    """(name, u, cdf) of K6's edge cases beyond ``k6_case``: the MalGen
    CDFs with uniform draws, draws on their entries and on the guide's
    bucket edges b / 2^13, at 2^20 + 3 draws (the table) and 100,003 (the
    direct search), and u at an offset of one float (no 16-byte loads); a
    CDF whose last entry is 0.75; one with entries from -0.5 to 2.0."""
    g = torch.Generator(device="cpu").manual_seed(9)
    out = []
    for name, cdf in k6_malgen_cdfs(device).items():
        s = cdf.shape[0]
        for n in ((1 << 20) + 3, 100_003):
            u = torch.rand(n, generator=g)
            on = torch.rand(n, generator=g) < 0.2
            u[on] = cdf.cpu()[torch.randint(0, s, (int(on.sum()),),
                                            generator=g)]
            edge = torch.rand(n, generator=g) < 0.1
            u[edge] = torch.randint(0, 1 << 13, (int(edge.sum()),),
                                    generator=g).float() / (1 << 13)
            u = u.to(device)
            out.append((f"MalGen {name} n={n}", u, cdf))
            out.append((f"MalGen {name} n={n - 1}, u offset by 4 bytes",
                        u[1:], cdf))
    for n in (1000, (1 << 20) + 1):
        u, cdf = k6_case(n, n, 5000, device)
        out.append((f"last entry 0.75 n={n}", u, cdf * 0.75))
        u = torch.rand(n, generator=g).to(device) * 3 - 1
        out.append((f"entries in [-0.5, 2] n={n}", u,
                    torch.linspace(-0.5, 2.0, 5000, device=device)))
    return out


def k7_cases(device):
    """(name, hist) of K7's edge cases: W in {1, 2, 31, 32, 33, 52, 64, 65,
    130} (odd W takes 4-byte loads, W > 64 more than one chunk), S in {1,
    7, 1001} (no multiple of a block's 8 sites), counts below 1000, above
    2^24 and past 2^31, zero weeks and empty sites; S = 100,000 at W = 52;
    and histograms at an offset of one int (no 16-byte loads)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    out = []
    for w in (1, 2, 31, 32, 33, 52, 64, 65, 130):
        for s in (1, 7, 1001):
            for high in (1000, 1 << 20, 1 << 27):
                hist = torch.randint(0, high, (s, w, 2), generator=g,
                                     dtype=torch.int32)
                hist[torch.rand(s, generator=g) < 0.2] = 0
                hist[:, torch.rand(w, generator=g) < 0.2] = 0
                out.append((f"S={s} W={w} high={high}", hist.to(device)))
    out.append(("S=100000 W=52", torch.randint(
        0, 1000, (100_000, 52, 2), generator=g, dtype=torch.int32)
        .to(device)))
    for w in (52, 33):
        flat = torch.randint(0, 1 << 27, (1 + 999 * w * 2,), generator=g,
                             dtype=torch.int32).to(device)
        out.append((f"S=999 W={w} offset by 4 bytes",
                    flat[1:].view(999, w, 2)))
    return out


def k6_k7_edge_cases(device) -> dict:
    """K6 at S in {1, 7, 2048, 100,000} and n in {1, 1023, 2^18 - 1, 2^18,
    2^23} (both sides of its direct-search threshold), and on
    ``k6_cases``; K7 on ``k7_cases`` (a wrapped denominator gives rho 0).
    Both bit-equal to their plain versions. Also whether
    ``torch.searchsorted`` (K6's library yardstick) gives the same sites
    on the card, NaN draws included."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.kernels.windowed_ratio import ops as wr

    library_equal = True
    cases = []
    for s in (1, 7, 2048, 100_000):
        for n in (1, 1023, (1 << 18) - 1, 1 << 18, RPS):
            cases.append((f"S={s} n={n}",) + k6_case(s * 31 + n, n, s,
                                                     device))
    cases += k6_cases(device)
    for name, u, cdf in cases:
        got = ps.powerlaw_sample(u, cdf)
        exact(f"K6 {name}", got, ps.powerlaw_sample_plain(u, cdf))
        s = cdf.shape[0]
        lib = torch.searchsorted(cdf, u, right=True).clamp(0, s - 1)
        library_equal &= bool(torch.equal(lib.to(torch.int32), got))
        check(int(got[torch.isnan(u)].ne(s - 1).sum()) == 0,
              f"K6 {name}: a NaN draw did not give S-1")
    k7 = k7_cases(device)
    for name, hist in k7:
        got = wr.windowed_ratio(hist)
        exact(f"K7 {name}", k7_outputs(got),
              k7_outputs(wr.windowed_ratio_plain(hist)))
        big = hist.shape[0] == 1001 and hist.shape[1] >= 52
        if big and "high=1048576" in name:
            check(int(got[1].max()) > 1 << 24, f"K7 {name}: no sum above "
                                               f"2^24")
        if big and "high=134217728" in name:
            wrapped = got[1] <= 0
            check(bool(wrapped.any()), f"K7 {name}: no sum wrapped past "
                                       f"2^31")
            check(not bool(got[0][wrapped].any()),
                  f"K7 {name}: rho != 0 where the wrapped denominator is "
                  f"<= 0")
    log("kernel", f"K6 bit-equal to plain on {len(cases)} cases, K7 on "
                  f"{len(k7)}; torch.searchsorted equal to K6 on the card: "
                  f"{library_equal}")
    return {"k6_library_equal": library_equal}


def k6_timings(device, seed, cfg) -> dict:
    """K6 on the MalGen unmarked CDF at a node's unmarked draws of the
    main path, and at a service step's chunk (2^20 records: the marked
    and unmarked draws on their CDFs), against its first design and the
    library call. ``ms`` and ``library_ms`` are CUDA events around repeated
    calls, the wrapper's and ``torch.searchsorted``'s host work included;
    ``graph_ms`` the device alone."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.malgen.seeding import chunk_marked_records

    fd = first_designs()
    g = torch.Generator(device=device).manual_seed(6)
    n_marked = chunk_marked_records(cfg, SERVE_CHUNK)
    shapes = {
        "malgen_unmarked_node": (
            seed.unmarked_cdf,
            RPS - len(range(0, seed.num_marked_events, NODES))),
        "service_marked": (seed.marked_cdf, n_marked),
        "service_unmarked": (seed.unmarked_cdf, SERVE_CHUNK - n_marked)}
    out = {}
    for key, (cdf, n) in shapes.items():
        u = torch.rand(n, generator=g, device=device)
        got = ps.powerlaw_sample(u, cdf)
        exact(f"K6 {key}", got, ps.powerlaw_sample_plain(u, cdf))
        exact(f"K6 first design {key}", fd.powerlaw_sample(u, cdf), got)

        def library():
            return torch.searchsorted(cdf, u, right=True).clamp(
                0, cdf.shape[0] - 1).to(torch.int32)

        out[key] = dict(
            n=n, ms=time_ms(lambda: ps.powerlaw_sample(u, cdf), device, 20,
                            3),
            graph_ms=graph_ms(lambda: ps.powerlaw_sample(u, cdf), device),
            first_design_ms=graph_ms(lambda: fd.powerlaw_sample(u, cdf),
                                     device),
            library_ms=time_ms(library, device, 20, 3),
            library_graph_ms=graph_ms(library, device),
            bound_ms=(8 * n + 4 * cdf.shape[0]) / HBM_BYTES_PER_S * 1e3)
        log("kernel", f"K6 {key}: " + json.dumps(out[key]))
    return out


def bench_kernel_pairs(device, edge: dict, mp: dict) -> list:
    """The six ``kernel_*`` scenarios at full width through
    ``run_scenarios``, each with the launch counts set to 0 just before it
    and read just after; each kernel against its plain version on the
    same inputs; K6 and K7 timed (K6 also by ``k6_timings``). Returns their
    kernels-line entries, whose launches are the main path's (phase 3)."""
    from repro_torch.bench import registry, schema
    from repro_torch.bench.run import run_scenarios
    from repro_torch.kernels import launch_counts, reset_launch_counts

    scale = registry.Scale(**BENCH_KERNELS)
    ctx = registry.BenchContext(nodes=NODES, device=device)
    doc = schema.new_document("torch_kernel_pairs", device=device)
    launches = {}
    for kernel in registry.KERNELS:
        for path in registry.KERNEL_PATHS:
            name = f"kernel_{kernel}_{path}"
            sync(device)
            reset_launch_counts()
            run_scenarios([name], scale, ctx, doc)
            sync(device)
            got = launch_counts()
            want = dict.fromkeys(got, 0)
            if path == "pallas":
                check(got[kernel] > 0, f"{name}: {kernel} not launched")
                want[kernel] = got[kernel]
            check(got == want, f"{name}: launches {got}")
            launches[name] = got[kernel]
    rows = schema.results_by_scenario(doc)
    log("bench", "kernel pairs (us/call, records/s): " + json.dumps(
        {n: (r["us_per_call"], r["records_per_s"]) for n, r in rows.items()}))

    fd = first_designs()
    entries = []
    for kernel in registry.KERNELS:
        args = registry._kernel_inputs(scale, kernel, device)
        fast, plain = registry.kernel_fns(kernel, scale)
        got, want = fast(*args), plain(*args)
        if kernel == "windowed_ratio":
            got, want = k7_outputs(got), k7_outputs(want)
        err = exact(f"{kernel} at the bench's full width", got, want)
        bench = dict(bench_launches=launches[f"kernel_{kernel}_pallas"],
                     bench_us={p: rows[f"kernel_{kernel}_{p}"]["us_per_call"]
                               for p in registry.KERNEL_PATHS})
        if kernel == "powerlaw_sample":
            u, cdf = args
            n, s = u.shape[0], cdf.shape[0]
            exact("K6 first design at the bench's full width",
                  fd.powerlaw_sample(u, cdf), got)
            entries.append(kernel_row(
                kernel, mp["launches"][kernel], err,
                time_ms(lambda: fast(u, cdf), device, 20, 3),
                time_ms(lambda: plain(u, cdf), device, 10, 2),
                time_ms(lambda: torch.searchsorted(cdf, u, right=True)
                        .clamp(0, s - 1), device, 20, 3),
                4 * n + 4 * n + 4 * s,
                ops=n * s.bit_length(),    # search steps
                shape=f"n={n} S={s} (the bench's sorted CDF)",
                graph_ms=graph_ms(lambda: fast(u, cdf), device),
                first_design_ms=time_ms(lambda: fd.powerlaw_sample(u, cdf),
                                        device, 20, 3),
                library_equal_on_card=edge["k6_library_equal"],
                **k6_timings(device, mp["seed"], mp["cfg"]), **bench))
        elif kernel == "windowed_ratio":
            (hist,) = args
            s, w, _ = hist.shape
            exact("K7 first design at the bench's full width",
                  k7_outputs(fd.windowed_ratio(hist)), got)
            entries.append(kernel_row(
                kernel, mp["launches"][kernel], err,
                time_ms(lambda: fast(hist), device, 20, 3),
                time_ms(lambda: plain(hist), device, 10, 2),
                time_ms(lambda: torch.cumsum(hist, dim=1,
                                             dtype=torch.int32),
                        device, 20, 3),
                20 * s * w, ops=3 * s * w, shape=f"S={s} W={w}",
                library="torch.cumsum of both channels, no ratio",
                graph_ms=graph_ms(lambda: fast(hist), device),
                first_design_ms=time_ms(lambda: fd.windowed_ratio(hist),
                                        device, 20, 3),
                cold_ms=cold_ms(lambda: fast(hist), device), **bench))
        else:
            log("bench", f"K4 at the bench's [1, {scale.records_per_node}] "
                         f"uniform columns equals its plain version; "
                         f"launches {bench['bench_launches']}, us/call "
                         f"{bench['bench_us']}")
    return entries


def bench_smoke(device) -> None:
    """The port's smoke selection at the full widths and a reduced depth,
    through ``run_scenarios`` into a document that must validate and
    compare clean against itself."""
    import tempfile

    from repro_torch.bench import compare, registry, schema
    from repro_torch.bench.run import run_scenarios

    scale = registry.Scale(**BENCH_SMOKE)
    ctx = registry.BenchContext(nodes=NODES, device=device)
    names = registry.preset_scenario_names("smoke")
    doc = schema.new_document("torch_smoke_chip", preset="smoke",
                              device=device)
    t0 = time.perf_counter()
    skipped = run_scenarios(names, scale, ctx, doc)
    wall = time.perf_counter() - t0
    check(not skipped and len(doc["results"]) == len(names) == 38,
          f"smoke selection: {len(doc['results'])} rows, skipped {skipped}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        path = schema.write_document(doc, pathlib.Path(tmp) / "BENCH.json")
        schema.load_document(path)
        code = compare.main([str(path), str(path)])
        check(code == 0, f"compare of the smoke document with itself "
                         f"exited {code}")
    rates = {r["scenario"]: r.get("records_per_s") for r in doc["results"]}
    qps = {r["scenario"]: r["derived"]["queries_per_s"]
           for r in doc["results"]
           if "queries_per_s" in (r.get("derived") or {})}
    log("bench", f"smoke: {len(doc['results'])} scenarios in {wall:.1f} s; "
                 f"the document validates and compares clean against "
                 f"itself")
    log("bench", "records/s " + json.dumps(rates))
    log("bench", "queries/s " + json.dumps(qps))


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
        kernels.append(other_backends(device, NODES, RPS))
        card_equals_cpu(device, NODES, EQ_RPS)
        k5_edge_cases(device)
        kernels.append(serving(device, NODES, SERVE_CHUNK, SERVE_STEPS,
                               SERVE_SMALL_STEPS))
        t8 = time.perf_counter()
        edge = k6_k7_edge_cases(device)
        kernels += bench_kernel_pairs(device, edge, mp)
        bench_smoke(device)
        log("bench", f"phase 8 took {time.perf_counter() - t8:.1f} s")
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
