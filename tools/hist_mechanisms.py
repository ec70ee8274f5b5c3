#!/usr/bin/env python3
"""Where the histogram kernels K3 and K4 spend their time on the card,
mechanism by mechanism, against another checkout on the same card.

    python3 tools/hist_mechanisms.py [--other DIR] [--out FILE]

Needs a CUDA device. Generates the counting main path's records on the
card (``MalGenConfig()`` defaults: 100,000 sites, alpha 1.2; 8 nodes x 2^23
records; seed 0) and times, each against its plain version first:

- K4 (``segment_hist``) over the ``[8, 2^23]`` columns into ``[8, 100,000,
  52, 2]``, over the first 2^20 records of each row (a service ingest
  step's chunk) and over the columns with sites drawn uniformly;
- K3 (``segment_hist_packed_words``) over round 0's ``[8, 8 x 2,097,152]``
  shipped words into ``[8, 12,500, 52, 2]``, and over the words of the
  uniform-site columns.

Each input goes through these variants (``name`` in the output):

- ``kernel``: the wrapper as the program calls it;
- ``interleaved``: the same wrapper over one row that holds the P rows'
  records interleaved (record i of row p at i * P + p, its site moved to p *
  S + site): the same cells, with all nodes' copies of a hot cell in flight
  at once instead of one node's (block order alone);
- ``aggregation``: one thread a record, as the first version, with the
  equal cells of a warp combined by ``__match_any_sync`` into one global
  atomic (warp aggregation alone; its source is below);
- ``no tile`` (checkouts whose wrappers take a hot list): the histogram
  launch with an empty hot list, so every record takes a global atomic;
- ``bincount``: one ``torch.bincount`` of the same cell keys.

It also counts, per input, the share of records whose site is on the hot
list and the share that a warp-wide combine of equal cells would save.

With ``--other DIR`` (a checkout's root, e.g. the parent commit unpacked
with ``git archive``), the measurement runs four times, each in a fresh
process on the same card, in turns: DIR, this checkout, this checkout,
DIR. Every result is a JSON line ``{"checkout", "turn", "input", "name",
"ms": [3 samples], ...}``; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODES, RPS, CAPACITY_FACTOR, SEED = 8, 1 << 23, 2.0, 0
SERVICE_CHUNK = 1 << 20

# One thread a record, nodes on gridDim.y (the first version's launch),
# with a warp's equal cells combined before the global atomic.
AGGREGATION_SOURCE = r"""
#include <cuda_runtime.h>

__device__ void add_group(int* hist, long long key, bool marked) {
  const unsigned active = __ballot_sync(0xffffffffu, key >= 0);
  if (key < 0) return;
  const unsigned group = __match_any_sync(active, key);
  const unsigned marks = __ballot_sync(active, marked) & group;
  if ((threadIdx.x & 31) == __ffs(group) - 1) {
    atomicAdd(hist + key * 2, __popc(group));
    if (marks) atomicAdd(hist + key * 2 + 1, __popc(marks));
  }
}

__global__ void columns_kernel(const int* site, const int* week,
                               const int* mark, const unsigned char* valid,
                               int* hist, long long n, int num_sites,
                               int num_weeks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long node = blockIdx.y, r = node * n + i;
  long long key = -1;
  bool marked = false;
  if (i < n && valid[r] && site[r] >= 0 && site[r] < num_sites &&
      week[r] >= 0 && week[r] < num_weeks) {
    key = (node * num_sites + site[r]) * num_weeks + week[r];
    marked = mark[r] > 0;
  }
  add_group(hist, key, marked);
}

__global__ void words_kernel(const int* words, int* hist, long long len,
                             int num_parts, int s_local, int num_weeks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const unsigned node = blockIdx.y;
  long long key = -1;
  bool marked = false;
  if (i < len) {
    const unsigned w = (unsigned)words[(long long)node * len + i];
    const unsigned site = w >> 8, week = (w >> 2) & 0x3Fu;
    const unsigned local = site / (unsigned)num_parts;
    if ((w & 1u) && site % (unsigned)num_parts == node &&
        local < (unsigned)s_local && week < (unsigned)num_weeks) {
      key = ((long long)node * s_local + local) * num_weeks + week;
      marked = (w >> 1) & 1u;
    }
  }
  add_group(hist, key, marked);
}

extern "C" int aggregate_columns(const int* site, const int* week,
                                 const int* mark, const unsigned char* valid,
                                 int* hist, long long n, int num_nodes,
                                 int num_sites, int num_weeks, void* stream) {
  dim3 grid((unsigned)((n + 255) / 256), num_nodes);
  columns_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      site, week, mark, valid, hist, n, num_sites, num_weeks);
  return (int)cudaGetLastError();
}

extern "C" int aggregate_words(const int* words, int* hist, long long len,
                               int num_nodes, int num_parts, int s_local,
                               int num_weeks, void* stream) {
  dim3 grid((unsigned)((len + 255) / 256), num_nodes);
  words_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      words, hist, len, num_parts, s_local, num_weeks);
  return (int)cudaGetLastError();
}
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def aggregation_library() -> ctypes.CDLL:
    """Build the aggregation kernels with the port's nvcc flags."""
    from repro_torch.kernels import _build

    digest = hashlib.sha256(AGGREGATION_SOURCE.encode()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"hist_aggregation-{digest.hexdigest()[:16]}"
    if not out.with_suffix(".so").exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        out.with_suffix(".cu").write_text(AGGREGATION_SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out.with_suffix(".so")),
                        str(out.with_suffix(".cu"))], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(out.with_suffix(".so")))
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.aggregate_columns.argtypes = [p, p, p, p, p, q, i, i, i, p]
    lib.aggregate_words.argtypes = [p, p, q, i, i, i, i, p]
    lib.aggregate_columns.restype = lib.aggregate_words.restype = i
    return lib


def time_ms(fn, samples: int = 3, iters: int = 10) -> list:
    """``samples`` means of ``iters`` calls each, CUDA events around them,
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def interleave_columns(cols, num_sites):
    """One row of the P rows' records interleaved, site moved to p * S +
    site (an out-of-range site stays out of range)."""
    p = cols[0].shape[0]
    node = torch.arange(p, device=cols[0].device,
                        dtype=torch.int32).unsqueeze(1)
    ok = (cols[0] >= 0) & (cols[0] < num_sites)
    site = torch.where(ok, cols[0] + node * num_sites, -1)
    return [c.t().contiguous().reshape(1, -1)
            for c in (site.to(torch.int32),) + tuple(cols[1:])]


def interleave_words(words, s_local, num_weeks):
    """One row of words holding row p's owned words as sites p * S_local +
    local (P = 1), the others as zero words, interleaved by record."""
    from repro_torch.common.types import unpack_site_week_mark

    p = words.shape[0]
    site, week, mark, valid = unpack_site_week_mark(words)
    node = torch.arange(p, device=words.device).unsqueeze(1)
    local = site // p
    ok = (valid & (site % p == node) & (local < s_local)
          & (week < num_weeks))
    new = (((node * s_local + local) << 8) | (week << 2) | (mark << 1) | 1)
    new = torch.where(ok, new, 0)
    new = torch.where(new >= 2**31, new - 2**32, new).to(torch.int32)
    return new.t().contiguous().reshape(1, -1)


def warp_savings(keys: torch.Tensor) -> float:
    """Share of counted records a warp-wide combine of equal cells saves
    (records minus distinct cells in each aligned group of 32)."""
    flat = keys.reshape(-1)
    flat = flat[: flat.numel() // 32 * 32].reshape(-1, 32)
    srt = flat.sort(dim=1).values
    counted = srt >= 0
    dup = (srt[:, 1:] == srt[:, :-1]) & counted[:, 1:]
    return float(dup.sum()) / max(1, int(counted.sum()))


def measure(checkout: str, turn: int, emit) -> None:
    from repro_torch.common.types import WEEKS_PER_YEAR as weeks
    from repro_torch.core.backends.mapreduce import (
        order_words,
        ship_round,
        static_capacity,
    )
    from repro_torch.kernels.segment_hist import ops as sh
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    agg = aggregation_library()
    cfg = MalGenConfig()
    seed = make_seed(SEED, cfg, NODES * RPS, device=dev)
    log = generate_shards_device(seed, cfg, NODES, RPS, device=dev)
    s_pad = -(-cfg.num_sites // NODES) * NODES
    s_local = s_pad // NODES
    g = torch.Generator(device=dev).manual_seed(SEED)
    uniform_site = torch.randint(0, cfg.num_sites, log.site_id.shape,
                                 device=dev, generator=g, dtype=torch.int32)
    capacity = static_capacity(RPS, NODES, CAPACITY_FACTOR)
    tiled = hasattr(sh, "segment_hist_tiled")

    def row(inp, name, ms, **extra):
        emit({"checkout": checkout, "turn": turn, "input": inp, "name": name,
              "ms": ms, **extra})

    def exact(got, want, what):
        if not torch.equal(got, want):
            raise SystemExit(f"{checkout}: {what} differs from its plain "
                             f"version")

    # K4
    for inp, lg in (("K4 malgen", log), ("K4 malgen 2^20 a row",
                                         log.map(lambda c: c[:, :SERVICE_CHUNK]
                                                 .contiguous())),
                    ("K4 uniform", log._replace(site_id=uniform_site))):
        cols = (lg.site_id.contiguous(), lg.week(), lg.mark.contiguous(),
                lg.valid_mask())
        kw = dict(num_sites=s_pad, num_weeks=weeks)
        want = sh.segment_hist_plain(*cols, **kw)
        exact(sh.segment_hist(*cols, **kw), want, inp)
        p, n = cols[0].shape
        node = torch.arange(p, device=dev).unsqueeze(1)
        key = torch.where(cols[3], (node * s_pad + cols[0]) * weeks + cols[1],
                          -1).to(torch.int64)
        extra = {"warp_combine_saves": warp_savings(key)}
        if tiled:
            hot = sh.segment_hist_hot_sites(cols[0], cols[1], cols[3], **kw)
            listed = torch.zeros(p, s_pad, dtype=torch.bool, device=dev)
            for r in range(p):
                listed[r, hot[r, 1:1 + int(hot[r, 0])].long()] = True
            on = listed.gather(1, cols[0].long()) & cols[3]
            extra.update(hot_sites=hot[:, 0].tolist(),
                         hot_share=float(on.sum()) / float(cols[3].sum()))
        row(inp, "kernel", time_ms(lambda: sh.segment_hist(*cols, **kw)),
            **extra)
        inter = interleave_columns(cols, s_pad)
        ikw = dict(num_sites=p * s_pad, num_weeks=weeks)
        exact(sh.segment_hist(*inter, **ikw).reshape(want.shape), want,
              f"{inp} interleaved")
        row(inp, "interleaved", time_ms(lambda: sh.segment_hist(*inter,
                                                                 **ikw)))

        def aggregation():
            hist = torch.zeros_like(want)
            err = agg.aggregate_columns(
                *(c.data_ptr() for c in cols), hist.data_ptr(), n, p, s_pad,
                weeks, stream)
            if err:
                raise SystemExit(f"aggregation kernel: CUDA error {err}")
            return hist

        exact(aggregation(), want, f"{inp} aggregation")
        row(inp, "aggregation", time_ms(aggregation))
        if tiled:
            empty = torch.zeros(p, sh.HOT_LIST, dtype=torch.int32, device=dev)
            exact(sh.segment_hist_tiled(*cols, empty, **kw), want,
                  f"{inp} no tile")
            row(inp, "no tile", time_ms(
                lambda: sh.segment_hist_tiled(*cols, empty, **kw)))
        ok = key >= 0
        keys = torch.cat([key[ok] * 2, key[ok & (cols[2] > 0)] * 2 + 1])
        row(inp, "bincount", time_ms(lambda: torch.bincount(
            keys, minlength=want.numel())))
        del keys, key, inter

    # K3
    for inp, lg in (("K3 malgen", log),
                    ("K3 uniform", log._replace(site_id=uniform_site))):
        words_sorted, starts = order_words(lg, weeks, "counting")
        shipped, _ = ship_round(words_sorted, starts, 0, capacity)
        del words_sorted
        kw = dict(num_sites_local=s_local, num_partitions=NODES,
                  num_weeks=weeks)
        want = sh.segment_hist_packed_words_plain(shipped, **kw)
        exact(sh.segment_hist_packed_words(shipped, **kw), want, inp)
        p, length = shipped.shape
        w = shipped.to(torch.int64) & 0xFFFFFFFF
        site, week = w >> 8, (w >> 2) & 0x3F
        node = torch.arange(p, device=dev).unsqueeze(1)
        own = ((w & 1) == 1) & (site % p == node)
        key = torch.where(own, (node * s_local + site // p) * weeks + week,
                          -1)
        extra = {"warp_combine_saves": warp_savings(key)}
        if tiled:
            hot = sh.segment_hist_packed_hot_sites(shipped, **kw)
            extra["hot_sites"] = hot[:, 0].tolist()
        row(inp, "kernel", time_ms(
            lambda: sh.segment_hist_packed_words(shipped, **kw)), **extra)
        inter = interleave_words(shipped, s_local, weeks)
        ikw = dict(num_sites_local=p * s_local, num_partitions=1,
                   num_weeks=weeks)
        exact(sh.segment_hist_packed_words(inter, **ikw).reshape(want.shape),
              want, f"{inp} interleaved")
        row(inp, "interleaved", time_ms(
            lambda: sh.segment_hist_packed_words(inter, **ikw)))

        def aggregation():
            hist = torch.zeros_like(want)
            err = agg.aggregate_words(shipped.data_ptr(), hist.data_ptr(),
                                      length, p, NODES, s_local, weeks,
                                      stream)
            if err:
                raise SystemExit(f"aggregation kernel: CUDA error {err}")
            return hist

        exact(aggregation(), want, f"{inp} aggregation")
        row(inp, "aggregation", time_ms(aggregation))
        if tiled:
            empty = torch.zeros(p, sh.HOT_LIST, dtype=torch.int32, device=dev)
            exact(sh.segment_hist_packed_words_tiled(shipped, empty, **kw),
                  want, f"{inp} no tile")
            row(inp, "no tile", time_ms(
                lambda: sh.segment_hist_packed_words_tiled(shipped, empty,
                                                           **kw)))
        ok = key >= 0
        mark = ((w >> 1) & 1) == 1
        keys = torch.cat([key[ok] * 2, key[ok & mark] * 2 + 1])
        row(inp, "bincount", time_ms(lambda: torch.bincount(
            keys, minlength=want.numel())))
        del keys, key, inter, shipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=pathlib.Path,
                    help="root of another checkout to time in turns")
    ap.add_argument("--out", type=pathlib.Path,
                    help="also write the JSON lines to this file")
    ap.add_argument("--src", type=pathlib.Path, default=ROOT / "src",
                    help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--checkout", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hist_mechanisms: no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def emit(obj):
        text = json.dumps(obj)
        print(text, flush=True)
        lines.append(text)

    if args.other is None:
        sys.path.insert(0, str(args.src.resolve()))
        if args.turn == 0:
            emit({"card": card_line()})
        measure(args.checkout, args.turn, emit)
    else:
        emit({"card": card_line()})
        turns = [("other", args.other / "src"), ("this", ROOT / "src"),
                 ("this", ROOT / "src"), ("other", args.other / "src")]
        for turn, (name, src) in enumerate(turns, 1):
            done = subprocess.run(
                [sys.executable, __file__, "--src", str(src), "--turn",
                 str(turn), "--checkout", name], capture_output=True,
                text=True, timeout=900)
            sys.stderr.write(done.stderr[-4000:])
            if done.returncode != 0:
                print(f"hist_mechanisms: turn {turn} ({name}) exited "
                      f"{done.returncode}", file=sys.stderr)
                return 1
            for text in done.stdout.splitlines():
                print(text, flush=True)
                lines.append(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
