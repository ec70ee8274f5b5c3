#!/usr/bin/env python3
"""Time the order kernels K1 and K2, the query kernel K5, the sampler K6
and the finalizer K7 of this checkout against another checkout on the
same card, in turns.

    python3 tools/kernel_turns.py [--other DIR] [--out FILE]

Needs a CUDA device. Generates the counting main path's records on the
card (``MalGenConfig()`` defaults: 100,000 sites, alpha 1.2; 8 nodes x
2^23 records; seed 0) and times, each after checking it against its plain
version or the stable-argsort oracle:

- ``K1``: ``count_tiles`` of the destinations ``site % 8`` into 9 counters
  a tile; ``tile_bases``: the torch glue between K1 and K2;
- ``K2``: ``scatter_tiles`` of the packed words, given those bases;
  ``count_scatter``: K1, the glue and K2 as the exchange calls them;
- ``K5``: ``masked_window_ratio`` over the records' ``[100,000, 52, 2]``
  histogram with the service's growing batch (N = 52), its first 9
  masks (the mixed batch's size) and 52 alternating-week masks (26 runs
  each, the worst shape), warm (repeated calls) and cold (each call after
  a 256 MB write has evicted the 50 MB L2);
- ``K6``: ``powerlaw_sample`` of n in {2^17, 2^20, 2^23} uniform draws on
  the bench's sorted 100,000-site CDF and on the records' unmarked MalGen
  CDF; ``sample_sites``: the checkout's MalGen sampler on the same inputs
  (K6 where it routes there, ``torch.searchsorted`` where it does not);
  ``generate``: the main path's generation of all 8 shards, the part of a
  batch run that samples sites;
- ``K7``: ``windowed_ratio`` of the records' ``[100,000, 52, 2]``
  histogram; ``malstone_b``: the checkout's MalStone B finalize of it;
- ``first design``: the same inputs through ``tools/first_designs.py``
  (the first K2 design with its own tile, and the first K5, K6 and K7
  designs);
- ``library``: a stable ``torch.sort`` and gather (K2's yardstick), a
  ``torch.bmm`` of f32 masks and counts (K5's), ``torch.searchsorted``
  with the clamp (K6's) and ``torch.cumsum`` of both channels (K7's).

With ``--other DIR`` (a checkout's root, e.g. the parent commit unpacked
with ``git archive``), the measurement runs four times, each in a fresh
process on the same card, in turns: DIR, this checkout, this checkout,
DIR. Every result is a JSON line ``{"checkout", "turn", "input", "name",
"ms": [3 samples], "graph_ms": [3 samples]}``: ``ms`` from CUDA events
around repeated calls (the wrappers' host work included), ``graph_ms``
from the same calls replayed as a CUDA graph (device time alone); the
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODES, RPS, SEED, WEEKS = 8, 1 << 23, 0, 52
EVICT_BYTES = 256 << 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, samples: int = 3, iters: int = 20) -> list:
    """``samples`` means of ``iters`` calls each, CUDA events around them,
    after three warm-up calls."""
    for _ in range(3):
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


def graph_ms(fn, samples: int = 3, iters: int = 20) -> list:
    """``samples`` replays of ``iters`` calls captured in one CUDA graph,
    per call: the device's time without the wrappers' host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def cold_ms(fn, samples: int = 3, calls: int = 5) -> list:
    """``samples`` medians of ``calls`` single calls, each timed alone
    with CUDA events right after a write of EVICT_BYTES has pushed its
    inputs out of the L2."""
    scratch = torch.empty(EVICT_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    out = []
    for _ in range(samples):
        one = []
        for _ in range(calls):
            scratch.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            one.append(start.elapsed_time(end))
        out.append(statistics.median(one))
    return out


def main_path_inputs(dev):
    """(words, dest, hist, growing masks, seed) of the counting main
    path."""
    from repro_torch.common.types import pack_site_week_mark
    from repro_torch.launch.serve_malstone import build_query_mix
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed
    from repro_torch.serve import encode_query_batch

    cfg = MalGenConfig()
    seed = make_seed(SEED, cfg, NODES * RPS, device=dev)
    lg = generate_shards_device(seed, cfg, NODES, RPS, device=dev)
    dest = (lg.site_id % NODES).to(torch.int32).contiguous()
    words = pack_site_week_mark(lg.site_id, lg.week(), lg.mark,
                                lg.valid_mask()).contiguous()
    ok = lg.valid_mask()
    key = (lg.site_id.to(torch.int64) * WEEKS + lg.week())[ok]
    cells = cfg.num_sites * WEEKS
    hist = torch.stack([
        torch.bincount(key, minlength=cells),
        torch.bincount(key[(lg.mark > 0)[ok]], minlength=cells)],
        dim=-1).to(torch.int32).reshape(cfg.num_sites, WEEKS, 2)
    batch = encode_query_batch(
        build_query_mix("growing", num_sites=cfg.num_sites, top_k=8),
        WEEKS, cfg.num_sites)
    masks = (torch.from_numpy(batch.num_masks).to(dev),
             torch.from_numpy(batch.den_masks).to(dev))
    return words, dest, hist.contiguous(), masks, seed


def measure(checkout: str, turn: int, emit) -> None:
    sys.path.insert(0, str(ROOT / "tools"))
    import first_designs as fd
    from repro_torch.kernels.count_scatter import count_scatter_ref
    from repro_torch.kernels.count_scatter import ops as cs
    from repro_torch.kernels.windowed_ratio import ops as wr

    dev = torch.device("cuda")
    words, dest, hist, (grow_n, grow_d), seed = main_path_inputs(dev)

    def row(inp, name, fn, **extra):
        emit({"checkout": checkout, "turn": turn, "input": inp, "name": name,
              "ms": time_ms(fn), "graph_ms": graph_ms(fn), **extra})

    def same(got, want, what):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise SystemExit(f"{checkout}: {what} differs")

    # K1, the glue, K2
    d = NODES + 1
    inp = f"[{NODES}, 2^23] to {d} destinations"
    counts = cs.count_tiles(dest, d)
    same(counts, cs.count_tiles_plain(dest, d), "K1")
    base, _ = cs.tile_bases(counts)
    want, _ = count_scatter_ref(words, dest, NODES)
    same(cs.scatter_tiles(words, dest, base), want, "K2")
    same(cs.count_scatter(words, dest, NODES)[0], want, "count_scatter")
    fbase = fd.tile_bases(fd.count_tiles(dest, d))
    same(fd.scatter_tiles(words, dest, fbase), want, "K2 first design")
    row(inp, "K1", lambda: cs.count_tiles(dest, d), tile=cs.TILE)
    row(inp, "K1 first design", lambda: fd.count_tiles(dest, d),
        tile=fd.TILE)
    row(inp, "tile_bases", lambda: cs.tile_bases(counts))
    row(inp, "K2", lambda: cs.scatter_tiles(words, dest, base),
        cold_ms=cold_ms(lambda: cs.scatter_tiles(words, dest, base)))
    row(inp, "K2 first design", lambda: fd.scatter_tiles(words, dest, fbase))
    row(inp, "count_scatter", lambda: cs.count_scatter(words, dest, NODES))

    def library_sort():
        order = torch.sort(dest, dim=1, stable=True).indices
        return words.gather(1, order)

    emit({"checkout": checkout, "turn": turn, "input": inp,
          "name": "K2 library", "ms": time_ms(library_sort, iters=5)})
    del counts, base, fbase, want, words, dest

    # K5
    weeks = torch.arange(WEEKS, device=dev)
    alt = ((weeks[None, :] + torch.arange(52, device=dev)[:, None]) % 2
           == 0).contiguous()
    for inp, nm, dm in (("growing N=52", grow_n, grow_d),
                        ("growing N=9", grow_n[:9].contiguous(),
                         grow_d[:9].contiguous()),
                        ("alternating N=52", alt, alt)):
        got = wr.masked_window_ratio(hist, nm, dm)
        same(got, wr.masked_window_ratio_plain(hist, nm, dm), f"K5 {inp}")
        same(fd.masked_window_ratio(hist, nm, dm), got,
             f"K5 first design {inp}")
        row(inp, "K5", lambda: wr.masked_window_ratio(hist, nm, dm),
            cold_ms=cold_ms(lambda: wr.masked_window_ratio(hist, nm, dm)))
        row(inp, "K5 first design",
            lambda: fd.masked_window_ratio(hist, nm, dm))
        masks = torch.stack([dm, nm]).float()
        cols = hist.permute(2, 1, 0).float()
        row(inp, "K5 library", lambda: torch.bmm(masks, cols))

    # K6, the MalGen sampler and the generation
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import power_law_cdf, power_law_weights
    from repro_torch.malgen import sample_sites

    g = torch.Generator(device=dev).manual_seed(2)
    cdfs = {"sorted": power_law_cdf(power_law_weights(100_000, device=dev)),
            "MalGen unmarked": seed.unmarked_cdf}
    for cname, cdf in cdfs.items():
        for n in (1 << 17, 1 << 20, 1 << 23):
            inp = f"{cname} CDF, n=2^{n.bit_length() - 1}"
            u = torch.rand(n, generator=g, device=dev)
            got = ps.powerlaw_sample(u, cdf)
            same(got, ps.powerlaw_sample_plain(u, cdf), f"K6 {inp}")
            same(fd.powerlaw_sample(u, cdf), got, f"K6 first design {inp}")
            same(sample_sites(cdf, u), got, f"sample_sites {inp}")
            row(inp, "K6", lambda: ps.powerlaw_sample(u, cdf))
            row(inp, "K6 first design", lambda: fd.powerlaw_sample(u, cdf))
            row(inp, "sample_sites", lambda: sample_sites(cdf, u))
            row(inp, "K6 library", lambda: torch.searchsorted(
                cdf, u, right=True).clamp(0, cdf.shape[0] - 1).to(
                torch.int32))
    cfg = MalGenConfig()
    emit({"checkout": checkout, "turn": turn,
          "input": f"{NODES} x 2^23 records", "name": "generate",
          "ms": time_ms(lambda: generate_shards_device(
              seed, cfg, NODES, RPS, device=dev), iters=3)})

    # K7 and the MalStone B finalize
    from repro_torch.core import spm

    inp = "[100,000, 52, 2] histogram"
    got = wr.windowed_ratio(hist)
    same(got, wr.windowed_ratio_plain(hist), "K7")
    same(fd.windowed_ratio(hist), got, "K7 first design")
    b = spm.malstone_b(hist)
    same((b.rho, b.total, b.marked), got, "malstone_b")
    row(inp, "K7", lambda: wr.windowed_ratio(hist),
        cold_ms=cold_ms(lambda: wr.windowed_ratio(hist)))
    row(inp, "K7 first design", lambda: fd.windowed_ratio(hist))
    row(inp, "malstone_b", lambda: spm.malstone_b(hist))
    row(inp, "K7 library", lambda: torch.cumsum(hist, dim=1,
                                                 dtype=torch.int32))


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
        print("kernel_turns: no CUDA device", file=sys.stderr)
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
                print(f"kernel_turns: turn {turn} ({name}) exited "
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
