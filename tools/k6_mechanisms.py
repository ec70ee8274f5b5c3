#!/usr/bin/env python3
"""Where the sampler K6 spends its time on the card, mechanism by
mechanism.

    python3 tools/k6_mechanisms.py [--out FILE]

Needs a CUDA device. Builds variants of
``src/repro_torch/kernels/csrc/powerlaw_sample.cu`` (its constants or a
line replaced, the port's nvcc flags) and times each one as a CUDA graph of
its C entry point (device time, no host work) on:

- the bench's sorted 100,000-site CDF at n = 2^23 (``kernel_powerlaw_
  sample``'s inputs);
- the MalGen CDFs of ``MalGenConfig()`` (seed 0, the counting main path's
  8 x 2^23 records): the unmarked one at a node's unmarked draws and the
  marked one at the marked stream's, and both at a service step's chunk
  of 2^20 records;
- the unmarked CDF at 2^18 +- 1 draws, both sides of the direct-search
  threshold.

The variants (``name`` in the output):

- ``kernel``: the source as it is;
- ``G = 2^12``, ``G = 2^14``: another guide table size;
- ``direct``: every n searched directly, as the first design (no table);
- ``table``: every n through the table (no direct search);
- ``no search``: the brackets taken as the answers (wrong sites; the
  stream of draws and sites with the table alone);
- ``k passes`` (k in 1, 2, 4): at most k search steps a draw (wrong
  sites): what each further step of the lock-step searches costs;
- ``guide only``: the table's build alone;
- ``library``: ``torch.searchsorted`` with the clamp.

Then K6's join pass (``powerlaw_sample_join``) on the streaming step's two
halves of a 2^23-record row, under ``JOIN_VARIANTS``: the source as it is
(``join``, its streams loaded and stored evict-first), three blocks an SM,
the streams through the caches as other loads and stores, and no mark
gather (the entity taken as its mark time: wrong marks, the gather's
cost).

Each variant that computes K6's function is first held bit-equal to the
plain version on every input. Every result is a JSON line ``{"input",
"name", "n", "ms": [3 samples]}``, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "powerlaw_sample.cu"
OUT_DIR = ROOT / "build" / "k6_mechanisms"
NODES, RPS, CHUNK = 8, 1 << 23, 1 << 20

_DIRECT = "constexpr long long kDirect = 1LL << 18;"
_SEARCH = "  for (;;) {\n    float c[4];"


def _passes(k: int):
    return (_SEARCH, _SEARCH.replace("for (;;)",
                                     f"for (int pass = 0; pass < {k}; "
                                     f"++pass)"))


# name: (replacements, computes K6's function)
VARIANTS = {
    "kernel": ((), True),
    "G = 2^12": ((("constexpr int kLogGuide = 13;",
                   "constexpr int kLogGuide = 12;"),), True),
    "G = 2^14": ((("constexpr int kLogGuide = 13;",
                   "constexpr int kLogGuide = 14;"),), True),
    "direct": (((_DIRECT, "constexpr long long kDirect = 1LL << 31;"),),
               True),
    "table": (((_DIRECT, "constexpr long long kDirect = 1;"),), True),
    "no search": (((_DIRECT, "constexpr long long kDirect = 1;"),
                   (_SEARCH, _SEARCH.replace("for (;;)", "while (false)"))),
                  False),
    **{f"{k} passes": (((_DIRECT, "constexpr long long kDirect = 1;"),
                        _passes(k)), False) for k in (1, 2, 4)},
    "guide only": (((_DIRECT, "constexpr long long kDirect = 1;"),
                    ("  sample_kernel<<<(unsigned)",
                     "  if (n < 0) sample_kernel<<<(unsigned)")), False),
}

_JOIN_STORE = "  __stcs(reinterpret_cast<int4*>(p), v);"
_JOIN_LOAD = "  return __ldcs(reinterpret_cast<const int4*>(p));"
_JOIN_U = "      v.x = __ldcs(reinterpret_cast<const float4*>(r.u + i));"
_JOIN_GATHER = ("    const int m[4] = {__ldg(r.mark_time + cur.e.x),\n"
                "                      __ldg(r.mark_time + cur.e.y),\n"
                "                      __ldg(r.mark_time + cur.e.z),\n"
                "                      __ldg(r.mark_time + cur.e.w)};")
# the join pass (powerlaw_sample_join), timed on the streaming step's two
# halves of a row: name: (replacements, computes the join's function)
JOIN_VARIANTS = {
    "join": ((), True),
    "join: 3 blocks an SM": ((("constexpr int kJoinBlocksPerSm = 2;",
                               "constexpr int kJoinBlocksPerSm = 3;"),),
                             True),
    "join: cached loads and stores": (
        ((_JOIN_STORE, "  *reinterpret_cast<int4*>(p) = v;"),
         (_JOIN_LOAD, "  return __ldg(reinterpret_cast<const int4*>(p));"),
         (_JOIN_U, _JOIN_U.replace("__ldcs", "__ldg"))), True),
    "join: no mark gather": (((_JOIN_GATHER, "    const int m[4] = {cur.e.x, "
                               "cur.e.y, cur.e.z, cur.e.w};"),), False),
}

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build(variants: dict) -> dict:
    """Every variant's library, built in parallel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.powerlaw_sample import ops as ps

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for i, (name, (subs, _)) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"k6_mechanisms: {name}: the source has no "
                                 f"{old!r}")
            text = text.replace(old, new)
        cu = OUT_DIR / f"{'join' if name.startswith('join') else ''}" \
            f"variant{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k6_mechanisms: {name} does not build:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.powerlaw_sample.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.powerlaw_sample.restype = ctypes.c_int
        kinds = {"p": ctypes.c_void_p, "q": ctypes.c_longlong,
                 "i": ctypes.c_int}
        lib.powerlaw_sample_join.argtypes = [
            kinds[k] for k in ps.SIGNATURES["powerlaw_sample_join"]]
        lib.powerlaw_sample_join.restype = ctypes.c_int
        libs[name] = lib
    return libs


def graph_ms(fn, samples: int = 3, iters: int = 20) -> list:
    """``samples`` replays of ``iters`` calls captured in one CUDA graph,
    per call."""
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


def inputs(dev) -> list:
    """(input name, u, cdf) of the measured shapes."""
    from repro_torch.bench import registry
    from repro_torch.malgen import MalGenConfig, make_seed
    from repro_torch.malgen.seeding import chunk_marked_records

    cfg = MalGenConfig()
    seed = make_seed(0, cfg, NODES * RPS, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    n_marked = chunk_marked_records(cfg, CHUNK)
    shapes = [
        ("MalGen unmarked, a node's draws", seed.unmarked_cdf,
         RPS - len(range(0, seed.num_marked_events, NODES))),
        ("MalGen marked, the marked stream", seed.marked_cdf,
         seed.num_marked_events),
        ("MalGen marked, a service chunk", seed.marked_cdf, n_marked),
        ("MalGen unmarked, a service chunk", seed.unmarked_cdf,
         CHUNK - n_marked),
        ("MalGen unmarked, 2^18 - 1", seed.unmarked_cdf, (1 << 18) - 1),
        ("MalGen unmarked, 2^18 + 1", seed.unmarked_cdf, (1 << 18) + 1)]
    scale = registry.Scale(records_per_node=RPS, num_sites=cfg.num_sites,
                           num_entities=cfg.num_entities,
                           chunk_records=CHUNK, warmup=1, iters=1)
    u, cdf = registry._kernel_inputs(scale, "powerlaw_sample", dev)
    out = [("bench sorted CDF, 2^23", u, cdf)]
    out += [(name, torch.rand(n, generator=g, device=dev), cdf)
            for name, cdf, n in shapes]
    return out


def join_inputs(dev) -> list:
    """(input name, args of the join's C entry point, the plain version's
    columns) of the streaming step's two halves of a 2^23-record row under
    the B-10 configurations' tables (120,000 sites): the marked rows from
    the row's start, the unmarked from 838,861 (one int past a 16-byte
    boundary)."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.malgen import MalGenConfig, make_seed

    seed = make_seed(0, MalGenConfig(num_sites=120_000), NODES * RPS,
                     device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    c, n_m = RPS, 838_861
    u = torch.rand(c, generator=g, device=dev)
    ent = torch.randint(0, 1_000_000, (c,), generator=g, device=dev,
                        dtype=torch.int32)
    ts = torch.randint(0, 31_536_000, (c,), generator=g, device=dev,
                       dtype=torch.int32)
    out = [torch.empty(c, dtype=torch.int32, device=dev) for _ in range(4)]
    want = [torch.empty_like(o) for o in out]
    guide = torch.empty(1 << 17, dtype=torch.uint8, device=dev)
    cases = []
    for name, lo, hi, cdf in (
            ("join, marked half of a row", 0, n_m, seed.marked_cdf),
            ("join, unmarked half of a row", n_m, c, seed.unmarked_cdf)):
        ps.powerlaw_sample_join_plain(
            u[lo:hi], cdf, ent[lo:hi], ts[lo:hi], seed.entity_mark_time,
            *[w[lo:hi] for w in want], seq_start=lo, hash_value=-9)
        args = (u[lo:hi].data_ptr(), cdf.data_ptr(), ent[lo:hi].data_ptr(),
                ts[lo:hi].data_ptr(), seed.entity_mark_time.data_ptr(),
                *[o[lo:hi].data_ptr() for o in out], guide.data_ptr(),
                hi - lo, cdf.shape[0], lo, -9)
        cases.append((name, args, [o[lo:hi] for o in out],
                      [w[lo:hi] for w in want]))
    # the tensors the pointers point into live as long as the cases
    return cases, (seed, u, ent, ts, out, want, guide)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=pathlib.Path,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_mechanisms: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.powerlaw_sample import ops as ps

    lines = []

    def emit(obj):
        text = json.dumps(obj)
        print(text, flush=True)
        lines.append(text)

    emit({"card": card_line()})
    dev = torch.device("cuda")
    libs = build(VARIANTS)
    for inp, u, cdf in inputs(dev):
        n, s = u.shape[0], cdf.shape[0]
        want = ps.powerlaw_sample_plain(u, cdf)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        guide = torch.empty(1 << 17, dtype=torch.uint8, device=dev)
        for name, lib in libs.items():
            def call(lib=lib):
                # the current stream: a graph's capture stream while one
                # is captured
                err = lib.powerlaw_sample(
                    u.data_ptr(), cdf.data_ptr(), out.data_ptr(),
                    guide.data_ptr(), n, s,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise SystemExit(f"k6_mechanisms: {name}: CUDA error "
                                     f"{err}")

            call()
            if VARIANTS[name][1] and not torch.equal(out, want):
                raise SystemExit(f"k6_mechanisms: {name} differs from the "
                                 f"plain version on {inp}")
            emit({"input": inp, "name": name, "n": n, "ms": graph_ms(call)})
        emit({"input": inp, "name": "library", "n": n,
              "ms": graph_ms(lambda: torch.searchsorted(
                  cdf, u, right=True).clamp(0, s - 1))})
    join_libs = build(JOIN_VARIANTS)
    cases, _keep = join_inputs(dev)
    for inp, c_args, got, want in cases:
        for name, lib in join_libs.items():
            def call(lib=lib):
                err = lib.powerlaw_sample_join(
                    *c_args, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise SystemExit(f"k6_mechanisms: {name}: CUDA error "
                                     f"{err}")

            call()
            if JOIN_VARIANTS[name][1] and not all(
                    torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"k6_mechanisms: {name} differs from the "
                                 f"plain version on {inp}")
            emit({"input": inp, "name": name, "n": c_args[10],
                  "ms": graph_ms(call)})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
