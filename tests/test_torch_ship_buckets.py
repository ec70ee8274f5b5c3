"""K9, the record shuffle's round of shipped words
(``repro_torch.kernels.ship_buckets``), and the word exchange's path
through it, on the CPU.

- The plain version (the wrapper on CPU tensors) equals the round's
  definition, a numpy loop over receivers and senders, and ``ship_round``'s
  ``sent`` is the definition's live slots: over rounds past the first,
  empty destinations, segments longer than C, invalid tails, P in {1, 4,
  8} and starts off every 16-byte boundary.
- A numpy model of K9's own arithmetic (its tiles over the rows, the
  16-byte vectors cut from two aligned source vectors, the run's last
  vector by element, the ints-only path) gives the same buckets and reads
  only inside the words, in the receivers' layout of one process and in
  the senders' layout of a gang's rank.
- ``exchange_and_reduce`` gives the same histogram and the same six
  ``ShuffleStats`` fields as with the definition's round, for both word
  impls (the mapreduce tests hold that histogram against the JAX
  package); a gang's rank on the CPU takes the plain version with its
  group.
- The wrapper refuses what K9 does not take; its launch plan follows the
  entry point's arithmetic; its symbol and counter stay out of the
  benchmark's tables; the benchmark's ``exchange.ship_roofline`` reader
  and ``tools/trace_cell.py``'s readings on synthetic windows.

K9 itself runs only on the card: ``tests/test_torch_cuda.py -m cuda``.
No JAX here.
"""

import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernel_passes as kp
from repro_torch.common import nodes, trace
from repro_torch.common.trace import Span
from repro_torch.common.types import EventLog
from repro_torch.core.backends import mapreduce
from repro_torch.kernels import KERNEL_WRAPPERS, _build, launch_counts
from repro_torch.kernels._launch import H100_SMS, dim3
from repro_torch.kernels.ship_buckets import ops as sb
from repro_torch.kernels.segment_hist import segment_hist_packed_words

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "tools"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

import trace_cell  # noqa: E402

# K9's symbol as the profiler names it
SYMBOL = ("(anonymous namespace)::ship_buckets_kernel(int const*, "
          "int const*, int*, int, int, int, int, long long, int, int, "
          "int)")


def _segments(seed, p, n, counts_kind):
    """Words ``[p, n]`` (every int32 value, zeros among them) and starts
    ``[p, p + 1]``: each sender's destination segments, then an invalid
    tail. ``counts_kind``: "random", "empty" (some destinations empty),
    "hot" (one destination holds most of a row)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, size=(p, n), dtype=np.int64)
    words[rng.random((p, n)) < 0.05] = 0
    starts = np.zeros((p, p + 1), np.int64)
    for s in range(p):
        valid = int(rng.integers(n * 3 // 4, n + 1))
        if counts_kind == "hot":
            w = np.full(p, 0.2 / max(p - 1, 1))
            w[int(rng.integers(p))] = 0.8
        else:
            w = rng.random(p)
            if counts_kind == "empty":
                w[rng.random(p) < 0.5] = 0
                w[s % p] = max(w[s % p], 0.1)
        cuts = np.floor(np.cumsum(w) / w.sum() * valid).astype(np.int64)
        starts[s, 1:] = cuts
        starts[s, p] = valid
    return (torch.from_numpy(words.astype(np.int32)),
            torch.from_numpy(starts.astype(np.int32)))


def _formula(words, starts, r, capacity):
    """The round by its definition: shipped[d, s, c] = words[s, starts[s,
    d] + r C + c] where that index is below starts[s, d + 1], else 0; and
    each sender's live slots. Returns ``([P, P * C], sent [P])``."""
    w, st = words.numpy(), starts.numpy().astype(np.int64)
    p = w.shape[0]
    out = np.zeros((p, p, capacity), np.int32)
    sent = np.zeros(p, np.int32)
    for d in range(p):
        for s in range(p):
            begin = st[s, d] + r * capacity
            live = int(np.clip(st[s, d + 1] - begin, 0, capacity))
            out[d, s, :live] = w[s, begin:begin + live]
            sent[s] += live
    return (torch.from_numpy(out.reshape(p, p * capacity)),
            torch.from_numpy(sent))


def _k9_model(words, starts, r, capacity, words_at=0, out_at=0,
              by_sender=False):
    """K9's arithmetic in numpy (csrc/ship_buckets.cu), with the words and
    the output at byte addresses ``words_at`` and ``out_at``: every tile of
    every row, each store's vector made as the kernel makes it; row ``d *
    P + s`` (the receivers' layout) or, ``by_sender``, ``s * P + d`` over
    the rows of words given (a gang rank's senders). Asserts that every
    load lies inside the words and every slot is stored once."""
    w = words.numpy().reshape(-1)
    st = starts.numpy().astype(np.int64)
    senders, n = words.shape
    p = st.shape[1] - 1
    assert by_sender or senders == p
    vec = sb.vector_ints(words_at, out_at, n, capacity)
    items = capacity // 4 if vec == 4 else capacity
    row_tiles = -(-items // sb.TILE)
    out = np.full(senders * p * capacity, -7, np.int64)     # never a word
    stored = np.zeros(senders * p * capacity, np.int64)
    lanes = np.arange(sb.TILE)          # threadIdx.x + u * kThreads

    def load(at):
        assert ((0 <= at) & (at < w.size)).all(), "a load past the words"
        return w[at]

    for t in range(senders * p * row_tiles):
        row, tile = divmod(t, row_tiles)
        major, minor = divmod(row, p)
        d, s = (minor, major) if by_sender else (major, minor)
        begin = st[s, d] + r * capacity
        left = st[s, d + 1] - begin
        live = 0 if left <= 0 else min(left, capacity)
        src = s * n + begin                 # an int offset into the words
        dst = row * capacity
        j = tile * sb.TILE + lanes
        j = j[j < items]
        if vec != 4:
            v = np.zeros(j.size, np.int64)
            v[j < live] = load(src + j[j < live])
            out[dst + j] = v
            stored[dst + j] += 1
            continue
        whole = live // 4
        k = (words_at // 4 + src) % 4       # ints off a 16-byte boundary
        v = np.zeros((j.size, 4), np.int64)
        full = j[j < whole]
        if full.size:
            lo = load((src - k + 4 * full)[:, None] + np.arange(4))
            if k:
                hi = load((src - k + 4 * full + 4)[:, None] + np.arange(4))
                lo = np.concatenate([lo, hi], axis=1)[:, k:k + 4]
            v[j < whole] = lo
        last = (j == whole) & (4 * j < live)
        if last.any():                      # the run's last vector
            e = 4 * whole + np.arange(4)
            tail = np.zeros(4, np.int64)
            tail[e < live] = load(src + e[e < live])
            v[last] = tail
        for i in range(4):
            out[dst + 4 * j + i] = v[:, i]
            stored[dst + 4 * j + i] += 1
    assert (stored == 1).all()
    return torch.from_numpy(out.astype(np.int32).reshape(senders,
                                                         p * capacity))


CASES = [
    # p, n, capacity, counts, rounds
    (1, 40, 7, "random", (0, 1, 5, 6)),
    (4, 1000, 64, "random", (0, 1, 3, 4, 9)),
    (4, 1003, 333, "empty", (0, 1, 2)),
    (4, 4096, 1200, "hot", (0, 1, 2, 3)),
    (8, 4096, 256, "hot", (0, 1, 5, 12, 13)),
    (8, 2048, 4, "empty", (0, 1, 50, 99)),
    (8, 3000, 5000, "random", (0, 1)),     # a bucket wider than a row
]


@pytest.mark.parametrize("p,n,capacity,kind,rounds", CASES)
def test_plain_equals_the_round(p, n, capacity, kind, rounds):
    words, starts = _segments(p * n + capacity, p, n, kind)
    counts = (starts[:, 1:] - starts[:, :-1]).numpy()
    assert (counts > capacity).any() or capacity > n   # runs cut by C
    for r in rounds:
        want, want_sent = _formula(words, starts, r, capacity)
        got = sb.ship_buckets(words, starts, r, capacity)
        assert torch.equal(got, want)
        assert torch.equal(sb.ship_buckets_plain(words, starts, r, capacity),
                           got)
        shipped, sent = mapreduce.ship_round(words, starts, r, capacity)
        assert torch.equal(shipped, got)
        assert torch.equal(sent, want_sent)
        assert sent.dtype == torch.int32 and sent.shape == (p,)


@pytest.mark.parametrize("p,n,capacity,kind,rounds", CASES)
@pytest.mark.parametrize("words_at", [0, 4, 8, 12])
def test_the_kernels_arithmetic_gives_the_round(p, n, capacity, kind, rounds,
                                                words_at):
    """Starts off each 16-byte boundary in turn: where the words' row sits
    on one (``words_at`` 0) the segments still start anywhere, so the
    vectors are cut at every offset; elsewhere every int is moved alone."""
    words, starts = _segments(p * n + capacity + 1, p, n, kind)
    offsets = {int(x) % 4 for x in starts[:, :-1].reshape(-1)}
    assert len(offsets) > 1 or p == 1
    for r in rounds:
        got = _k9_model(words, starts, r, capacity, words_at=words_at)
        assert torch.equal(got, _formula(words, starts, r, capacity)[0])


@pytest.mark.parametrize("p,n,capacity,kind,rounds", CASES[1:])
@pytest.mark.parametrize("world", [2, 4])
def test_the_kernels_arithmetic_gives_a_gang_ranks_senders_buckets(
        p, n, capacity, kind, rounds, world):
    """A gang rank holds rows ``[first, first + P_local)`` of the senders:
    K9's senders' layout (row ``s * P + d``) holds bucket d of each of them,
    which is the receivers' layout transposed, those rows."""
    assert p % world == 0
    words, starts = _segments(p * n + capacity + world, p, n, kind)
    local = p // world
    for rank in range(world):
        mine = slice(rank * local, (rank + 1) * local)
        for r in rounds:
            want = _formula(words, starts, r, capacity)[0].view(
                p, p, capacity).transpose(0, 1)[mine]
            got = _k9_model(words[mine].contiguous(),
                            starts[mine].contiguous(), r, capacity,
                            words_at=4 * rank, by_sender=True)
            assert torch.equal(got.view(local, p, capacity), want), (rank, r)


def test_the_vector_width_follows_the_entry_point():
    assert sb.vector_ints(0, 0, 2**23, 2**22) == 4
    assert sb.vector_ints(16, 4096, 8, 4) == 4
    assert sb.vector_ints(4, 0, 8, 4) == 1       # words off a boundary
    assert sb.vector_ints(0, 8, 8, 4) == 1       # the output off one
    assert sb.vector_ints(0, 0, 10, 4) == 1      # rows of 10 words
    assert sb.vector_ints(0, 0, 8, 6) == 1       # buckets of 6 slots


def _words_log(seed, p, n, sites):
    rng = np.random.default_rng(seed)
    site = rng.zipf(1.3, size=(p, n)) % sites
    return EventLog(
        site_id=torch.from_numpy(site.astype(np.int32)),
        entity_id=torch.zeros(p, n, dtype=torch.int32),
        timestamp=torch.from_numpy(rng.integers(0, 52 * 604800, (p, n),
                                                dtype=np.int32)),
        mark=torch.from_numpy(rng.integers(0, 2, (p, n), dtype=np.int32)),
        valid=torch.from_numpy(rng.random((p, n)) < 0.97))


@pytest.mark.parametrize("impl", ["counting", "sort"])
@pytest.mark.parametrize("factor,p", [(0.5, 4), (4.0, 8), (0.25, 8)])
@pytest.mark.parametrize("reducer", ["kernel", "torch"])
def test_exchange_gives_the_definitions_histogram_and_shuffle_stats(
        impl, factor, p, reducer, monkeypatch):
    log = _words_log(int(factor * 100) + p, p, 3000, 256)
    fn = ((lambda w, s_local, weeks, parts, first: segment_hist_packed_words(
        w, num_sites_local=s_local, num_partitions=parts, num_weeks=weeks,
        first_node=first)) if reducer == "kernel" else None)
    kw = dict(num_sites=256, num_weeks=52, capacity_factor=factor,
              impl=impl, word_histogram_fn=fn)
    hist, stats = mapreduce.mapreduce_histogram(log, **kw)

    def defined_round(words, starts, r, capacity, group=None):
        return _formula(words, starts, r, capacity)

    monkeypatch.setattr(mapreduce, "ship_round", defined_round)
    old_hist, old = mapreduce.mapreduce_histogram(log, **kw)
    assert torch.equal(hist, old_hist)
    for name in ("sent", "overflow", "residual", "bytes_exchanged"):
        assert torch.equal(getattr(stats, name), getattr(old, name)), name
    assert (stats.capacity, stats.rounds) == (old.capacity, old.rounds)
    assert int(stats.overflow.sum()) == 0
    assert int(stats.sent.sum()) == int(log.valid.sum())
    if factor < 1:
        assert stats.rounds > 1


def test_the_cpu_takes_the_plain_version_counts_no_launch_and_no_round():
    words, starts = _segments(3, 4, 512, "random")
    before = sb.ship_buckets.launches
    trace.start()
    try:
        mapreduce.ship_round(words, starts, 0, 100)
    finally:
        _, counters = trace.stop()
    assert sb.ship_buckets.launches == before
    assert "shuffle.rounds_in_kernel" not in counters


def test_a_gang_rank_on_the_cpu_takes_the_plain_version_with_its_group(
        monkeypatch):
    """A rank of a gang holds its own senders' rows: on the CPU the
    wrapper hands them, with the group, to the plain version (its
    ``all_to_all`` runs over gloo), launches nothing and counts no round;
    ``sent`` is its own rows'. On the card the rank launches K9 in the
    senders' layout (``tests/test_torch_cuda.py``)."""
    words, starts = _segments(7, 4, 512, "random")
    group = nodes.NodeGroup(4, rank=1, world=2)
    taken = []

    def plain(w, st, r, capacity, group=None):
        taken.append((w.shape, r, capacity, group))
        return torch.zeros(w.shape[0], 4 * capacity, dtype=torch.int32)

    monkeypatch.setattr(sb, "ship_buckets_plain", plain)
    before = sb.ship_buckets.launches
    trace.start()
    try:
        shipped, sent = mapreduce.ship_round(words[2:], starts[2:], 1, 50,
                                             group)
    finally:
        _, counters = trace.stop()
    assert shipped.shape == (2, 200)
    assert taken == [((2, 512), 1, 50, group)]
    assert sb.ship_buckets.launches == before
    assert "shuffle.rounds_in_kernel" not in counters
    assert torch.equal(sent, _formula(words, starts, 1, 50)[1][2:])
    with pytest.raises(ValueError, match="P \\+ 1"):
        sb.ship_buckets(words[2:], starts[2:, :4].contiguous(), 1, 50, group)


def test_the_counter_and_symbol_stay_out_of_the_benchmarks_tables():
    """The benchmark's traced runs look each name of ``launch_counts()``
    up in their table of kernel symbols, which has no entry for K9; K9's
    symbol holds none of that table's fragments, nor any other metric's
    (a symbol ending in ``direct_kernel(`` would be counted as K6)."""
    from malbench import harness

    assert "ship_buckets" not in KERNEL_WRAPPERS
    assert not any("ship" in name for name in launch_counts())
    for fragments in harness.KERNEL_SYMBOLS.values():
        assert not any(f in SYMBOL for f in fragments)
    for path in sorted((ROOT / "malbench" / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "m_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        hits = [f for f in getattr(mod, "KERNELS", ()) if f in SYMBOL]
        assert hits == ([] if path.stem != "exchange.ship_roofline"
                        else ["ship_buckets_kernel("]), path.stem
    assert sb.KERNELS == ("ship_buckets_kernel",)


def test_the_ctypes_declarations_match_the_c_entry_points():
    src = (_build.CSRC / "ship_buckets.cu").read_text()
    got = {fn: "".join("p" if "*" in a else "q" if a.split()[0] == "long"
                       else "i" for a in args.split(",") if a.strip())
           for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                      src)}
    assert got == sb.SIGNATURES
    assert "ship_buckets" in _build.SOURCES
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kBlocksPerSm"]),
            int(consts["kUnroll"])) == (sb.THREADS, sb.BLOCKS_PER_SM,
                                        sb.UNROLL)


def test_the_wrapper_refuses_what_k9_does_not_take():
    words, starts = _segments(1, 4, 64, "random")
    with pytest.raises(ValueError, match="int32"):
        sb.ship_buckets(words.long(), starts, 0, 8)
    with pytest.raises(ValueError, match="int32"):
        sb.ship_buckets(words, starts.long(), 0, 8)
    with pytest.raises(ValueError, match="2-D"):
        sb.ship_buckets(words.reshape(4, 8, 8), starts, 0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sb.ship_buckets(torch.zeros(64, 4, dtype=torch.int32).t(), starts, 0,
                        8)
    with pytest.raises(ValueError, match="P \\+ 1"):
        sb.ship_buckets(words, starts[:, :4].contiguous(), 0, 8)
    with pytest.raises(ValueError, match="P \\+ 1"):
        sb.ship_buckets(words[:3], starts, 0, 8)
    with pytest.raises(ValueError, match="starts on meta"):
        sb.ship_buckets(words, starts.to("meta"), 0, 8)
    with pytest.raises(ValueError, match="negative"):
        sb.ship_buckets(words, starts, -1, 8)
    with pytest.raises(ValueError, match="at least 1"):
        sb.ship_buckets(words, starts, 0, 0)
    wide = torch.empty(1, 2**31, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        sb.ship_buckets(wide, torch.empty(1, 2, dtype=torch.int32,
                                          device="meta"), 0, 8)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        sb.ship_buckets(words, starts, 0, 2**31)


def test_launch_plan_at_the_cells_shapes():
    """8 nodes of 2^23 words into buckets of 2^22: 64 rows of 1,024 tiles
    of 1,024 16-byte vectors over a persistent grid of 4 blocks an SM; a
    capacity that is no multiple of 4 moves ints."""
    (k9,) = sb.launch_plan(8, 2**23, 2**22, H100_SMS)
    assert k9.kernel == "ship_buckets_kernel"
    assert k9.grid == dim3(4 * H100_SMS) and k9.block == dim3(256)
    assert k9.offsets["tiles"] == 64 * 1024 - 1 + 4 * H100_SMS
    assert k9.offsets["vectors"] == 2**20 - 1
    assert k9.offsets["out"] == 64 * 2**22 - 1
    assert k9.offsets["words"] == 2**26 - 1
    assert k9.offsets["starts"] == 71
    (small,) = sb.launch_plan(3, 1001, 333, H100_SMS, vec=1)
    assert small.grid == dim3(9) and small.offsets["vectors"] == 1023
    with pytest.raises(ValueError):
        sb.launch_plan(1, 4, 2**31, H100_SMS)
    # a gang rank's 2 senders of 8 nodes: 16 rows, the same tiles a row
    (gang,) = sb.launch_plan(8, 2**23, 2**22, H100_SMS, senders=2)
    assert gang.grid == dim3(4 * H100_SMS)
    assert gang.offsets["tiles"] == 16 * 1024 - 1 + 4 * H100_SMS
    assert gang.offsets["out"] == 16 * 2**22 - 1
    assert gang.offsets["words"] == 2**24 - 1
    assert gang.offsets["starts"] == 17


def test_the_analysis_cases_hold_their_limits():
    cases = [c for c in kp.kernel_analysis_cases()
             if c["source"] == "ship_buckets"]
    assert [c["name"] for c in cases] == [
        "ship_buckets/main_path", "ship_buckets/later_round",
        "ship_buckets/odd_capacity", "ship_buckets/widest_bucket",
        "ship_buckets/gang_rank"]
    sources = kp.read_sources()
    assert sources["ship_buckets"].bounds["ship_buckets_kernel"] == (256, 4)
    for case in cases:
        assert kp.check_case(case, sources) == [], case["name"]


# ---------------------------------------------------- the benchmark
def _reader_run(ops, scatters, traced=True):
    from malbench import harness

    resolved = harness.resolve(harness.load_spec(),
                               "malstone-b10-mapreduce.batch")
    run = harness.Run(resolved, 1, 0.0, traced, "cpu", 0.0)
    if traced:
        run.trace = {"ops": ops}
    run.launches = {"count_scatter.scatter": scatters}
    return run


def test_the_ship_roofline_reader_counts_its_kernel_records():
    """119 steps of one round each: 119 calls writing 64 buckets of 2^22
    slots, and every one of the steps' 8 x 2^23 words read once."""
    from malbench import harness

    read = harness.reader("exchange.ship_roofline")
    calls, per_call = 119, 5.0e-4
    got = read(_reader_run({SYMBOL: {"count": calls,
                                     "seconds": calls * per_call},
                            "other_kernel(int)": {"count": 9,
                                                  "seconds": 1.0}}, calls))
    nbytes = 4 * 64 * 2**22 + 4 * 8 * 2**23
    assert nbytes == 1_342_177_280
    assert got["bound_by"] == "bytes"
    assert got["value"] == pytest.approx(100 * nbytes / 3.35e12 / per_call)
    # the parent's program has no K9, an untraced run no trace
    assert read(_reader_run({"other_kernel(int)": {"count": 9,
                                                   "seconds": 1.0}},
                            calls)) is None
    assert read(_reader_run({}, calls, traced=False)) is None
    # two rounds a step: the words are still read once a step
    two = read(_reader_run({SYMBOL: {"count": 2 * calls,
                                     "seconds": 2 * calls * per_call}},
                           calls))
    assert two["value"] == pytest.approx(
        100 * (2 * 4 * 64 * 2**22 + 4 * 8 * 2**23) / 3.35e12
        / (2 * per_call))


def test_trace_cell_reads_the_rounds_kernel_time_and_share():
    step = "malbench.job/run.job/stream.step/stream.fold"
    spans = [Span("stream.step", 0, 10, None, 0),
             Span("stream.fold", 1, 9, 0),
             Span("shuffle.round", 3, 8, 1, 0),
             Span("stream.step", 10, 20, None, 1),
             Span("stream.fold", 11, 19, 3),
             Span("shuffle.round", 13, 18, 4, 0)]
    rnd = f"{step}/shuffle.round"
    paths = {"device_s_by_span_path": {f"{step}/shuffle.order": 0.006,
                                       rnd: 0.005},
             "kernel_s_by_span_path": {rnd: {"ship_buckets": 0.001,
                                             "packed_hist": 0.0034}}}
    m = trace_cell.span_metrics(spans, {"shuffle.rounds_in_kernel": 2},
                                None, paths)
    ship = m["shuffle.ship_device_ms_per_step"]
    assert ship["value"] == pytest.approx(0.5) and ship["unit"] == "ms/step"
    assert ship["k3"] == pytest.approx(1.7)
    assert ship["round"] == pytest.approx(2.5)
    assert ship["rounds_per_step"] == 1.0
    share = m["shuffle.rounds_in_kernel"]
    assert share["value"] == 1.0 and share["rounds"] == 2
    # neither reading where no K9 ran (the CPU, or a program without it)
    paths["kernel_s_by_span_path"] = {rnd: {"packed_hist": 0.0034}}
    others = trace_cell.span_metrics(spans, {}, None, paths)
    assert not {"shuffle.ship_device_ms_per_step",
                "shuffle.rounds_in_kernel"} & set(others)


def test_by_span_path_keeps_the_named_kernels_seconds():
    host = [("malbench.window", 0, 1000), ("shuffle.round", 100, 900)]
    device = [("(anonymous namespace)::ship_buckets_kernel(int const*)",
               200, 300, 1),
              ("(anonymous namespace)::packed_hist_kernel(int const*, int)",
               300, 650, 2),
              ("void at::native::elementwise_kernel(int)", 650, 700, 3)]
    r = trace_cell.by_span_path(host, device, {1: 150, 2: 160, 3: 170}, 0,
                                1000)
    assert r["kernel_s_by_span_path"] == {"shuffle.round": {
        "ship_buckets": pytest.approx(100e-9),
        "packed_hist": pytest.approx(350e-9)}}
    assert r["device_s_by_span_path"]["shuffle.round"] == pytest.approx(
        500e-9)
