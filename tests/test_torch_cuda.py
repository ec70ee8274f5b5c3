"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import malstone_run, run
from repro_torch.common.types import ExchangePlan
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.count_scatter import ops as cs
from repro_torch.kernels.count_scatter import count_scatter_ref
from repro_torch.kernels.segment_hist import ops as segment_hist_ops
from repro_torch.kernels.segment_hist import (
    segment_hist,
    segment_hist_packed_words,
    segment_hist_packed_words_plain,
    segment_hist_plain,
)
from repro_torch.malgen import MalGenConfig, generate_shards_device, make_seed


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _case(seed, rows, n, p, device):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, p + 1, size=(rows, n), dtype=np.int32)
    words = rng.integers(0, 2**32, size=(rows, n), dtype=np.uint32)
    return (torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(dest).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,p", [(1, 100, 4), (3, 5000, 3),
                                      (8, 70_000, 8), (2, 4096, 16),
                                      (1, 3000, 1)])
def test_count_scatter_equals_plain(cuda_device, rows, n, p):
    w, d = _case(rows * n, rows, n, p, cuda_device)
    reset_launch_counts()
    got = cs.count_scatter(w, d, p)
    counts = launch_counts()
    assert counts["count_scatter.count"] == 1
    assert counts["count_scatter.scatter"] == 1
    for a, b in zip(got, count_scatter_ref(w, d, p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    counts = cs.count_tiles(d, p + 1)
    torch.testing.assert_close(counts, cs.count_tiles_plain(d, p + 1),
                               rtol=0, atol=0)
    base, _ = cs.tile_bases(counts)
    torch.testing.assert_close(cs.scatter_tiles(w, d, base),
                               cs.scatter_tiles_plain(w, d, base),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d0", [0, 8])
def test_count_scatter_one_destination_is_identity(cuda_device, d0):
    w, _ = _case(d0, 2, 9000, 8, cuda_device)
    d = torch.full_like(w, d0)
    got, _ = cs.count_scatter(w, d, 8)
    torch.testing.assert_close(got, w, rtol=0, atol=0)


def _packed(p, length, s_local, device):
    g = torch.Generator().manual_seed(p * length)
    site = torch.randint(0, s_local * p, (p, length), generator=g)
    week = torch.randint(0, 52, (p, length), generator=g)
    mark = torch.randint(0, 2, (p, length), generator=g)
    words = (site << 8) | (week << 2) | (mark << 1) | 1
    kind = torch.rand((p, length), generator=g)
    big = (torch.randint(1 << 23, 1 << 24, (p, length), generator=g) << 8) | 1
    words = torch.where(kind < 0.15, torch.zeros_like(words), words)
    words = torch.where((kind >= 0.15) & (kind < 0.25), big, words)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("p,s_local", [(1, 37), (4, 40), (8, 12_500)])
def test_packed_hist_equals_plain(cuda_device, p, s_local):
    words = _packed(p, 20_000, s_local, cuda_device)
    kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=52)
    torch.testing.assert_close(segment_hist_packed_words(words, **kw),
                               segment_hist_packed_words_plain(words, **kw),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_same_seed_gives_the_same_records_on_the_card(cuda_device):
    """Generation is a pure function of the seed on one device: the seed
    tables (float32 scans included) and the records repeat exactly."""
    cfg = MalGenConfig(num_sites=100_000, num_entities=100_000)
    a = make_seed(4, cfg, 4 * 200_000, device=cuda_device)
    b = make_seed(4, cfg, 4 * 200_000, device=cuda_device)
    for f in ("marked_mask", "entity_mark_time", "site_weights",
              "marked_cdf", "unmarked_cdf"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    la = generate_shards_device(a, cfg, 4, 200_000, device=cuda_device)
    lb = generate_shards_device(b, cfg, 4, 200_000, device=cuda_device)
    for x, y in zip(la, lb):
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_slice_on_card_equals_cpu(cuda_device):
    cfg = MalGenConfig(num_sites=1000, num_entities=5000)
    seed = make_seed(2, cfg, 4 * 50_000, device=cuda_device)
    log = generate_shards_device(seed, cfg, 4, 50_000,
                                 device=cuda_device).map(
        lambda c: c.reshape(-1))
    plan = ExchangePlan(capacity_factor=0.5, histogram_impl="kernel")
    got, gs = malstone_run(log, 1000, nodes=4, plan=plan, device=cuda_device,
                           return_shuffle_stats=True)
    want, ws = malstone_run(log.to("cpu"), 1000, nodes=4, plan=plan,
                            device="cpu", return_shuffle_stats=True)
    torch.testing.assert_close(got.total.cpu(), want.total, rtol=0, atol=0)
    torch.testing.assert_close(got.rho.cpu().view(torch.int32),
                               want.rho.view(torch.int32), rtol=0, atol=0)
    assert [int(x) for x in gs] == [int(x) for x in ws]


def _k4_case(seed, rows, n, num_sites, num_weeks, device):
    """Columns with invalid rows, sites and weeks out of range and marks in
    {-1, 0, 1, 2}."""
    rng = np.random.default_rng(seed)
    cols = (rng.integers(-3, num_sites + 3, size=(rows, n), dtype=np.int32),
            rng.integers(-2, num_weeks + 2, size=(rows, n), dtype=np.int32),
            rng.integers(-1, 3, size=(rows, n), dtype=np.int32),
            rng.random((rows, n)) < 0.8)
    return [torch.from_numpy(c).to(device) for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,num_sites,num_weeks,offset", [
    (1, 1, 5, 52, 0), (3, 70_001, 300, 52, 0), (8, 100_000, 12_500, 52, 0),
    (2, 257, 10, 65, 17), (4, 5000, 40, 52, -3)])
def test_segment_hist_equals_plain(cuda_device, rows, n, num_sites,
                                   num_weeks, offset):
    site, week, mark, valid = _k4_case(n, rows, n, num_sites, num_weeks,
                                       cuda_device)
    site += offset
    kw = dict(num_sites=num_sites, num_weeks=num_weeks, site_offset=offset)
    reset_launch_counts()
    got = segment_hist(site, week, mark, valid, **kw)
    assert launch_counts()["segment_hist"] == 1
    torch.testing.assert_close(got, segment_hist_plain(site, week, mark,
                                                       valid, **kw),
                               rtol=0, atol=0)
    one = torch.full_like(site, offset + num_sites - 1)     # one hot site
    torch.testing.assert_close(segment_hist(one, week, mark, valid, **kw),
                               segment_hist_plain(one, week, mark, valid,
                                                  **kw), rtol=0, atol=0)


@pytest.mark.cuda
def test_backends_agree_on_the_card(cuda_device):
    """The four backends (columns for mapreduce) give one result on the
    card, equal to the CPU's, through K4 (one launch per local combine,
    one per columns round)."""
    cfg = MalGenConfig(num_sites=1001, num_entities=5000)
    seed = make_seed(3, cfg, 4 * 50_000, device=cuda_device)
    log = generate_shards_device(seed, cfg, 4, 50_000,
                                 device=cuda_device).map(
        lambda c: c.reshape(-1))
    want = malstone_run(log.to("cpu"), 1001, nodes=4, device="cpu",
                        plan=ExchangePlan(capacity_factor=0.5))
    for backend, impl in (("streams", "auto"), ("sphere", "auto"),
                          ("mapreduce_combiner", "auto"),
                          ("mapreduce", "columns")):
        plan = ExchangePlan(impl=impl, capacity_factor=0.5)
        reset_launch_counts()
        got, stats = run(log, 1001, nodes=4, backend=backend, plan=plan,
                         device=cuda_device, return_shuffle_stats=True)
        rounds = 1 if stats is None else stats.rounds
        assert launch_counts()["segment_hist"] == rounds, backend
        torch.testing.assert_close(got.total.cpu(), want.total, rtol=0,
                                   atol=0)
        torch.testing.assert_close(got.rho.cpu().view(torch.int32),
                                   want.rho.view(torch.int32), rtol=0,
                                   atol=0)
        part = run(log, 1001, nodes=4, backend=backend, plan=plan,
                   partitioned=True, device=cuda_device)
        torch.testing.assert_close(part.total.reshape(-1, 52)[:1001].cpu(),
                                   want.total, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,s,high", [(1, 1, 1, 10), (9, 52, 700, 1000),
                                        (52, 52, 100_000, 1000),
                                        (57, 65, 1000, 1 << 20),
                                        (130, 64, 333, 1 << 27)])
def test_masked_window_ratio_equals_plain(cuda_device, n, w, s, high):
    from repro_torch.kernels.windowed_ratio import (
        masked_window_ratio,
        masked_window_ratio_plain,
    )

    rng = np.random.default_rng(n * w + s)
    hist = torch.from_numpy(rng.integers(0, high, size=(s, w, 2),
                                         dtype=np.int32)).to(cuda_device)
    nm = torch.from_numpy(rng.random((n, w)) < 0.7).to(cuda_device)
    dm = torch.from_numpy(rng.random((n, w)) < 0.7).to(cuda_device)
    dm[0] = False                                   # a zero denominator
    reset_launch_counts()
    got = masked_window_ratio(hist, nm, dm)
    assert launch_counts()["windowed_ratio.masked"] == 1
    want = masked_window_ratio_plain(hist, nm, dm)
    torch.testing.assert_close(got[0].view(torch.int32),
                               want[0].view(torch.int32), rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ("streams", "mapreduce"))
def test_service_on_card_equals_cpu(cuda_device, backend):
    """Log-mode ingest of one log on the card and on the CPU: the same
    snapshot, stats and answers; K4 (streams) or K1-K3 (mapreduce) once
    per ingest step, K5 once per batch."""
    from repro_torch.malgen import generate_chunked_log, make_seed_streaming
    from repro_torch.serve import (
        MalStoneService,
        default_query_mix,
        growing_window_specs,
    )

    cfg = MalGenConfig(num_sites=1000, num_entities=5000)
    seed = make_seed_streaming(6, cfg, 8, 20_000, device="cpu")
    log = generate_chunked_log(seed, cfg, 8, 20_000)
    plan = ExchangePlan(impl="counting", capacity_factor=0.5)
    services = [MalStoneService(nodes=4, num_sites=1000,
                                chunk_records=10_000, backend=backend,
                                plan=plan, device=d)
                for d in (cuda_device, "cpu")]
    reset_launch_counts()
    steps = services[0].ingest_log(log)
    counts = launch_counts()
    if backend == "streams":
        assert counts["segment_hist"] == steps
    else:
        assert counts["count_scatter.count"] == steps
        assert counts["segment_hist.packed"] >= steps
    services[1].ingest_log(log)
    (h0, s0), (h1, s1) = (s.snapshot() for s in services)
    torch.testing.assert_close(h0.cpu(), h1, rtol=0, atol=0)
    if backend == "mapreduce":
        assert [int(x) for x in s0] == [int(x) for x in s1]
    specs = default_query_mix(num_sites=1000) + growing_window_specs()
    reset_launch_counts()
    got = services[0].query(specs)
    assert launch_counts()["windowed_ratio.masked"] == 1
    for a, b in zip(got, services[1].query(specs)):
        for f in ("rho", "num", "den", "top_sites", "top_rho"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x.view(np.int32),
                                              y.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(1, 1), (1023, 7), (70_001, 2048),
                                 (1 << 20, 100_000)])
def test_powerlaw_sample_equals_plain(cuda_device, n, s):
    """K6 on draws on and between CDF entries, runs of equal entries,
    NaN, +-inf, -0.0 and 1.0; n not a multiple of the block."""
    from repro_torch.kernels.powerlaw_sample import (
        powerlaw_sample,
        powerlaw_sample_plain,
    )

    rng = np.random.default_rng(n + s)
    w = rng.random(s).astype(np.float32)
    w[rng.random(s) < 0.3] = 0                      # repeated entries
    cdf = np.cumsum(w, dtype=np.float32)
    cdf /= max(cdf[-1], np.float32(1e-30))
    u = rng.random(n, dtype=np.float32)
    on = rng.random(n) < 0.3
    u[on] = cdf[rng.integers(0, s, int(on.sum()))]
    edges = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 2.0],
                     np.float32)
    u[rng.integers(0, n, min(n, 7))] = edges[:min(n, 7)]
    u_d = torch.from_numpy(u).to(cuda_device)
    cdf_d = torch.from_numpy(cdf).to(cuda_device)
    reset_launch_counts()
    got = powerlaw_sample(u_d, cdf_d)
    assert launch_counts()["powerlaw_sample"] == 1
    torch.testing.assert_close(got, powerlaw_sample_plain(u_d, cdf_d),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,w,high", [(1, 1, 10), (700, 52, 1000),
                                      (100_000, 52, 1000),
                                      (1000, 65, 1 << 20),
                                      (333, 130, 1 << 27)])
def test_windowed_ratio_equals_plain(cuda_device, s, w, high):
    """K7 with zero weeks, empty sites, sums above 2^24 and past 2^31 (a
    wrapped denominator gives rho 0), and W above its week chunk."""
    from repro_torch.kernels.windowed_ratio import (
        windowed_ratio,
        windowed_ratio_plain,
    )

    rng = np.random.default_rng(s * w)
    hist = rng.integers(0, high, size=(s, w, 2), dtype=np.int32)
    hist[rng.random(s) < 0.2] = 0
    hist[:, rng.random(w) < 0.2] = 0
    hist = torch.from_numpy(hist).to(cuda_device)
    reset_launch_counts()
    got = windowed_ratio(hist)
    assert launch_counts()["windowed_ratio"] == 1
    want = windowed_ratio_plain(hist)
    torch.testing.assert_close(got[0].view(torch.int32),
                               want[0].view(torch.int32), rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


HOT_CASES = ("random", "one cell", "one site", "many hot sites",
             "sample misses", "empty rows")


def _hist_case(name, p, n, num_sites, num_weeks, seed, owned=False):
    """K4's columns for one case of K3's and K4's hot-site design:
    ``random`` has invalid rows, sites and weeks out of range and marks in
    {-1, 0, 1, 2}; ``one cell`` and ``one site`` put every record on one;
    ``many hot sites`` spreads valid records evenly over 100 sites (50 past
    64 weeks), all hot at n = 2^22 and more than a tile holds (``owned``:
    row r's sites are r modulo P); ``sample misses`` puts every sampled
    record on a site no other record has; ``empty rows`` has every other
    row invalid."""
    rng = np.random.default_rng(seed)
    site = rng.integers(-3, num_sites + 3, size=(p, n))
    week = rng.integers(-2, num_weeks + 2, size=(p, n))
    mark = rng.integers(-1, 3, size=(p, n))
    valid = rng.random((p, n)) < 0.9
    if name == "one cell":
        site[:], week[:], valid[:] = num_sites // 2, num_weeks - 1, True
    elif name == "one site":
        site[:] = num_sites // 2
    elif name == "many hot sites":
        site = rng.integers(0, 100 if num_weeks <= 64 else 50, size=(p, n))
        if owned:
            site = site * p + np.arange(p)[:, None]
        week = rng.integers(0, num_weeks, size=(p, n))
        valid[:] = True
    elif name == "sample misses":
        site = rng.integers(0, num_sites - 1, size=(p, n))
        sample = min(n, segment_hist_ops.SAMPLE)
        site[:, np.arange(sample) * n // sample] = num_sites - 1
    elif name == "empty rows":
        valid[1::2] = False
    return [torch.from_numpy(c.astype(np.int32)) for c in (site, week, mark)
            ] + [torch.from_numpy(valid)]


def _case_words(cols, p, s_local):
    """K3's words from a case's columns: sites folded into [0, P * S_local
    + 3P), weeks into [0, 64)."""
    site, week, mark, valid = (c.to(torch.int64) for c in cols)
    words = (((site % (p * s_local + 3 * p)) << 8) | ((week % 64) << 2)
             | ((mark > 0).to(torch.int64) << 1) | valid)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", HOT_CASES)
@pytest.mark.parametrize("p", [1, 4, 8])
def test_hist_kernels_equal_plain_on_hot_site_cases(cuda_device, p, name):
    """K4 (W = 52, and W = 130, whose tile holds 39 sites) and K3 equal
    their plain versions, also with a hot list of absent sites; their hot
    lists equal the plain selection; one launch per call."""
    sh = segment_hist_ops
    n, num_sites = 1 << (22 if name == "many hot sites" else 20), 12_500
    for weeks in (52, 130):
        cols = [c.to(cuda_device) for c in _hist_case(name, p, n, num_sites,
                                                       weeks, p + weeks)]
        kw = dict(num_sites=num_sites, num_weeks=weeks)
        reset_launch_counts()
        got = segment_hist(*cols, **kw)
        assert launch_counts()["segment_hist"] == 1
        torch.testing.assert_close(got, segment_hist_plain(*cols, **kw),
                                   rtol=0, atol=0)
        geo = sh.launch_geometry(cols[0], n, weeks)
        hot = sh.segment_hist_hot_sites(cols[0], cols[1], cols[3], **kw)
        torch.testing.assert_close(hot, sh.hot_sites_plain(
            sh.record_sites(cols[0], cols[1], cols[3], **kw), geo.sample,
            geo.threshold), rtol=0, atol=0)
        if name == "many hot sites":
            assert (int(hot[0, 0]) > geo.hot_capacity
                    or int(hot[0, 0]) == sh.HOT_SITES)
    absent = torch.full((p, sh.HOT_LIST), -1, dtype=torch.int32)
    absent[:, 0] = sh.HOT_SITES
    absent[:, 1:] = num_sites + torch.arange(sh.HOT_SITES)
    absent = absent.to(cuda_device)
    torch.testing.assert_close(
        sh.segment_hist_tiled(*cols, absent, num_sites=num_sites,
                              num_weeks=130),
        segment_hist_plain(*cols, num_sites=num_sites, num_weeks=130),
        rtol=0, atol=0)
    words = _case_words(_hist_case(name, p, n, num_sites, 52, p, owned=True),
                        p, num_sites).to(cuda_device)
    kw = dict(num_sites_local=num_sites, num_partitions=p, num_weeks=52)
    want = segment_hist_packed_words_plain(words, **kw)
    reset_launch_counts()
    torch.testing.assert_close(segment_hist_packed_words(words, **kw), want,
                               rtol=0, atol=0)
    assert launch_counts()["segment_hist.packed"] == 1
    torch.testing.assert_close(
        sh.segment_hist_packed_words_tiled(words, absent, **kw), want,
        rtol=0, atol=0)
    geo = sh.launch_geometry(words, n, 52)
    hot = sh.segment_hist_packed_hot_sites(words, **kw)
    torch.testing.assert_close(hot, sh.hot_sites_plain(
        sh.word_sites(words, **kw), geo.sample, geo.threshold), rtol=0,
        atol=0)
    if name == "many hot sites":
        assert int(hot[:, 0].min()) == sh.HOT_SITES


@pytest.mark.cuda
def test_packed_hist_counts_owned_bit_31_sites(cuda_device):
    """Sites at 2^23 and above set bit 31 of the word; they unpack as
    unsigned and count in the row that owns them."""
    p, s_local = 2, 1 << 23
    site = torch.from_numpy(np.random.default_rng(31).integers(
        (1 << 24) - 64, 1 << 24, size=(p, 4000)))
    words = (site << 8) | 3
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=1)
    got = segment_hist_packed_words(words.to(cuda_device), **kw)
    torch.testing.assert_close(got.cpu(), segment_hist_packed_words_plain(
        words, **kw), rtol=0, atol=0)
    assert int(got.sum()) == 2 * int((site % p == torch.arange(p)[:, None])
                                     .sum())


@pytest.mark.cuda
def test_hist_kernels_on_malgen_at_the_main_shapes(cuda_device):
    """K4 over 8 x 2^23 MalGen records, over the same columns with sites
    drawn uniformly and over a service step's 2^20 records a node; K3 over
    round 0's shipped words of both: each equal to its plain version."""
    from repro_torch.core.backends.mapreduce import (
        order_words,
        ship_round,
        static_capacity,
    )

    cfg = MalGenConfig()
    p, rps = 8, 1 << 23
    seed = make_seed(0, cfg, p * rps, device=cuda_device)
    log = generate_shards_device(seed, cfg, p, rps, device=cuda_device)
    s_pad = -(-cfg.num_sites // p) * p
    uniform = log._replace(site_id=torch.randint(
        0, cfg.num_sites, log.site_id.shape, device=cuda_device,
        dtype=torch.int32))
    kw = dict(num_sites=s_pad, num_weeks=52)
    kw3 = dict(num_sites_local=s_pad // p, num_partitions=p, num_weeks=52)
    for lg in (log, uniform):
        for cut in (rps, 1 << 20):
            cols = [c[:, :cut].contiguous() for c in (
                lg.site_id, lg.week(), lg.mark, lg.valid_mask())]
            torch.testing.assert_close(segment_hist(*cols, **kw),
                                       segment_hist_plain(*cols, **kw),
                                       rtol=0, atol=0)
        shipped, _ = ship_round(*order_words(lg, 52, "counting"), 0,
                                static_capacity(rps, p, 2.0))
        torch.testing.assert_close(
            segment_hist_packed_words(shipped, **kw3),
            segment_hist_packed_words_plain(shipped, **kw3), rtol=0, atol=0)


K5_MASK_KINDS = ("none", "first", "last", "all", "alternating", "window",
                 "random")


def _k5_masks(kind, n, w, rng):
    """N masks of one shape (as in test_torch_windowed_ratio.py): no week,
    one run from the first week or to the last, every week, alternating
    weeks, one run anywhere, or each week at random."""
    weeks = np.arange(w)[None, :]
    k = rng.integers(0, w + 1, size=(n, 1))
    if kind == "none":
        return np.zeros((n, w), bool)
    if kind == "first":
        return weeks < np.maximum(k, 1)
    if kind == "last":
        return weeks >= np.minimum(k, w - 1)
    if kind == "all":
        return np.ones((n, w), bool)
    if kind == "alternating":
        return (weeks + np.arange(n)[:, None]) % 2 == 0
    if kind == "window":
        a = rng.integers(0, w, size=(n, 1))
        return (weeks >= a) & (weeks < a + 1 + k % (w - a))
    return rng.random((n, w)) < 0.5


def _k5_equal(got, want, msg):
    assert torch.equal(got[0].view(torch.int32),
                       want[0].view(torch.int32)), f"rho {msg}"
    assert torch.equal(got[1], want[1]), f"num {msg}"
    assert torch.equal(got[2], want[2]), f"den {msg}"


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 52, 64, 65])
@pytest.mark.parametrize("n", [1, 9, 52, 57, 129])
def test_masked_window_ratio_mask_shapes_equal_plain(cuda_device, n, w):
    """K5's prefix differences over every mask shape, at N of one query
    block and more (129: three blocks of 64), W of one chunk and more, and
    S of 1, a part of one 64-site tile and a ragged 1000, bit-equal to
    its plain version; each call one launch."""
    from repro_torch.kernels.windowed_ratio import (
        masked_window_ratio,
        masked_window_ratio_plain,
    )

    rng = np.random.default_rng(n * 100 + w)
    for s in (1, 37, 1000):
        hist = rng.integers(0, 1000, size=(s, w, 2), dtype=np.int32)
        hist[rng.random(s) < 0.2] = 0
        hist = torch.from_numpy(hist).to(cuda_device)
        for kind in K5_MASK_KINDS:
            nm = torch.from_numpy(_k5_masks(kind, n, w, rng)).to(cuda_device)
            dm = torch.from_numpy(_k5_masks(kind, n, w, rng)).to(cuda_device)
            reset_launch_counts()
            got = masked_window_ratio(hist, nm, dm)
            assert launch_counts()["windowed_ratio.masked"] == 1
            _k5_equal(got, masked_window_ratio_plain(hist, nm, dm),
                      f"N={n} W={w} S={s} {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("high", [1 << 20, 1 << 27])
def test_masked_window_ratio_wraps_like_plain(cuda_device, high):
    """Sums past 2^24 and past 2^31 (int32 wrap) over every mask shape,
    across two week chunks (W = 65)."""
    from repro_torch.kernels.windowed_ratio import (
        masked_window_ratio,
        masked_window_ratio_plain,
    )

    rng = np.random.default_rng(high % 1000)
    hist = torch.from_numpy(rng.integers(0, high, size=(1000, 65, 2),
                                         dtype=np.int32)).to(cuda_device)
    for kind in K5_MASK_KINDS:
        nm = torch.from_numpy(_k5_masks(kind, 57, 65, rng)).to(cuda_device)
        got = masked_window_ratio(hist, nm, nm)
        _k5_equal(got, masked_window_ratio_plain(hist, nm, nm),
                  f"high={high} {kind}")
        if kind == "all":
            assert int(got[1].max()) > 1 << 24
            assert high < 1 << 27 or int(got[1].min()) < 0


@pytest.mark.cuda
@pytest.mark.parametrize("num_dests", [1, 2, 9, 257, 1025])
def test_count_scatter_at_the_tile_equals_ref(cuda_device, num_dests):
    """K1 and K2 against their plain versions and count_scatter against
    the stable-argsort oracle, with rows ragged across the tile (a record
    short of it, one past, three and a bit, and a row length that is no
    multiple of 4, so only the first row is 16-byte aligned), every record
    on one destination, invalid rows on the pseudo-destination, and
    destinations out of range (K1/K2 only: they land nowhere)."""
    p = num_dests - 1
    tile = cs.TILE
    for rows, n in ((1, tile - 1), (2, tile + 1), (3, 3 * tile + 77),
                    (3, 8 * tile)):
        w, d = _case(num_dests * n + rows, rows, n, p, cuda_device)
        rng = np.random.default_rng(n)
        mask = torch.from_numpy(rng.random((rows, n)) < 0.3).to(cuda_device)
        out = torch.from_numpy(rng.choice(
            [-3, -1, num_dests, num_dests + 9], size=(rows, n)).astype(
                np.int32)).to(cuda_device)
        cases = {"random": d, "one dest": torch.full_like(d, p // 2),
                 "invalid rows": torch.where(mask, p, d),
                 "out of range": torch.where(mask, out, d)}
        for name, dd in cases.items():
            msg = f"D={num_dests} rows={rows} n={n} {name}"
            counts = cs.count_tiles(dd, num_dests)
            assert torch.equal(counts, cs.count_tiles_plain(dd, num_dests)), \
                msg
            base, _ = cs.tile_bases(counts)
            assert torch.equal(cs.scatter_tiles(w, dd, base),
                               cs.scatter_tiles_plain(w, dd, base)), msg
            if name != "out of range":
                got = cs.count_scatter(w, dd, p)
                for a, b in zip(got, count_scatter_ref(w, dd, p)):
                    assert torch.equal(a, b), msg


@pytest.mark.cuda
def test_count_scatter_at_the_main_shapes_equals_ref(cuda_device):
    """K1 and K2 over [8, 2^23] records to 9 destinations, the counting
    main path's width, against the stable-argsort oracle."""
    w, d = _case(3, 8, 1 << 23, 8, cuda_device)
    reset_launch_counts()
    got = cs.count_scatter(w, d, 8)
    assert launch_counts()["count_scatter.scatter"] == 1
    for a, b in zip(got, count_scatter_ref(w, d, 8)):
        assert torch.equal(a, b)


def _k6_cases(device):
    """(name, u, cdf) of K6's cases beyond the random ones: the MalGen
    CDFs (permuted, masked: leading zeros, runs of equal entries, a last
    run of 1.0) with draws on their entries and on the guide's bucket
    edges, on both sides of the direct-search threshold (2^18 draws), u at
    an offset of one float, a last entry below 1 and entries outside
    [0, 1]."""
    from repro_torch.malgen import MalGenConfig
    from repro_torch.malgen.seeding import _site_tables

    rng = np.random.default_rng(18)
    _, _, marked, unmarked = _site_tables(0, MalGenConfig(), "cpu")
    out = []
    for name, cdf in (("marked", marked.numpy()),
                      ("unmarked", unmarked.numpy())):
        for n in ((1 << 18) - 1, (1 << 18) + 5):
            u = rng.random(n, dtype=np.float32)
            on = rng.random(n) < 0.2
            u[on] = cdf[rng.integers(0, cdf.shape[0], int(on.sum()))]
            edge = rng.random(n) < 0.1
            u[edge] = rng.integers(0, 1 << 13, int(edge.sum())) / (1 << 13)
            u[rng.integers(0, n, 4)] = (np.nan, np.inf, -np.inf, -0.0)
            out.append((f"{name} n={n}", u, cdf))
            out.append((f"{name} n={n - 1} offset", u[1:], cdf))
    below = np.sort(rng.random(3000).astype(np.float32)) * np.float32(0.75)
    out.append(("last entry 0.75", rng.random(1 << 19, dtype=np.float32),
                below))
    out.append(("entries in [-0.5, 2]",
                (rng.random(1 << 19) * 3 - 1).astype(np.float32),
                np.linspace(-0.5, 2.0, 5000, dtype=np.float32)))
    out.append(("S=1", rng.random(1 << 19, dtype=np.float32),
                np.ones(1, np.float32)))
    return [(name, torch.from_numpy(u).to(device)
             if "offset" not in name else
             torch.from_numpy(np.concatenate([[0.5], u]).astype(np.float32))
             .to(device)[1:], torch.from_numpy(cdf).to(device))
            for name, u, cdf in out]


@pytest.mark.cuda
def test_powerlaw_sample_edge_cases_equal_plain(cuda_device):
    """K6 (its guide table and its direct search) on ``_k6_cases``, each
    equal to the plain count and to ``torch.searchsorted`` on the card."""
    from repro_torch.kernels.powerlaw_sample import (
        powerlaw_sample,
        powerlaw_sample_plain,
    )

    for name, u, cdf in _k6_cases(cuda_device):
        reset_launch_counts()
        got = powerlaw_sample(u, cdf)
        assert launch_counts()["powerlaw_sample"] == 1, name
        torch.testing.assert_close(got, powerlaw_sample_plain(u, cdf),
                                   rtol=0, atol=0, msg=name)
        lib = torch.searchsorted(cdf, u, right=True).clamp(
            0, cdf.shape[0] - 1).to(torch.int32)
        assert torch.equal(got, lib), name


def _join_torch(u, cdf, entity, ts, mark_time, seq_start, hash_value):
    """The join pass as plain K6 and torch ops: site, mark, seq, hash."""
    from repro_torch.kernels.powerlaw_sample import powerlaw_sample

    n = u.shape[0]
    return (powerlaw_sample(u.contiguous(), cdf),
            (mark_time[entity.long()] <= ts).int(),
            torch.arange(seq_start, seq_start + n, dtype=torch.int32,
                         device=u.device),
            torch.full((n,), hash_value, dtype=torch.int32, device=u.device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", ((1 << 18) - 1, (1 << 18) + 5, 7_549_747))
def test_join_at_every_skew_equals_k6_and_the_torch_join(cuda_device, n):
    """K6's join pass on ``_k6_cases``'s MalGen CDF draws, with every
    column at 0-3 ints past a 16-byte boundary (the unmarked half of a
    row starts at 838,861, one int past), and with ``u`` alone at another
    offset (every group by element): bit-equal to plain K6 and the torch
    join, nothing written outside its slice, one launch a call."""
    from repro_torch.kernels.powerlaw_sample import powerlaw_sample_join
    from repro_torch.malgen import MalGenConfig
    from repro_torch.malgen.seeding import _site_tables

    _, _, _, cdf = _site_tables(0, MalGenConfig(num_sites=120_000), "cpu")
    cdf = cdf.to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    base_u = torch.rand(n + 8, generator=g, device=cuda_device)
    base_u[:: 4099] = torch.tensor(float("nan"))
    base_u[1:: 5003] = 1.0
    base_e = torch.randint(0, 1_000_000, (n + 8,), generator=g,
                           device=cuda_device, dtype=torch.int32)
    base_t = torch.randint(0, 31_536_000, (n + 8,), generator=g,
                           device=cuda_device, dtype=torch.int32)
    mark_time = torch.randint(0, 40_000_000, (1_000_000,), generator=g,
                              device=cuda_device, dtype=torch.int32)
    for skew, u_skew in ((0, 0), (1, 1), (2, 2), (3, 3), (1, 2), (0, 3)):
        u = base_u[u_skew:u_skew + n]
        e, t = base_e[skew:skew + n], base_t[skew:skew + n]
        out = [torch.full((n + 8,), -7, dtype=torch.int32,
                          device=cuda_device) for _ in range(4)]
        reset_launch_counts()
        powerlaw_sample_join(u, cdf, e, t, mark_time,
                             *[o[skew:skew + n] for o in out],
                             seq_start=838_861, hash_value=-123_456)
        assert launch_counts()["powerlaw_sample"] == 1
        want = _join_torch(u, cdf, e, t, mark_time, 838_861, -123_456)
        for name, o, w in zip(("site", "mark", "seq", "hash"), out, want):
            msg = f"{name} skew={skew} u_skew={u_skew}"
            assert torch.equal(o[skew:skew + n], w), msg
            assert (o[:skew] == -7).all() and (o[skew + n:] == -7).all(), \
                msg


@pytest.mark.cuda
def test_draws_into_row_slices_equal_draw_events(cuda_device):
    """A chunk's draws made straight into its row (``draw_events_into``)
    at the main path's sizes and offsets (838,861 marked rows from 0,
    7,549,747 unmarked from 838,861) are ``draw_events``' numbers."""
    from repro_torch.malgen import MalGenConfig
    from repro_torch.malgen.seeding import draw_events, draw_events_into

    cfg = MalGenConfig(num_sites=120_000)
    c, n_m = 1 << 23, 838_861
    for chunk_id in (0, 5, 951):
        u = torch.empty(c, device=cuda_device)
        ent = torch.empty(2, c, dtype=torch.int32, device=cuda_device)
        ts = torch.empty(2, c, dtype=torch.int32, device=cuda_device)
        for lo, hi, stream in ((0, n_m, "chunk_marked"),
                               (n_m, c, "chunk_unmarked")):
            draw_events_into(2**31 + 7, stream, chunk_id, cfg, u[lo:hi],
                             ent[1, lo:hi], ts[1, lo:hi])
            want = draw_events(2**31 + 7, stream, chunk_id, hi - lo, cfg,
                               cuda_device)
            assert torch.equal(u[lo:hi], want.u_site), (stream, chunk_id)
            assert torch.equal(ent[1, lo:hi], want.entity), stream
            assert torch.equal(ts[1, lo:hi], want.timestamp), stream


@pytest.mark.cuda
@pytest.mark.parametrize("p,c", [(8, 1 << 23), (3, 100_000), (2, 524_291)])
def test_generate_chunks_in_place_equals_stacked_chunks(cuda_device, p, c):
    """The step written in place equals ``generate_chunk``'s chunks (plain
    K6 and the torch join) stacked, column by column: at the main path's
    [8, 2^23] under ``make_seed_streaming``'s B-10 tables, at 100,000
    records (both halves below 2^18: the direct variant), and at 524,291
    (a direct marked half, an unaligned table half); K6 counted twice a
    chunk."""
    from repro_torch.malgen import (
        MalGenConfig,
        generate_chunk,
        generate_chunks,
        make_seed_streaming,
    )

    cfg = MalGenConfig(num_sites=120_000)
    seed = make_seed_streaming(2**31 + 99, cfg, 16, c, device=cuda_device)
    ids = [0, 15, 3, 9, 1, 2, 7, 4][:p]
    reset_launch_counts()
    step = generate_chunks(seed, cfg, ids, c)
    assert launch_counts()["powerlaw_sample"] == 2 * p
    for f in ("site_id", "entity_id", "timestamp", "mark", "event_seq",
              "shard_hash"):
        got = getattr(step, f)
        assert got.shape == (p, c) and got.is_contiguous(), f
        for d, chunk in enumerate(ids):
            want = getattr(generate_chunk(seed, cfg, chunk, c), f)
            assert torch.equal(got[d], want), (f, chunk)
    assert step.mark.any() and not step.mark.all()


_PROFILE_STEP = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.malgen import MalGenConfig, generate_chunks, make_seed_streaming
cfg = MalGenConfig(num_sites=120_000)
c = int(sys.argv[1])
seed = make_seed_streaming(5, cfg, 8, c, device="cuda")
generate_chunks(seed, cfg, list(range(8)), c)
torch.cuda.synchronize()
reset_launch_counts()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    generate_chunks(seed, cfg, list(range(8)), c)
    torch.cuda.synchronize()
names = [e.name() for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA]
print(json.dumps({"launches": launch_counts()["powerlaw_sample"],
                  "k6": sum("::sample_kernel(" in n or "direct_kernel(" in n
                            for n in names),
                  "join": sum("join::" in n for n in names)}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("c", (1 << 23, 100_000))
def test_generate_chunks_leaves_a_k6_record_a_launch(cuda_device, c):
    """One step profiled in a fresh process (a long-lived one drops the
    first kernel records of a session): the records whose names hold
    ``::sample_kernel(`` or ``direct_kernel(`` (what a traced benchmark
    run holds against K6's launches) equal ``powerlaw_sample``'s
    launches, two a chunk, all of them the join pass's."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", _PROFILE_STEP, str(c)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ,
                            "PYTHONPATH": str(src)})
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"launches": 16, "k6": 16, "join": 16}


@pytest.mark.cuda
@pytest.mark.parametrize("w", (1, 2, 31, 32, 33, 52, 64, 65, 130))
@pytest.mark.parametrize("s", (1, 7, 1001))
def test_windowed_ratio_weeks_and_sites_equal_plain(cuda_device, w, s):
    """K7 at every week count around its lane pairs (2 weeks a lane) and
    its 64-week chunks, odd W (4-byte loads), S no multiple of a block's 8
    sites, counts past 2^31, and a histogram at an offset of one int."""
    from repro_torch.kernels.windowed_ratio import (
        windowed_ratio,
        windowed_ratio_plain,
    )

    rng = np.random.default_rng(w * 10_000 + s)
    flat = rng.integers(0, 1 << 27, size=1 + s * w * 2, dtype=np.int32)
    flat = torch.from_numpy(flat).to(cuda_device)
    for name, hist in (("aligned", flat[:-1].view(s, w, 2)),
                       ("offset", flat[1:].view(s, w, 2))):
        reset_launch_counts()
        got = windowed_ratio(hist)
        assert launch_counts()["windowed_ratio"] == 1
        want = windowed_ratio_plain(hist)
        torch.testing.assert_close(got[0].view(torch.int32),
                                   want[0].view(torch.int32), rtol=0, atol=0,
                                   msg=name)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_generation_on_the_card_runs_k6_and_equals_the_cpu(cuda_device):
    """The same seed tables and draws generate the same shards on the card
    (sites through K6: one launch a shard's unmarked draws and one for the
    marked stream) as on the CPU (``torch.searchsorted``)."""
    from repro_torch.malgen.seeding import draw_events

    cfg = MalGenConfig(num_sites=100_000, num_entities=100_000)
    p, rps = 4, 300_000
    seed = make_seed(5, cfg, p * rps, device="cpu")
    marked = draw_events(seed.rng_seed, "marked", 0, seed.num_marked_events,
                         cfg, "cpu")
    unmarked = [draw_events(seed.rng_seed, "unmarked", s,
                            rps - len(range(s, seed.num_marked_events, p)),
                            cfg, "cpu") for s in range(p)]
    kw = dict(marked_draws=marked, unmarked_draws=unmarked)
    reset_launch_counts()
    got = generate_shards_device(seed.to(cuda_device), cfg, p, rps,
                                 device=cuda_device, **kw)
    assert launch_counts()["powerlaw_sample"] == p + 1
    want = generate_shards_device(seed, cfg, p, rps, device="cpu", **kw)
    for name, x, y in zip(got._fields, got, want):
        if x is not None:
            assert torch.equal(x.cpu(), y), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((100_000, 52), (8, 12_500, 52),
                                   (3, 7, 130)))
def test_malstone_b_on_the_card_runs_k7(cuda_device, shape):
    """MalStone B of a CUDA histogram ``[..., W, 2]`` is one K7 launch,
    bit-equal to ``windowed_ratio_plain`` of the ``[-1, W, 2]`` rows."""
    from repro_torch.core import spm
    from repro_torch.kernels.windowed_ratio import windowed_ratio_plain

    rng = np.random.default_rng(sum(shape))
    hist = torch.from_numpy(rng.integers(0, 1 << 27, size=(*shape, 2),
                                         dtype=np.int32)).to(cuda_device)
    reset_launch_counts()
    got = spm.malstone_b(hist)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0) | {
        "windowed_ratio": 1}
    want = windowed_ratio_plain(hist.reshape(-1, *shape[-1:], 2))
    assert got.rho.shape == shape
    for a, b in zip((got.rho.view(torch.int32), got.total, got.marked),
                    (want[0].view(torch.int32), want[1], want[2])):
        torch.testing.assert_close(a.reshape(b.shape), b, rtol=0, atol=0)


@pytest.mark.cuda
def test_card_paths_refuse_what_the_kernels_do_not_take(cuda_device):
    """No fallback: on CUDA tensors ``sample_sites`` and ``malstone_b``
    raise where K6 and K7 refuse their input."""
    from repro_torch.core import spm
    from repro_torch.malgen import sample_sites

    cdf = torch.linspace(0.1, 1.0, 10, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sample_sites(cdf, torch.rand(100, dtype=torch.float64,
                                     device=cuda_device))
    with pytest.raises(ValueError, match="int32"):
        spm.malstone_b(torch.zeros(5, 52, 2, dtype=torch.int64,
                                   device=cuda_device))
    assert sample_sites(cdf, torch.rand(0, device=cuda_device)).shape == (0,)


# ------------------------------------------------------ the overlap runner
def _overlap_case(device, backend, cpn, chunk, nodes=4):
    from repro_torch.core.overlap import OverlapStreamingRunner
    from repro_torch.malgen import make_seed_streaming

    cfg = MalGenConfig(num_sites=10_000, num_entities=100_000)
    plan = ExchangePlan(impl="counting", capacity_factor=0.5,
                        histogram_impl="kernel")
    seed = make_seed_streaming(3, cfg, nodes * cpn, chunk, device=device)
    runner = OverlapStreamingRunner(
        seed, cfg, nodes=nodes, num_chunks=nodes * cpn, chunk_records=chunk,
        backend=backend, plan=plan, device=device)
    return cfg, plan, seed, runner


def _stats(stats):
    return None if stats is None else [int(x) for x in stats]


@pytest.mark.cuda
@pytest.mark.parametrize("backend,cpn,chunk", [
    ("mapreduce", 6, 1 << 16), ("mapreduce", 32, 512),
    ("streams", 6, 1 << 16), ("mapreduce_combiner", 4, 4096)])
def test_overlap_equals_the_streaming_engine_on_the_card(cuda_device,
                                                         backend, cpn,
                                                         chunk):
    """Overlap on, off and the streaming engine (overlap=None) give the
    same histogram, rho bits and ShuffleStats, over 5 repeats; the run of
    32 small chunks a node keeps generations in flight beside folds for
    the caching allocator to reuse memory under, if the runner let it."""
    from repro_torch.core import malstone_run_streaming

    cfg, plan, seed, runner = _overlap_case(cuda_device, backend, cpn,
                                            chunk)
    kw = dict(nodes=4, cfg=cfg, num_chunks=4 * cpn, chunk_records=chunk,
              backend=backend, plan=plan, device=cuda_device,
              return_shuffle_stats=True)
    want, ws = malstone_run_streaming(seed, cfg.num_sites, **kw)
    for _ in range(5):
        for ov in (True, False):
            for got, gs in (runner.run_result("B", overlap=ov),
                            malstone_run_streaming(seed, cfg.num_sites,
                                                   overlap=ov, **kw)):
                assert torch.equal(got.total, want.total), ov
                assert torch.equal(got.marked, want.marked), ov
                assert torch.equal(got.rho.view(torch.int32),
                                   want.rho.view(torch.int32)), ov
                assert _stats(gs) == _stats(ws), ov
    if backend == "mapreduce":
        assert ws.rounds > 1


@pytest.mark.cuda
def test_overlap_launches_the_path_kernels(cuda_device):
    """One run_result("B") of a mapreduce runner: K6 for each node's
    marked and unmarked draws a step, K1 and K2 a step, K3 at least once
    a step, K7 once; no K4 or K5."""
    cfg, plan, seed, runner = _overlap_case(cuda_device, "mapreduce", 3,
                                            1 << 15)
    for ov in (True, False):
        torch.cuda.synchronize()
        reset_launch_counts()
        runner.run_result("B", overlap=ov)
        torch.cuda.synchronize()
        got = launch_counts()
        assert got["powerlaw_sample"] == 2 * 4 * 3
        assert got["count_scatter.count"] == got["count_scatter.scatter"] == 3
        assert got["segment_hist.packed"] >= 3
        assert got["windowed_ratio"] == 1
        assert got["segment_hist"] == got["windowed_ratio.masked"] == 0


def _kernel_streams(events, names):
    return {e["args"].get("stream") for e in events
            if e.get("cat") == "kernel" and any(n in e["name"]
                                                for n in names)}


@pytest.mark.cuda
@pytest.mark.parametrize("ov", (True, False))
def test_overlap_runs_generation_and_fold_on_two_streams(cuda_device, ov,
                                                         tmp_path):
    """A torch.profiler trace of one run: K6 (generation) on one stream,
    K1-K3 (the fold) on another, the caller's."""
    import json

    from torch.profiler import ProfilerActivity, profile

    _, _, _, runner = _overlap_case(cuda_device, "mapreduce", 3, 1 << 15)
    runner.run_result("B", overlap=ov)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.run_result("B", overlap=ov)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    gen = _kernel_streams(events, ("sample_kernel", "direct_kernel",
                                   "guide_kernel"))
    fold = _kernel_streams(events, ("count_tiles_kernel",
                                    "scatter_tiles_kernel",
                                    "packed_hist_kernel"))
    assert len(gen) == 1 and len(fold) == 1 and gen != fold, (gen, fold)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1000, 1 << 18, (1 << 20) + 3))
def test_k6_on_a_side_stream_equals_plain(cuda_device, n):
    """K6 launched while a non-default stream is current runs there and
    equals its plain version."""
    from repro_torch.kernels.powerlaw_sample import ops as ps

    g = torch.Generator(device="cpu").manual_seed(n)
    w = torch.rand(50_000, generator=g)
    cdf = torch.cumsum(w, 0)
    cdf = (cdf / cdf[-1]).to(cuda_device)
    u = torch.rand(n, generator=g).to(cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = ps.powerlaw_sample(u, cdf)
    side.synchronize()
    torch.testing.assert_close(got, ps.powerlaw_sample_plain(u, cdf),
                               rtol=0, atol=0)


# ------------------------------------------------------------ resumable
def _resume_case(device, backend, cpn=4, chunk=1 << 15, nodes=4):
    from repro_torch.core.resume import ResumableRunner
    from repro_torch.malgen import make_seed_streaming

    cfg = MalGenConfig(num_sites=20_000, num_entities=50_000)
    plan = ExchangePlan(impl="counting", capacity_factor=0.5) \
        if backend == "mapreduce" else ExchangePlan()
    seed = make_seed_streaming(3, cfg, nodes * cpn, chunk, device=device)
    runner = ResumableRunner(seed, cfg, nodes=nodes, num_chunks=nodes * cpn,
                             chunk_records=chunk, segment_chunks=2,
                             backend=backend, plan=plan, device=device)
    return cfg, plan, seed, runner


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ("streams", "sphere", "mapreduce",
                                     "mapreduce_combiner"))
def test_resumable_equals_the_streaming_engine_on_the_card(cuda_device,
                                                           backend,
                                                           tmp_path):
    """Segmented, checkpointed, killed at a boundary and resumed: the same
    histogram, rho bits and ShuffleStats as the streaming engine; the
    restored carry lies on the card."""
    from repro_torch.core import malstone_run_streaming
    from repro_torch.faults import FaultPlan, SimulatedKill

    cfg, plan, seed, runner = _resume_case(cuda_device, backend)
    want, ws = malstone_run_streaming(
        seed, cfg.num_sites, nodes=4, cfg=cfg, num_chunks=16,
        chunk_records=1 << 15, backend=backend, plan=plan,
        device=cuda_device, return_shuffle_stats=True)
    with pytest.raises(SimulatedKill):
        runner.run(checkpoint_dir=str(tmp_path),
                   faults=FaultPlan(kill_at_segment=1, kill_mode="raise"))
    for out in (runner.run(), runner.run(checkpoint_dir=str(tmp_path))):
        assert torch.equal(out.result.total, want.total)
        assert torch.equal(out.result.rho.view(torch.int32),
                           want.rho.view(torch.int32))
        assert _stats(out.shuffle_stats) == _stats(ws)
        assert out.result.rho.device.type == "cuda"
    assert out.report.resumed_from_step == 1


@pytest.mark.cuda
def test_resumable_launches_the_path_kernels(cuda_device):
    """A fault-free mapreduce run: K6 twice a node a step, K1 and K2 a
    step, K3 at least a step, K7 once; a run with a bad host adds one K7 a
    diagnosis."""
    from repro_torch.faults import FaultPlan, RetryPolicy

    _, _, _, runner = _resume_case(cuda_device, "mapreduce")
    torch.cuda.synchronize()
    reset_launch_counts()
    runner.run()
    got = launch_counts()
    assert got["powerlaw_sample"] == 2 * 4 * 4
    assert got["count_scatter.count"] == got["count_scatter.scatter"] == 4
    assert got["segment_hist.packed"] >= 4
    assert got["windowed_ratio"] == 1
    assert got["segment_hist"] == got["windowed_ratio.masked"] == 0
    reset_launch_counts()
    out = runner.run(faults=FaultPlan(bad_hosts=(0,), kill_mode="raise"),
                     retry=RetryPolicy(max_attempts=6, backoff_s=0.0),
                     num_hosts=4)
    assert out.report.alarmed_hosts == [0]
    assert launch_counts()["windowed_ratio"] == \
        1 + out.report.segments_retried


@pytest.mark.cuda
@pytest.mark.parametrize("buckets", (8, 52))
def test_nodedoctor_runs_k7_and_equals_the_cpu(cuda_device, buckets):
    """The diagnosis on the card launches K7 once, and its report equals
    the CPU's bit for bit (K7 equals its plain version; the CUSUM's adds
    are IEEE float32 adds in one order on both)."""
    from repro_torch.core.nodedoctor import diagnose_telemetry
    from repro_torch.kernels.windowed_ratio import ops as wr

    rng = np.random.default_rng(buckets)
    n = 4000
    host = rng.integers(0, 6, n)
    cols = (host, np.arange(n), rng.integers(0, buckets, n),
            rng.random(n) < np.where(host == 2, 0.4, 0.03))
    reset_launch_counts()
    got = diagnose_telemetry(*cols, num_hosts=6, num_buckets=buckets,
                             device=cuda_device)
    assert launch_counts()["windowed_ratio"] == 1
    want = diagnose_telemetry(*cols, num_hosts=6, num_buckets=buckets,
                              device="cpu")
    for f in ("rho", "cusum"):
        assert torch.equal(getattr(got, f).cpu().view(torch.int32),
                           getattr(want, f).view(torch.int32)), f
    assert torch.equal(got.alarm.cpu(), want.alarm)
    assert torch.equal(got.suspect_rank.cpu(), want.suspect_rank)
    hist = torch.zeros(6, buckets, 2, dtype=torch.int32)
    np.add.at(hist.numpy(), (cols[0], cols[2], 0), 1)
    np.add.at(hist.numpy(), (cols[0], cols[2], 1), cols[3].astype(np.int32))
    hist = hist.to(cuda_device)
    for a, b in zip(wr.windowed_ratio(hist), wr.windowed_ratio_plain(hist)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_like_device(cuda_device, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    state = {"carry": torch.arange(12, dtype=torch.int32,
                                   device=cuda_device).reshape(3, 4),
             "emb": torch.randn(5, device=cuda_device).to(torch.bfloat16),
             "chunks_done": np.int32(2)}
    save_checkpoint(tmp_path, 1, state, num_shards=2)
    got = load_checkpoint(tmp_path, 1, state)
    assert got["carry"].device.type == got["emb"].device.type == "cuda"
    assert got["chunks_done"].device.type == "cpu"
    assert torch.equal(got["carry"], state["carry"])
    assert torch.equal(got["emb"].view(torch.int16),
                       state["emb"].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("p", (4, 8))
@pytest.mark.parametrize("first", ("1", "3", "P-1"))
def test_packed_hist_first_node_equals_plain(cuda_device, p, first):
    """K3 over the rows of nodes first_node .. P - 1 (a gang's rank holds
    a block of the nodes): the histogram, the hot list and the tiled
    launch equal their plain versions, and the one-process launch's
    rows."""
    first_node = p - 1 if first == "P-1" else int(first)
    s_local = 3_000
    words = _packed(p, 200_000, s_local, cuda_device)
    mine = words[first_node:].contiguous()
    kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=52)
    reset_launch_counts()
    got = segment_hist_packed_words(mine, first_node=first_node, **kw)
    assert launch_counts()["segment_hist.packed"] == 1
    torch.testing.assert_close(got, segment_hist_packed_words_plain(
        mine, first_node=first_node, **kw), rtol=0, atol=0)
    torch.testing.assert_close(
        got, segment_hist_packed_words(words, **kw)[first_node:],
        rtol=0, atol=0)
    sh = segment_hist_ops
    hot = sh.segment_hist_packed_hot_sites(mine, first_node=first_node, **kw)
    geo = sh.launch_geometry(mine, mine.shape[1], 52)
    torch.testing.assert_close(hot, sh.hot_sites_plain(
        sh.word_sites(mine, first_node=first_node, **kw), geo.sample,
        geo.threshold), rtol=0, atol=0)
    torch.testing.assert_close(sh.segment_hist_packed_words_tiled(
        mine, hot, first_node=first_node, **kw), got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rows"):
        segment_hist_packed_words(words, first_node=1, **kw)


@pytest.mark.cuda
def test_gang_on_the_card_equals_one_process(cuda_device, tmp_path):
    """tools/gang_check.py as a gang of 2 ranks sharing the card (gloo,
    host-staged collectives): every rank's histogram, rho bits and
    ShuffleStats equal the one-process run on the card, and each rank
    launches K1-K3 and K6 over its own nodes, and K9 once a round."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "tools"))
    import gang_check

    cases = ["seed_mapreduce_counting", "seed_streams", "log_sphere",
             "seed_mapreduce_counting_overlap_on"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(root / "tools" / "gang_check.py"),
         "--num-processes", "2", "--nodes", "4", "--out", str(tmp_path),
         "--timeout", "240", "--cases", *cases],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    inputs = gang_check.make_inputs("small", 4, cuda_device)
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        for name in cases:
            want = gang_check.result_arrays(*gang_check.case_result(
                name, inputs, 4, cuda_device))
            for field, value in want.items():
                a, b = got[f"P4/{name}/{field}"], value
                if field == "rho":
                    a, b = a.view(np.int32), b.view(np.int32)
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {field}")
        assert int(got["P4/seed_mapreduce_counting/launches_"
                       "segment_hist.packed"]) >= 2
        for name in cases:       # K9 a round; none on streams and sphere
            assert int(got[f"P4/{name}/launches_k9"]) == int(
                got[f"P4/{name}/launches_segment_hist.packed"]), name
        assert int(got["P4/seed_mapreduce_counting/launches_"
                       "powerlaw_sample"]) == 2 * 2 * 2


# ------------------------------------------------- the static analysis
def _analysis_case_names():
    from repro_torch.analysis.kernel_passes import kernel_analysis_cases

    return [c["name"] for c in kernel_analysis_cases()]


@pytest.fixture(scope="module")
def card_launch_records():
    """Every analysis case's launch records, taken once in a fresh process:
    in this one, after the tests above, the profiler drops the first
    kernel records of each session."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.analysis.kernel_passes import card_launches_in_child

    return card_launches_in_child()


@pytest.mark.cuda
@pytest.mark.parametrize("name", _analysis_case_names())
def test_launch_plan_equals_the_profilers_records(cuda_device, name,
                                                 card_launch_records):
    """Each analysis case's wrapper, run once under the profiler, launches
    what its ``launch_plan`` says: kernels in order, grid, block, static
    plus dynamic shared memory, and the registers and static shared bytes
    ``cudaFuncGetAttributes`` reports (the ``ops.py`` table)."""
    from repro_torch.analysis import kernel_passes as kp

    case = {c["name"]: c for c in kp.kernel_analysis_cases()}[name]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kp.compare_with_card(case, card_launch_records[name],
                                kp.card_attributes(case["source"]),
                                sms) == []


@pytest.mark.cuda
def test_driver_family_on_the_card_is_within_its_budgets(cuda_device):
    """Every driver on the card: no raise, no dtype change, host syncs on
    CUDA tensors within the budget its target declares."""
    from repro_torch.analysis import AnalysisContext, run_passes

    ctx = AnalysisContext(device=cuda_device)
    assert run_passes(["drivers"], ctx) == []
    assert all(r.card_syncs is not None
               for r in ctx.cache["driver_runs"].values())


@pytest.mark.cuda
def test_collective_family_on_the_card_is_clean(cuda_device):
    """The exchanges' recorded collectives on the card, and a gang of 2
    sharing it, as ``python -m repro_torch.analysis`` runs them by
    default."""
    from repro_torch.analysis import AnalysisContext, run_passes

    ctx = AnalysisContext(device=cuda_device)
    assert run_passes(["collectives"], ctx) == []


# -- the trainer slice: AdamW, int8 error feedback, the token pipeline and
# the trainer's doctor on the card against the CPU ------------------------

def _optim_tree(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((256, 96), generator=g).to(device),
            "b": torch.randn(96, generator=g).to(device),
            "norm": {"scale": torch.randn(33, generator=g).to(device)}}


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_on_card_equals_cpu(cuda_device, moment_dtype, grad_clip):
    """Each of 5 updates on the card against the CPU's update of the same
    inputs: step exact, params and f32 moments rtol 1e-5 / atol 1e-6,
    bf16 moments within one bf16 ulp of the larger value plus 2^-20 of
    the terms the f32 update summed (|new| + |old|): where b1 * mu and
    (1 - b1) * g cancel, the clip factor's one f32 ulp (the grad norm's
    reduction order differs between the card and the CPU) is two bf16
    ulps of the small result."""
    from repro_torch.common import tree as tr
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg = AdamWConfig(moment_dtype=moment_dtype, grad_clip=grad_clip)
    params = _optim_tree(cuda_device)
    state = adamw_init(params, cfg)
    for i in range(5):
        grads = _optim_tree(cuda_device, seed=i + 1)
        p, s, m = adamw_update(params, grads, state, cfg)
        cpu = [tr.tree_map(lambda x: x.cpu(), t)
               for t in (params, grads, state)]
        cp, cs_, cm = adamw_update(*cpu, cfg)
        assert int(s.step) == int(cs_.step) == i + 1
        assert s.step.dtype == torch.int32
        for a, b, old in zip(tr.tree_leaves((p, s.mu, s.nu)),
                             tr.tree_leaves((cp, cs_.mu, cs_.nu)),
                             tr.tree_leaves((params, state.mu, state.nu))):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            a = a.cpu()
            if a.dtype == torch.bfloat16:
                big = torch.maximum(a.float().abs(), b.float().abs())
                _, e = torch.frexp(big)
                ulp = torch.ldexp(torch.ones_like(big), (e - 8).clamp(
                    min=-133))
                slack = ulp + (big + old.cpu().float().abs()) * 2.0**-20
                assert bool(((a.float() - b.float()).abs() <= slack).all())
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(m["grad_norm"].cpu(), cm["grad_norm"],
                                   rtol=1e-6, atol=0)
        params, state = p, s


@pytest.mark.cuda
def test_int8_error_feedback_on_card_bits_equal_cpu(cuda_device):
    from repro_torch.common import tree as tr
    from repro_torch.optim import compress_int8
    from repro_torch.optim.compression import tree_ef_compress

    errors = tr.tree_map(torch.zeros_like, _optim_tree(cuda_device))
    for r in range(3):
        grads = _optim_tree(cuda_device, seed=10 + r)
        est, err = tree_ef_compress(grads, errors)
        c_est, c_err = tree_ef_compress(
            tr.tree_map(lambda x: x.cpu(), grads),
            tr.tree_map(lambda x: x.cpu(), errors))
        for a, b in zip(tr.tree_leaves((est, err)),
                        tr.tree_leaves((c_est, c_err))):
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
        for x in tr.tree_leaves(grads):
            q, s = compress_int8(x * 1e3)
            cq, cs_ = compress_int8(x.cpu() * 1e3)
            assert torch.equal(q.cpu(), cq)
            assert torch.equal(s.cpu().view(torch.int32),
                               cs_.view(torch.int32))
        errors = err


def _toy_step(state, batch):
    w, opt_step = state
    x = batch["tokens"].to(torch.float32)
    loss = torch.mean((x.mean() - w) ** 2)
    w = w - 0.1 * 2 * (w - x.mean())
    return (w, opt_step + 1), {"loss": loss}


@pytest.mark.cuda
def test_trainer_doctor_on_card_equals_cpu(cuda_device, tmp_path,
                                           monkeypatch):
    """The bad-host run on the card (malgen tokens, K6 a batch) against
    the same run on the CPU over the card's batches, both on a fake clock:
    equal reports; K7 launched once a doctor run, K6 once a batch plus the
    marked stream."""
    import itertools
    import types

    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.malgen import MalGenConfig
    from repro_torch.runtime import TrainConfig, Trainer
    from repro_torch.runtime import trainer as trainer_mod

    runs = {"doctor": 0}
    real = trainer_mod.diagnose

    def counting(*a, **k):
        runs["doctor"] += 1
        return real(*a, **k)

    def hook(step, host):
        if host == 5 and step > 8:
            raise RuntimeError("flaky host 5")

    def run(device, batch_fn, sub):
        counter = itertools.count()
        monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
            monotonic=lambda: next(counter) / 1024.0))
        cfg = TrainConfig(total_steps=80, ckpt_every=10, doctor_every=8,
                          ckpt_dir=str(tmp_path / sub))
        state = (torch.zeros((), device=device),
                 torch.zeros((), dtype=torch.int32, device=device))
        return Trainer(cfg, _toy_step, state, batch_fn, fault_hook=hook,
                       device=device).run()

    monkeypatch.setattr(trainer_mod, "diagnose", counting)
    batches = {}
    reset_launch_counts()
    pipe = TokenPipeline(DataConfig(source="malgen", global_batch=4,
                                    seq_len=64, malgen=MalGenConfig(
                                        num_sites=500, num_entities=2000)),
                         device=cuda_device)

    def card_fn(step):
        batches.setdefault(step, []).append(pipe.batch_at(step))
        return batches[step][-1]

    got = run(cuda_device, card_fn, "card")
    torch.cuda.synchronize()
    counts = launch_counts()
    made = sum(len(v) for v in batches.values())
    assert counts["windowed_ratio"] == runs["doctor"] > 0
    assert counts["powerlaw_sample"] == made + 1
    want = run(torch.device("cpu"),
               lambda s: {k: v.cpu() for k, v in batches[s][0].items()},
               "cpu")
    for key in ("final_step", "restarts", "retries", "blocklist"):
        assert got[key] == want[key], key
    assert 5 in got["blocklist"]
    assert [(h["step"], h["host"]) for h in got["history"]] == [
        (h["step"], h["host"]) for h in want["history"]]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=1e-6)


# ------------------------------------------------------------ the model

def _f32_smoke(arch):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    return cfg


def _recording_routes(monkeypatch):
    """Record each MoE layer's expert choices (``[n, g, k]`` on the
    host) as the forward runs."""
    from repro_torch.models import mlp as M

    routes, real = [], M.moe_apply

    def moe_apply(p, x, *, num_experts, top_k, group_size=256, **kw):
        n, g = M.moe_groups(x.shape[0] * x.shape[1], group_size)
        _, _, idx = M.moe_route(p["router"], x.reshape(n, g, -1), top_k)
        routes.append(idx.cpu())
        return real(p, x, num_experts=num_experts, top_k=top_k,
                    group_size=group_size, **kw)

    monkeypatch.setattr(M, "moe_apply", moe_apply)
    return routes


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma2_2b",
                                  "granite_moe_1b_a400m",
                                  "recurrentgemma_2b", "rwkv6_7b"])
def test_model_forward_on_card_equals_cpu(cuda_device, arch, monkeypatch):
    """The f32 smoke model from one set of parameters on the card and on
    the CPU: the router's expert choices equal first, then logits within
    2e-3 (2e-2 for MoE) and the loss; the f32 products stay f32."""
    from repro_torch.common import tree as tr
    from repro_torch.models import transformer as T

    cfg = _f32_smoke(arch)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p, _ = T.init_params(cfg, generator=gen, device=cuda_device)
    cpu_p = tr.tree_map(lambda x: x.cpu(), p)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64), dtype=np.int32))
    batch = {"tokens": toks, "labels": toks}
    routes = _recording_routes(monkeypatch)
    got = T.forward(p, cfg, {k: v.to(cuda_device) for k, v in batch.items()})
    card_routes, routes[:] = list(routes), []
    want = T.forward(cpu_p, cfg, batch)
    for a, b in zip(card_routes, routes):
        assert torch.equal(a, b)
    assert len(card_routes) == len(routes)
    tol = 2e-2 if cfg.family == "moe" else 2e-3
    assert got.device.type == "cuda" and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    loss, _ = T.lm_loss(p, cfg, {k: v.to(cuda_device)
                                 for k, v in batch.items()})
    cpu_loss, _ = T.lm_loss(cpu_p, cfg, batch)
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=tol, atol=tol)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 513, 4096])
def test_rglru_scan_on_card_equals_cpu(cuda_device, s):
    """The associative scan is products and sums of the same f32 pairs in
    the same association on both, with subnormals kept on both: equal
    bits."""
    from repro_torch.models import rglru as R

    g = torch.Generator().manual_seed(s)
    a = torch.rand((2, s, 96), generator=g)
    b = torch.randn((2, s, 96), generator=g)
    got = R.associative_scan(R._linear_combine, (a.to(cuda_device),
                                                 b.to(cuda_device)), dim=1)
    want = R.associative_scan(R._linear_combine, (a, b), dim=1)
    for x, y in zip(got, want):
        assert x.device.type == cuda_device.type
        assert torch.equal(x.cpu(), y)


def _small_params(init, *args):
    """f32 parameters of a small mixer on the CPU; the leaves initialised
    to constants (biases, mixes, the group norm, the conv) get seeded
    draws added, so that every parameter matters."""
    from repro_torch.models.layers import ParamRng

    p, _ = init(ParamRng(torch.Generator().manual_seed(1), "cpu"), *args,
                torch.float32)
    g = torch.Generator().manual_seed(2)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k.startswith(("maa_", "ln_x_", "conv_")) or k == "b":
                v.add_(0.3 * torch.randn(v.shape, generator=g))
        return tree

    return walk(p)


@pytest.mark.cuda
def test_recurrent_mixers_on_card_equal_cpu(cuda_device):
    """The RG-LRU block and the RWKV-6 time-mix (the WKV loop) and
    channel-mix at f32 from one set of parameters, with their states, on
    the card and on the CPU within 2e-4; each decode step after the
    block's state within 2e-4 of the CPU's."""
    from repro_torch.common import tree as tr
    from repro_torch.models import rglru as R
    from repro_torch.models import rwkv6 as W

    tol = dict(rtol=2e-4, atol=2e-4)
    x = torch.randn((2, 40, 64), generator=torch.Generator().manual_seed(3))
    dx = x.to(cuda_device)

    def on_card(tree):
        return tr.tree_map(lambda z: z.to(cuda_device), tree)

    p = _small_params(R.rglru_init, 64, 48, 4)
    got, gs = R.rglru_block(on_card(p), dx[:, :39], return_state=True)
    want, ws = R.rglru_block(p, x[:, :39], return_state=True)
    torch.testing.assert_close(got.cpu(), want, **tol)
    for a, b in zip(gs, ws):
        torch.testing.assert_close(a.cpu(), b, **tol)
    got, _ = R.rglru_decode_step(on_card(p), dx[:, 39:], gs)
    want, _ = R.rglru_decode_step(p, x[:, 39:], ws)
    torch.testing.assert_close(got.cpu(), want, **tol)

    p = _small_params(W.rwkv6_init, 64, 8)
    got, (gs, gshift) = W.rwkv6_time_mix(on_card(p), dx[:, :39], 8,
                                         return_state=True)
    want, (ws, wshift) = W.rwkv6_time_mix(p, x[:, :39], 8,
                                          return_state=True)
    torch.testing.assert_close(got.cpu(), want, **tol)
    torch.testing.assert_close(gs.cpu(), ws, **tol)
    assert torch.equal(gshift.cpu(), wshift)
    got, _, _ = W.rwkv6_time_mix_step(on_card(p), dx[:, 39:], gs, gshift, 8)
    want, _, _ = W.rwkv6_time_mix_step(p, x[:, 39:], ws, wshift, 8)
    torch.testing.assert_close(got.cpu(), want, **tol)

    p = _small_params(W.rwkv6_cmix_init, 64, 128)
    got, glast = W.rwkv6_cmix(on_card(p), dx[:, :39])
    want, wlast = W.rwkv6_cmix(p, x[:, :39])
    torch.testing.assert_close(got.cpu(), want, **tol)
    got, _ = W.rwkv6_cmix(on_card(p), dx[:, 39:], shift=glast)
    want, _ = W.rwkv6_cmix(p, x[:, 39:], shift=wlast)
    torch.testing.assert_close(got.cpu(), want, **tol)


def _naive_attention(q, k, v, kind, window=0, cap=None, q_offset=0):
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    if cap:
        s = torch.tanh(s / cap) * cap
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    m = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if kind == "causal":
        m = kpos[None] <= qpos[:, None]
    if kind == "local":
        m = (kpos[None] <= qpos[:, None]) & (kpos[None] > qpos[:, None]
                                             - window)
    p = torch.softmax(torch.where(m, s, -1e30), -1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (128, 128, 8, 4, "causal", 0, None, 0),
    (100, 100, 8, 8, "causal", 0, 30.0, 0),
    (96, 96, 4, 2, "local", 8, None, 0),
    (128, 128, 8, 2, "bidir", 0, None, 0),
    (16, 160, 4, 2, "local", 16, 50.0, 144),
])
def test_flash_attention_on_card_equals_naive(cuda_device, case):
    """f32 against the naive attention within 2e-4 (the TF32 flags off);
    bf16 (the f32-output product) against the CPU's bf16 within 2e-2."""
    from repro_torch.models.attention import flash_attention

    sq, sk, hq, hkv, kind, window, cap, qo = case
    g = torch.Generator().manual_seed(sq + sk + hq)
    q = torch.randn((2, sq, hq, 16), generator=g)
    k = torch.randn((2, sk, hkv, 16), generator=g)
    v = torch.randn((2, sk, hkv, 16), generator=g)
    kw = dict(kind=kind, window=window, attn_softcap=cap, q_offset=qo,
              q_chunk=32, kv_chunk=48)
    dq, dk, dv = (t.to(cuda_device) for t in (q, k, v))
    got = flash_attention(dq, dk, dv, **kw)
    torch.testing.assert_close(
        got, _naive_attention(dq, dk, dv, kind, window, cap, qo),
        rtol=2e-4, atol=2e-4)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got_bf = flash_attention(*(t.to(cuda_device) for t in bf), **kw)
    assert got_bf.dtype == torch.bfloat16
    torch.testing.assert_close(got_bf.cpu().float(),
                               flash_attention(*bf, **kw).float(),
                               rtol=2e-2, atol=2e-2)


# ------------------------------------------------- train and decode steps

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bmm_f32_gradient_on_card_equals_cpu(cuda_device, dtype):
    """``_bmm_f32``'s gradients on the card (the f32-output product's own
    backward at bf16) against autograd through the CPU's widened operands:
    f32 within rtol = atol = 1e-4 (summation order), bf16 within one bf16
    ulp (rtol = atol = 2^-7: the same f32 products rounded once)."""
    from repro_torch.models.attention import _bmm_f32

    g = torch.Generator().manual_seed(11)
    dt = getattr(torch, dtype)
    a = torch.randn((4, 33, 16), generator=g).to(dt)
    b = torch.randn((4, 16, 40), generator=g).to(dt)
    dc = torch.randn((4, 33, 40), generator=g)

    def grads(device):
        x = a.to(device).requires_grad_(True)
        y = b.to(device).requires_grad_(True)
        out = _bmm_f32(x, y)
        assert out.dtype == torch.float32
        out.backward(dc.to(device))
        return out.detach().cpu(), x.grad.cpu(), y.grad.cpu()

    tol = (dict(rtol=2 ** -7, atol=2 ** -7) if dtype == "bfloat16"
           else dict(rtol=1e-4, atol=1e-4))
    for got, want in zip(grads(cuda_device), grads("cpu")):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
def test_bf16_train_step_on_card(cuda_device, monkeypatch):
    """One bf16 ``make_train_step`` of llama3-8b's smoke config on the
    card, through the f32-output product's backward: a finite loss and
    grad norm within 5e-2 relative of the CPU's step from the same
    parameters (bf16 products round differently), moved parameters, and
    an input state left as it was."""
    from repro_torch.common import tree as tr
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as A
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig

    calls = []
    real = A._BmmF32.apply
    monkeypatch.setattr(A._BmmF32, "apply",
                        lambda *a: calls.append(1) or real(*a))
    cfg = get_smoke_config("llama3_8b")
    opt = AdamWConfig(lr=1e-3)
    state, _ = S.make_train_state(
        cfg, opt, generator=torch.Generator(device=cuda_device)
        .manual_seed(0), device=cuda_device)
    cpu_state = tr.tree_map(lambda x: x.cpu(), state)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32), dtype=np.int32))
    batch = {"tokens": toks, "labels": toks}
    step = S.make_train_step(cfg, opt, warmup_steps=1)
    new, m = step(state, {k: v.to(cuda_device) for k, v in batch.items()})
    assert calls, "the card's attention did not take the f32-output product"
    _, cm = step(cpu_state, batch)
    for key in ("loss", "grad_norm"):
        assert torch.isfinite(m[key]).item()
        torch.testing.assert_close(m[key].cpu(), cm[key], rtol=5e-2,
                                   atol=0)
    before = state.params["layers"][0]["mixer"]["wq"]["w"]
    assert before.dtype == torch.bfloat16
    assert not torch.equal(new.params["layers"][0]["mixer"]["wq"]["w"],
                           before)
    assert torch.equal(before.cpu(),
                       cpu_state.params["layers"][0]["mixer"]["wq"]["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma2_2b",
                                  "recurrentgemma_2b", "rwkv6_7b"])
def test_decode_on_card_equals_cpu(cuda_device, arch):
    """The f32 smoke model from one set of parameters: the fused prefill
    of 20 tokens and two decode steps on the card against the CPU's,
    logits and every float cache leaf within 2e-3, ``length`` and ``pos``
    exact (gemma2's and recurrentgemma's rings of 16 wrap)."""
    from repro_torch.common import tree as tr
    from repro_torch.models import decoding as D
    from repro_torch.models import transformer as T

    cfg = _f32_smoke(arch)
    p, _ = T.init_params(cfg, generator=torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    cpu_p = tr.tree_map(lambda x: x.cpu(), p)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 22), dtype=np.int32))

    def run(params, device):
        last, cache, _ = D.prefill(params, cfg, {"tokens": toks[:, :20]
                                                 .to(device)}, 36)
        out = [last]
        for i in (20, 21):
            lg, cache = D.decode_step(params, cfg, toks[:, i:i + 1]
                                      .to(device), cache)
            out.append(lg)
        return [x.cpu() for x in out], tr.tree_flatten_with_paths(cache)

    got, got_cache = run(p, cuda_device)
    want, want_cache = run(cpu_p, "cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    assert [n for n, _ in got_cache] == [n for n, _ in want_cache]
    for (name, a), (_, b) in zip(got_cache, want_cache):
        if b.dtype == torch.int32:
            assert torch.equal(a.cpu(), b), name
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_decode_writes_the_cache_in_place_on_card(cuda_device):
    """Eight decode steps of a stacked 8-layer model with a 4,096-token
    cache: the cache's buffers keep their addresses, and the memory
    allocated beyond what was held before the steps peaks below half the
    cache's bytes (a second copy of the cache would need all of them; one
    layer's K and V, the decode attention's transient layout, need an
    eighth)."""
    import dataclasses

    from repro_torch.common import tree as tr
    from repro_torch.models import decoding as D
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(_f32_smoke("llama3_8b"), num_layers=8)
    assert cfg.uniform_period < cfg.num_layers
    p, _ = T.init_params(cfg, generator=torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    toks = torch.zeros((2, 16), dtype=torch.int32, device=cuda_device)
    with torch.inference_mode():
        logits, cache, _ = D.prefill(p, cfg, {"tokens": toks}, 4096)
        leaves = tr.tree_leaves(cache)
        ptrs = [x.data_ptr() for x in leaves]
        cache_bytes = tr.tree_bytes(cache)
        del logits
        torch.cuda.synchronize(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        before = torch.cuda.memory_allocated(cuda_device)
        tok = toks[:, :1]
        for _ in range(8):
            _, cache = D.decode_step(p, cfg, tok, cache)
        torch.cuda.synchronize(cuda_device)
        peak = torch.cuda.max_memory_allocated(cuda_device) - before
    assert [x.data_ptr() for x in tr.tree_leaves(cache)] == ptrs
    assert int(cache[0]["kind_attn"].length[0]) == 16 + 8
    assert peak < cache_bytes / 2, (peak, cache_bytes)


# ------------------------------------------------- pipeline parallelism
def _pipeline_tool():
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "tools"))
    import pipeline_gang

    return root, pipeline_gang


@pytest.mark.cuda
def test_pipeline_bit_equals_the_blocks_on_card(cuda_device):
    """llama3-8b's blocks at full width and bf16, 2 layers in 2 stages, 4
    microbatches of [1, 256, 4096]: the pipeline's output bit-equals the
    blocks applied to each microbatch in turn, and no K1-K7 launches."""
    from repro_torch.distributed import PipelineConfig, pipeline_apply

    _, pg = _pipeline_tool()
    cfg = pg.model_cfg("llama3_8b", layers=2)
    params = pg.stage_blocks(cfg, range(2), 1, cuda_device)
    x = pg.hidden_states(cfg, 4, 256, cuda_device)
    fn = pg.blocks_fn(cfg, 1)
    reset_launch_counts()
    with torch.no_grad():
        got = pipeline_apply(fn, params, x, PipelineConfig(2, 4))
        want = torch.cat([pg.sequential(fn, params, x[k:k + 1], 2)
                          for k in range(4)])
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not any(launch_counts().values())


@pytest.mark.cuda
def test_ring_collective_of_a_cuda_tensor_through_the_host(cuda_device,
                                                           tmp_path):
    """tools/pipeline_gang.py as a gang of 2 ranks sharing the card: the
    ring ``ppermute`` and a partial one of CUDA rows (staged through
    pinned host memory) equal the one-process op, and the pipeline's
    output on both ranks equals the one-process pipeline on the card."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.common import nodes
    from repro_torch.distributed import PipelineConfig, pipeline_apply
    from repro_torch.launch import mesh

    root, pg = _pipeline_tool()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(root / "tools" / "pipeline_gang.py"),
         "--num-processes", "2", "--arch", "llama3_8b", "--smoke",
         "--layers", "4", "--stages", "4", "--microbatches", "4",
         "--batch", "4", "--seq", "32", "--runs", "1", "--collectives",
         "--device", "cuda", "--out", str(tmp_path), "--timeout", "240"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    rows = pg.collective_input(4).to(cuda_device)
    ring = nodes.ppermute(rows).cpu()
    partial = nodes.ppermute(rows, pg.partial_perm(4)).cpu()
    cfg = pg.model_cfg("llama3_8b", smoke=True, layers=4)
    params = pg.stage_blocks(cfg, range(4), 1, cuda_device)
    with torch.no_grad():
        out = pipeline_apply(pg.blocks_fn(cfg, 1), params,
                             pg.hidden_states(cfg, 4, 32, cuda_device),
                             PipelineConfig(4, 4))
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["ppermute_ring"] == ring[2 * r:2 * r + 2].tolist()
        assert res["ppermute_partial"] == partial[2 * r:2 * r + 2].tolist()
        assert res["digest"] == mesh.checksum([out])
        assert res["clock"]["d2h_ms"] > 0 and res["clock"]["bytes"] > 0


# ------------------------------------------- K8, the combiner's exchange
@pytest.mark.cuda
@pytest.mark.parametrize("p,s_local,w,skew", [
    (8, 15_000, 52, 0),      # the benchmark cell's step: 16-byte vectors
    (4, 1_001, 51, 0),       # odd weeks: 8-byte vectors
    (3, 700, 52, 1),         # both one int past a 16-byte boundary: 4 bytes
    (8, 3, 1, 2),            # one week, 8 bytes past it: 8-byte vectors
    (1, 5, 3, 0),            # one node
])
def test_combine_blocks_equals_plain(cuda_device, p, s_local, w, skew):
    """K8 over every int32 value (its sums wrap past 2^31) equals its
    plain version, the torch path, bit for bit; one launch a call."""
    from repro_torch.kernels.combine_blocks import ops as cb

    g = torch.Generator(device=cuda_device).manual_seed(p * 1000 + w)

    def ints(n):
        buf = torch.randint(-2**31, 2**31 - 1, (n + skew,), generator=g,
                            dtype=torch.int32, device=cuda_device)
        return buf[skew:]

    local = ints(p * p * s_local * w * 2).view(p, p * s_local, w, 2)
    carry = ints(p * s_local * w * 2).view(p, s_local, w, 2)
    want = cb.combine_blocks_plain(local.cpu(), carry.cpu())
    assert cb.vector_ints(local.data_ptr(), carry.data_ptr(), w) == (
        {0: 4 if w % 2 == 0 else 2, 1: 1, 2: 2}[skew])
    before = cb.combine_blocks.launches
    out = cb.combine_blocks(local, carry)
    torch.cuda.synchronize(cuda_device)
    assert out is carry and cb.combine_blocks.launches == before + 1
    assert torch.equal(carry.cpu(), want)
    assert int(local.cpu().to(torch.int64).abs().max()) > 2**30


@pytest.mark.cuda
@pytest.mark.parametrize("nodes_", (4, 8))
def test_combiner_folds_through_k8_on_the_card(cuda_device, nodes_):
    """The streaming engine's combiner on the card over a log made there:
    one K8 launch and one K4 launch a fold, the answer equal bit for bit
    to the CPU's combiner (the torch path) over the same records, and to
    sphere's on the card."""
    from repro_torch.kernels.combine_blocks import ops as cb

    cfg = MalGenConfig(num_sites=1001, num_entities=5000)
    steps, chunk = 3, 1 << 14
    seed = make_seed(11, cfg, nodes_ * steps * chunk, device=cuda_device)
    log = generate_shards_device(seed, cfg, nodes_, steps * chunk,
                                 device=cuda_device).map(
        lambda c: c.reshape(-1))
    want = run(log.to("cpu"), 1001, nodes=nodes_, engine="streaming",
               chunk_records=chunk, backend="mapreduce_combiner",
               device="cpu")
    reset_launch_counts()
    before = cb.combine_blocks.launches
    got = run(log, 1001, nodes=nodes_, engine="streaming",
              chunk_records=chunk, backend="mapreduce_combiner",
              device=cuda_device)
    assert cb.combine_blocks.launches - before == steps
    assert launch_counts()["segment_hist"] == steps
    sphere = run(log, 1001, nodes=nodes_, engine="streaming",
                 chunk_records=chunk, backend="sphere", device=cuda_device)
    for other in (want, sphere):
        assert torch.equal(got.total.cpu(), other.total.cpu())
        assert torch.equal(got.marked.cpu(), other.marked.cpu())
        assert torch.equal(got.rho.cpu().view(torch.int32),
                           other.rho.cpu().view(torch.int32))


# ------------------------------------- K9, the shuffle's round of words
def _malgen_words(device, sites, rps=1 << 23, p=8):
    """A step's words ordered by destination, over MalGen's records at
    [p, rps] (``sites`` "skewed") or the same records with sites drawn
    uniformly."""
    from repro_torch.core.backends.mapreduce import order_words

    cfg = MalGenConfig()
    seed = make_seed(36, cfg, p * rps, device=device)
    log = generate_shards_device(seed, cfg, p, rps, device=device)
    if sites == "uniform":
        log = log._replace(site_id=torch.randint(
            0, cfg.num_sites, log.site_id.shape, device=device,
            dtype=torch.int32))
    return order_words(log, 52, "counting")


@pytest.mark.cuda
@pytest.mark.parametrize("sites", ["skewed", "uniform"])
def test_ship_buckets_equals_plain_at_the_cells_step(cuda_device, sites):
    """K9 at the benchmark's mapreduce step (8 x 2^23 words, C = 2^22,
    round 0, and round 1, past every segment) equals its plain version,
    the torch path, bit for bit; one launch a call."""
    from repro_torch.core.backends.mapreduce import static_capacity
    from repro_torch.kernels.ship_buckets import ops as sb

    words, starts = _malgen_words(cuda_device, sites)
    capacity = static_capacity(1 << 23, 8, 4.0)
    assert capacity == 1 << 22
    for r in (0, 1):
        before = sb.ship_buckets.launches
        got = sb.ship_buckets(words, starts, r, capacity)
        torch.cuda.synchronize(cuda_device)
        assert sb.ship_buckets.launches == before + 1
        want = sb.ship_buckets_plain(words, starts, r, capacity)
        assert torch.equal(got, want), r
        del want
    # the segments start off 16-byte boundaries: K9 cuts its vectors
    assert {int(x) % 4 for x in starts[:, :-1].reshape(-1).cpu()} != {0}


@pytest.mark.cuda
@pytest.mark.parametrize("world,rank", [(2, 1), (4, 0), (4, 3)])
def test_ship_buckets_senders_layout_is_the_receivers_transposed(
        cuda_device, world, rank):
    """A gang rank's K9 launch at the cell's widths (its 8 / world senders
    of 2^23 words, C = 2^22, rounds 0 and 1) writes bucket d of each of its
    senders at row ``s * P + d``: the one-process receivers' layout,
    transposed, the rank's rows."""
    from repro_torch.core.backends.mapreduce import static_capacity
    from repro_torch.kernels.ship_buckets import ops as sb

    words, starts = _malgen_words(cuda_device, "skewed")
    capacity = static_capacity(1 << 23, 8, 4.0)
    local = 8 // world
    mine = slice(rank * local, (rank + 1) * local)
    for r in (0, 1):
        before = sb.ship_buckets.launches
        got = sb._launch(words[mine], starts[mine], r, capacity, 8, True)
        assert sb.ship_buckets.launches == before + 1
        want = sb.ship_buckets(words, starts, r, capacity).view(
            8, 8, capacity).transpose(0, 1)[mine]
        assert torch.equal(got.view(local, 8, capacity), want), r
        del got, want


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,capacity,skew", [
    (8, 1 << 20, 1 << 16, 0),       # capacity factor 0.5: every round
    (4, 100_003, 12_501, 0),        # rows and buckets of no 4-int vectors
    (3, 4096, 1024, 1),             # words one int past a 16-byte boundary
    (1, 9, 2, 0),                   # one node, a tiny bucket
])
def test_ship_buckets_every_round_equals_plain(cuda_device, p, n, capacity,
                                               skew):
    """Every round until no word is left, then one more (all zeros):
    K9 equals its plain version bit for bit, in 16-byte vectors and by
    element, from words off a 16-byte boundary too."""
    from repro_torch.kernels.ship_buckets import ops as sb

    g = torch.Generator(device=cuda_device).manual_seed(p * n + capacity)
    dest = torch.randint(0, p + 1, (p, n), generator=g, dtype=torch.int32,
                         device=cuda_device)
    dest[:, : n // 3] = 0                       # one hot destination
    buf = torch.randint(-2**31, 2**31 - 1, (p * n + skew,), generator=g,
                        dtype=torch.int32, device=cuda_device)
    words, starts = count_scatter_ref(buf[skew:].view(p, n), dest, p)
    words = (torch.empty(p * n + skew, dtype=torch.int32,
                         device=cuda_device)[skew:].view(p, n)
             .copy_(words))
    assert sb.vector_ints(words.data_ptr(), 0, n, capacity) == (
        4 if skew == 0 and n % 4 == 0 and capacity % 4 == 0 else 1)
    rounds = -(-int((starts[:, 1:] - starts[:, :-1]).max()) // capacity)
    assert rounds > 1
    for r in range(rounds + 1):
        got = sb.ship_buckets(words, starts, r, capacity)
        assert torch.equal(got, sb.ship_buckets_plain(words, starts, r,
                                                      capacity)), r
    assert int(got.count_nonzero()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["counting", "sort"])
def test_exchange_and_reduce_equal_on_both_paths(cuda_device, impl,
                                                 monkeypatch):
    """``mapreduce_histogram`` at capacity factor 0.5 (several rounds) on
    the card: K9 once a round, counted in ``shuffle.rounds_in_kernel``;
    the histogram and all six ShuffleStats fields equal the torch path's
    (``ship_buckets`` replaced by its plain version) and the CPU's."""
    from repro_torch.common import trace
    from repro_torch.common.types import EventLog
    from repro_torch.core.backends import mapreduce
    from repro_torch.kernels.ship_buckets import ops as sb

    cfg = MalGenConfig(num_sites=4096, num_entities=50_000)
    p, rps = 8, 1 << 18
    seed = make_seed(5, cfg, p * rps, device=cuda_device)
    log = generate_shards_device(seed, cfg, p, rps, device=cuda_device)
    kw = dict(num_sites=4096, num_weeks=52, capacity_factor=0.5, impl=impl,
              word_histogram_fn=lambda w, s, weeks, parts, first:
              segment_hist_packed_words(w, num_sites_local=s,
                                        num_partitions=parts,
                                        num_weeks=weeks, first_node=first))
    before = sb.ship_buckets.launches
    trace.start()
    try:
        hist, stats = mapreduce.mapreduce_histogram(log, **kw)
    finally:
        _, counters = trace.stop()
    assert stats.rounds > 1
    assert sb.ship_buckets.launches - before == stats.rounds
    assert counters["shuffle.rounds_in_kernel"] == stats.rounds
    monkeypatch.setattr(mapreduce, "ship_buckets", sb.ship_buckets_plain)
    torch_hist, torch_stats = mapreduce.mapreduce_histogram(log, **kw)
    monkeypatch.undo()
    cpu_hist, cpu_stats = mapreduce.mapreduce_histogram(
        EventLog(*(c.cpu() if c is not None else None for c in log)), **kw)
    for h, st in ((torch_hist, torch_stats), (cpu_hist, cpu_stats)):
        assert torch.equal(hist.cpu(), h.cpu())
        for name in ("sent", "overflow", "residual", "bytes_exchanged"):
            assert torch.equal(getattr(stats, name).cpu(),
                               getattr(st, name).cpu()), name
        assert (stats.capacity, stats.rounds) == (st.capacity, st.rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("runner_kind", ["overlap", "resumable"])
def test_mapreduce_runners_unchanged_by_k9(cuda_device, runner_kind,
                                           monkeypatch):
    """The overlap runner (K9 on the fold's stream, overlap on and off)
    and the resumable runner on mapreduce give the same histogram, rho
    bits and ShuffleStats through K9 as through the torch path; K9
    launches once a round."""
    from repro_torch.core.backends import mapreduce
    from repro_torch.kernels.ship_buckets import ops as sb

    def results():
        if runner_kind == "overlap":
            _, _, _, runner = _overlap_case(cuda_device, "mapreduce", 6,
                                            1 << 16)
            return [runner.run_result("B", overlap=ov) for ov in
                    (True, False)]
        _, _, _, runner = _resume_case(cuda_device, "mapreduce")
        out = runner.run()
        return [(out.result, out.shuffle_stats)]

    before = sb.ship_buckets.launches
    reset_launch_counts()
    got = results()
    torch.cuda.synchronize(cuda_device)
    launched = sb.ship_buckets.launches - before
    # one K9 launch a round, as K3's
    assert launched == launch_counts()["segment_hist.packed"]
    # capacity factor 0.5: two rounds or more a step, four steps or more
    assert launched >= 2 * 4 * len(got)
    monkeypatch.setattr(mapreduce, "ship_buckets", sb.ship_buckets_plain)
    want = results()
    for (g, gs), (w, ws) in zip(got, want):
        assert torch.equal(g.total, w.total)
        assert torch.equal(g.marked, w.marked)
        assert torch.equal(g.rho.view(torch.int32), w.rho.view(torch.int32))
        assert _stats(gs) == _stats(ws)
