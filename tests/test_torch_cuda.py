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
