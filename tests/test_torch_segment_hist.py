"""The host side of K3's and K4's hot-site design, on the CPU.

``kernels/segment_hist/ops.py`` sets the launch geometry (blocks, the
tile's size in shared memory, the sample and the hot-site threshold),
selects hot sites with ``hot_sites_plain`` (the plain version of the
kernels' first launch), keys records and words for it, and declares the C
entry points for ctypes. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); the wrappers' CPU paths are checked here,
and against JAX in ``test_torch_kernels.py`` and ``test_torch_backends.py``.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.common.types import pack_site_week_mark
from repro_torch.kernels import _build
from repro_torch.kernels.segment_hist import ops as sh

SOURCES = {"segment_hist": sh.HIST_SIGNATURES,
           "segment_hist_packed": sh.PACKED_SIGNATURES}
CONSTANTS = {"kHot": sh.HOT_SITES, "kCandidates": sh.CANDIDATES,
             "kSample": sh.SAMPLE, "kThreads": sh.THREADS,
             "kUnroll": sh.UNROLL, "kTableSlots": sh.TABLE_SLOTS,
             "kStaticSmem": sh.STATIC_SMEM}


def _c_entry_points(name: str) -> dict:
    """Argument kinds of each ``extern "C"`` function of a source: "p"
    pointer, "q" long long, "i" int."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out = {}
    for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[fn] = "".join(
            "p" if "*" in a else "q" if a.split()[0] == "long" else "i"
            for a in args.split(","))
    return out


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_ctypes_declarations_match_the_c_entry_points(name):
    """A wrong ctypes declaration passes a cut pointer or a shifted
    argument to the kernel; the C sources are the reference."""
    assert _c_entry_points(name) == SOURCES[name]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_constants_match_the_kernels(name):
    src = (_build.CSRC / f"{name}.cu").read_text()
    found = {k: eval(v, {}) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9 *]+);", src) if k in CONSTANTS}
    assert found == CONSTANTS


@pytest.mark.parametrize("n,weeks,sms", [
    (0, 52, 132), (1, 52, 132), (4095, 52, 132), (1 << 20, 52, 132),
    (1 << 22, 130, 132), (1 << 23, 52, 132), (1 << 23, 52, 114),
    (8 * 2_097_152, 64, 132), (100, 5000, 132), (1 << 23, 1, 8)])
def test_hist_geometry(n, weeks, sms):
    geo = sh.hist_geometry(n, weeks, sms)
    assert 1 <= geo.blocks <= sh.BLOCKS_PER_SM * sms
    assert geo.blocks <= max(1, -(-n // (sh.THREADS * sh.UNROLL)))
    # the tile holds as many sites as fit beside the table, at most 64
    assert 0 <= geo.hot_capacity <= sh.HOT_SITES
    assert geo.smem_bytes == 8 * sh.TABLE_SLOTS + 8 * geo.hot_capacity * weeks
    assert geo.smem_bytes <= sh.STATIC_SMEM
    assert (geo.hot_capacity == sh.HOT_SITES
            or geo.smem_bytes + 8 * weeks > sh.STATIC_SMEM)
    assert geo.sample == min(n, sh.SAMPLE)
    # at most CANDIDATES sites can reach the threshold in one sample
    assert geo.threshold * sh.CANDIDATES >= geo.sample
    if geo.hot_capacity and geo.sample:
        # a site at the threshold gives each of its cells MIN_PER_CELL
        # records per block and row, on average
        per_cell = geo.threshold / geo.sample * n / geo.blocks / weeks
        assert per_cell >= sh.MIN_PER_CELL
    else:
        assert geo.threshold > geo.sample


def test_hist_geometry_at_the_main_paths_shapes():
    """K4 over 2^23 records a row, K3 over round 0's 8 x 2,097,152 words
    a row and K4 over a service step's 2^20: 264 blocks of 34,816 bytes
    on an H100, a 64-site tile, the threshold 32, 32 and 215 samples."""
    for n, threshold in ((1 << 23, 32), (8 * 2_097_152, 32), (1 << 20, 215)):
        assert sh.hist_geometry(n, 52, 132) == sh.HistGeometry(
            264, 64, 8192, threshold, 34_816)


@pytest.mark.parametrize("args", [(-1, 52, 132), (10, 0, 132), (10, 52, 0)])
def test_hist_geometry_rejects_bad_shapes(args):
    with pytest.raises(ValueError):
        sh.hist_geometry(*args)


def test_launch_geometry_of_a_cpu_tensor_is_an_h100s():
    t = torch.zeros(2, 5, dtype=torch.int32)
    assert sh.launch_geometry(t, 1 << 20, 52) == sh.hist_geometry(
        1 << 20, 52, sh.H100_SMS)


def _numpy_hot_sites(keys: np.ndarray, sample: int, threshold: int):
    out = np.full((keys.shape[0], sh.HOT_LIST), -1, np.int64)
    out[:, 0] = 0
    if sample == 0:
        return out
    pos = np.arange(sample, dtype=np.int64) * keys.shape[1] // sample
    for r, row in enumerate(keys[:, pos]):
        sites, counts = np.unique(row[row >= 0], return_counts=True)
        ranked = sorted((-c, s) for s, c in zip(sites, counts)
                        if c >= threshold)[:sh.HOT_SITES]
        out[r, 0] = len(ranked)
        out[r, 1:1 + len(ranked)] = [s for _, s in ranked]
    return out


@pytest.mark.parametrize("seed,p,n,num_sites", [
    (0, 1, 50_000, 1000), (1, 3, 8192, 100), (2, 4, 3000, 40),
    (3, 2, 100_000, 100_000), (4, 8, 20_000, 12_500)])
def test_hot_sites_plain_matches_numpy(seed, p, n, num_sites):
    """Power-law keys with records that count nowhere (-1): the sites
    seen at least ``threshold`` times in the sample, most frequent first,
    ties by site, at most 64."""
    rng = np.random.default_rng(seed)
    weights = np.arange(1, num_sites + 1, dtype=np.float64) ** -1.2
    keys = rng.choice(num_sites, size=(p, n), p=weights / weights.sum())
    keys[rng.random((p, n)) < 0.1] = -1
    geo = sh.hist_geometry(n, 52, 132)
    for sample, threshold in ((geo.sample, geo.threshold),
                              (min(n, 8192), -(-min(n, 8192) // 256))):
        got = sh.hot_sites_plain(torch.from_numpy(keys), sample, threshold)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), _numpy_hot_sites(keys, sample, threshold))


def test_hot_sites_plain_orders_by_count_then_site():
    row = [5, 9, 2, 9, 5, 9, 2, 7, 9, 5, 2, -1, -1]
    got = sh.hot_sites_plain(torch.tensor([row]), len(row), 2)
    assert got[0, :5].tolist() == [3, 9, 2, 5, -1]
    assert (got[0, 4:] == -1).all()


def test_hot_sites_plain_keeps_the_64_most_frequent():
    """100 sites at the threshold or above, site s seen s + 32 times: the
    list keeps the 64 most frequent."""
    row = np.repeat(np.arange(100), np.arange(100) + 32)
    got = sh.hot_sites_plain(torch.from_numpy(row[None]), row.size, 32)
    assert got[0, 0] == sh.HOT_SITES
    assert got[0, 1:].tolist() == list(range(99, 35, -1))


def test_hot_sites_plain_empty_rows_and_no_sample():
    keys = torch.full((3, 1000), -1)
    keys[1] = 4
    got = sh.hot_sites_plain(keys, 1000, 4)
    assert got[:, 0].tolist() == [0, 1, 0]
    assert got[1, 1] == 4
    none = sh.hot_sites_plain(torch.zeros(2, 0, dtype=torch.int64), 0, 1)
    assert none[:, 0].tolist() == [0, 0] and (none[:, 1:] == -1).all()


def test_hot_sites_plain_refuses_a_threshold_that_lets_too_many_pass():
    with pytest.raises(ValueError, match="more than 256"):
        sh.hot_sites_plain(torch.zeros(1, 8192, dtype=torch.int64), 8192, 31)


def _columns(seed, p, n, num_sites, num_weeks, offset):
    rng = np.random.default_rng(seed)
    site = rng.integers(-3, num_sites + 3, size=(p, n)) + offset
    site = ((site + 2**31) % 2**32 - 2**31).astype(np.int32)
    return (torch.from_numpy(site),
            torch.from_numpy(rng.integers(-2, num_weeks + 2, size=(p, n),
                                          dtype=np.int32)),
            torch.from_numpy(rng.integers(-1, 3, size=(p, n),
                                          dtype=np.int32)),
            torch.from_numpy(rng.random((p, n)) < 0.8))


@pytest.mark.parametrize("offset", [0, 17, -3, 2**31 - 5, -2**31 + 2])
def test_record_sites_are_the_records_the_histogram_counts(offset):
    """K4's key is the rebased site (int32 wrap) of exactly the records
    the plain histogram counts."""
    num_sites, num_weeks = 50, 52
    site, week, mark, valid = _columns(offset & 0xFF, 3, 5000, num_sites,
                                       num_weeks, offset)
    keys = sh.record_sites(site, week, valid, num_sites=num_sites,
                           num_weeks=num_weeks, site_offset=offset)
    hist = sh.segment_hist_plain(site, week, mark, valid,
                                 num_sites=num_sites, num_weeks=num_weeks,
                                 site_offset=offset)
    for r in range(3):
        k = keys[r][keys[r] >= 0]
        assert torch.equal(torch.bincount(k, minlength=num_sites),
                           hist[r, :, :, 0].sum(1).to(torch.int64))


def test_word_sites_are_the_words_the_histogram_counts():
    """K3's key: the local site of owned, valid, in-block, in-range
    words, bit-31 sites included."""
    rng = np.random.default_rng(5)
    p, n, s_local, num_weeks = 4, 6000, 1 << 22, 52
    site = rng.integers(0, 1 << 24, size=(p, n))
    site[:, ::3] = rng.integers(0, 400, size=(p, n))[:, ::3]
    week = rng.integers(0, 64, size=(p, n))
    cols = [torch.from_numpy(x.astype(np.int32)) for x in
            (site, week, rng.integers(0, 2, size=(p, n)))]
    words = pack_site_week_mark(*cols, torch.from_numpy(
        rng.random((p, n)) < 0.9))
    kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=num_weeks)
    keys = sh.word_sites(words, **kw)
    hist = sh.segment_hist_packed_words_plain(words, **kw)
    assert int((site >= 1 << 23).sum()) > 0
    for r in range(p):
        k = keys[r][keys[r] >= 0]
        assert torch.equal(torch.bincount(k, minlength=s_local),
                           hist[r, :, :, 0].sum(1).to(torch.int64))


def test_hot_site_wrappers_on_the_cpu_are_the_plain_selection():
    site, week, mark, valid = _columns(9, 2, 30_000, 300, 52, 0)
    site[:, ::4] = 7
    kw = dict(num_sites=300, num_weeks=52)
    geo = sh.launch_geometry(site, 30_000, 52)
    got = sh.segment_hist_hot_sites(site, week, valid, **kw)
    assert torch.equal(got, sh.hot_sites_plain(
        sh.record_sites(site, week, valid, **kw), geo.sample, geo.threshold))
    assert got[:, 1].tolist() == [7, 7]
    words = pack_site_week_mark(site.abs() % 600, week.abs() % 52, mark,
                                valid)
    kw3 = dict(num_sites_local=300, num_partitions=2, num_weeks=52)
    assert torch.equal(
        sh.segment_hist_packed_hot_sites(words, **kw3),
        sh.hot_sites_plain(sh.word_sites(words, **kw3), geo.sample,
                           geo.threshold))


def test_tiled_wrappers_on_the_cpu_are_the_plain_histograms():
    """On the CPU a given hot list changes nothing: the plain version
    runs. The list's shape and type are still checked."""
    site, week, mark, valid = _columns(3, 2, 4000, 40, 52, 0)
    kw = dict(num_sites=40, num_weeks=52)
    hot = torch.full((2, sh.HOT_LIST), -1, dtype=torch.int32)
    assert torch.equal(sh.segment_hist_tiled(site, week, mark, valid, hot,
                                             **kw),
                       sh.segment_hist_plain(site, week, mark, valid, **kw))
    words = pack_site_week_mark(site.abs(), week.abs() % 52, mark, valid)
    kw3 = dict(num_sites_local=40, num_partitions=2, num_weeks=52)
    assert torch.equal(sh.segment_hist_packed_words_tiled(words, hot, **kw3),
                       sh.segment_hist_packed_words_plain(words, **kw3))
    for bad in (hot[:1], hot.to(torch.int64), hot[:, :10]):
        with pytest.raises(ValueError, match="hot list"):
            sh.segment_hist_tiled(site, week, mark, valid, bad, **kw)
        with pytest.raises(ValueError, match="hot list"):
            sh.segment_hist_packed_words_tiled(words, bad, **kw3)
