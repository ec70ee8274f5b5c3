"""The (total, marked) site-week histogram kernels, batched over the nodes.

Counterpart of ``repro/kernels/segment_hist/ops.py``:

- ``segment_hist`` / ``segment_hist_eventlog`` (JAX ``ops.py:30`` and
  ``:59``) reduce int32 ``(site, week, mark, valid)`` columns of shape
  ``[P, n]`` into int32 ``[P, S, W, 2]``, one histogram per node. On a CUDA
  tensor the wrapper runs K4 (``csrc/segment_hist.cu``) for all P nodes;
  on a CPU tensor it runs ``segment_hist_plain``.
- ``segment_hist_packed_words`` is the MapReduce reducer's fused unpack +
  histogram over shuffled words: row ``r`` of int32 ``[rows, L]`` holds the
  L words node ``first_node + r`` received (``first_node`` 0 and P rows in
  one process; a process of a gang holds its own nodes' rows, as the JAX
  kernel is told its node as ``my_index``). On a CUDA tensor it runs K3
  (``csrc/segment_hist_packed.cu``); on a CPU tensor it runs
  ``segment_hist_packed_words_plain`` (unpack, then ``index_add_``).

Both kernels take MalGen's hot sites off the global atomics. A first
launch counts the sites of ``sample`` evenly spaced records of each row
and lists, per row, the sites seen at least ``threshold`` times (at most
``HOT_SITES``, most frequent first): ``hot_sites_plain`` is its plain
version, ``segment_hist_hot_sites`` and ``segment_hist_packed_hot_sites``
run it alone. The histogram launch then runs two blocks an SM that take
chunks of the rows in node-major order; a block counts the records of a
listed site in a private tile in shared memory, adds the tile to the
histogram when it moves on to another row, and counts every other record
with a global atomic. The list only decides where a record is added up,
never whether, so the result is exact for any list:
``segment_hist_tiled`` and ``segment_hist_packed_words_tiled`` take a
given one. ``hist_geometry`` sets the blocks, the tile's size, the sample
and the threshold.

Both count ``mark > 0``, as ``segment_hist_ref`` does; the JAX Pallas
``_kernel`` adds the raw mark value, which agrees only for marks in {0, 1}
(ROADMAP.md Queue 3). Histogram launches are counted in
``segment_hist.launches`` and ``segment_hist_packed_words.launches``.
``launch_plan`` and ``packed_launch_plan`` mirror the C entry points'
launches for the static analysis (``repro_torch.kernels._launch``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.common.types import (
    EventLog,
    WEEKS_PER_YEAR,
    unpack_site_week_mark,
)
from repro_torch.kernels._build import bind, kernel_attributes, library
from repro_torch.kernels._launch import H100_SMS, Launch, cdiv, dim3
from repro_torch.kernels.segment_hist.ref import segment_hist_ref

_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1

# The kernels' constants (csrc/segment_hist.cu, csrc/segment_hist_packed.cu)
HOT_SITES = 64               # sites a row's hot list holds
HOT_LIST = HOT_SITES + 1     # a row of the list: {h, site_0, ..., site_63}
CANDIDATES = 256             # sites the threshold may let pass
SAMPLE = 8192                # records sampled a row, at most
THREADS = 512                # threads of a histogram block
UNROLL = 4                   # records a thread loads at a time
TABLE_SLOTS = 1024           # the block's site -> tile slot table
STATIC_SMEM = 48 * 1024      # shared memory a block gets without opt-in
BLOCKS_PER_SM = 2
MIN_PER_CELL = 2             # records a tiled cell should get a block-row
SELECT_THREADS = 1024        # threads of the hot-site block
SELECT_SMEM = 16384 * 8      # its sample table: 16,384 int2 slots
CHUNK = 2 * UNROLL * THREADS  # records a histogram block takes at a time

# static shared memory of each kernel, the same in both sources (the hot-
# site block's candidate lists and count, the histogram block's next
# chunk, as ptxas lays them out); chip_smoke.py holds this table against
# the card's
STATIC_SMEM_BYTES = {"hot_sites_kernel": 2064, "segment_hist_kernel": 16,
                     "packed_hist_kernel": 16}
# each source's kernels, in the order of its kernel_attributes entry point
KERNELS = {"segment_hist": ("hot_sites_kernel", "segment_hist_kernel"),
           "segment_hist_packed": ("hot_sites_kernel", "packed_hist_kernel")}
# the index type each kernel forms its offsets into an array in
# (csrc/segment_hist.cu:88-239, csrc/segment_hist_packed.cu:87-239); the
# chunk counter is an unsigned int
INDEX_TYPES = {
    "hot_sites_kernel": {"records": "int64", "hot": "int64"},
    "segment_hist_kernel": {"records": "int64", "hist": "int64",
                            "tile": "int32", "chunk counter": "uint32"},
    "packed_hist_kernel": {"records": "int64", "hist": "int64",
                           "tile": "int32", "chunk counter": "uint32"},
}


class HistGeometry(NamedTuple):
    blocks: int          # persistent histogram blocks
    hot_capacity: int    # tile slots a block holds (sites of the hot list)
    sample: int          # records sampled a row for the hot list
    threshold: int       # sample count that makes a site hot
    smem_bytes: int      # dynamic shared memory of a histogram block


def hist_geometry(n: int, num_weeks: int, sm_count: int) -> HistGeometry:
    """Launch geometry for rows of ``n`` records into ``num_weeks`` weeks
    on a card of ``sm_count`` SMs.

    ``BLOCKS_PER_SM`` blocks an SM (fewer for short rows). The tile gets as
    many hot sites as fit, with the table, in 48 KB. A site is hot when
    its sample count is at least ``ceil(sample / CANDIDATES)``, so at most
    ``CANDIDATES`` sites pass, and at least what puts ``MIN_PER_CELL``
    records into each of its cells per block and row on average (below
    that, the tile's flush costs more global atomics than it saves).
    """
    if n < 0 or num_weeks < 1 or sm_count < 1:
        raise ValueError(f"hist_geometry: n={n}, num_weeks={num_weeks}, "
                         f"sm_count={sm_count}")
    blocks = max(1, min(BLOCKS_PER_SM * sm_count,
                        -(-n // (THREADS * UNROLL))))
    hot_capacity = min(HOT_SITES,
                       (STATIC_SMEM - 8 * TABLE_SLOTS) // (8 * num_weeks))
    sample = min(n, SAMPLE)
    if sample == 0 or hot_capacity == 0:
        threshold = sample + 1           # no site can pass
    else:
        threshold = max(-(-sample // CANDIDATES),
                        -(-MIN_PER_CELL * num_weeks * blocks * sample // n))
    return HistGeometry(blocks, hot_capacity, sample, threshold,
                        8 * TABLE_SLOTS + 8 * hot_capacity * num_weeks)


def _hist_launches(kernel: str, rows: int, n: int, num_sites: int,
                   num_weeks: int, sm_count: int) -> list:
    """The hot-site launch and the histogram launch of one entry point
    (``launch_hot_sites`` and ``launch_tiled`` in either source): none
    for an empty input, as the entry points return first."""
    if rows * n == 0:
        return []
    geo = hist_geometry(n, num_weeks, sm_count)
    records = rows * n - 1
    return [
        Launch("hot_sites_kernel", dim3(rows), dim3(SELECT_THREADS),
               SELECT_SMEM, opt_in=SELECT_SMEM,
               offsets={"records": records, "hot": rows * HOT_LIST - 1}),
        Launch(kernel, dim3(geo.blocks), dim3(THREADS), geo.smem_bytes,
               offsets={"records": records,
                        "hist": rows * num_sites * num_weeks * 2 - 1,
                        "tile": geo.hot_capacity * num_weeks * 2 - 1,
                        "chunk counter": cdiv(n, CHUNK) * rows
                        + geo.blocks})]


def launch_plan(rows: int, n: int, *, num_sites: int,
                num_weeks: int = WEEKS_PER_YEAR, sm_count: int) -> list:
    """The launches of ``segment_hist`` (K4) on ``[rows, n]`` columns on a
    card of ``sm_count`` SMs (csrc/segment_hist.cu:303-342)."""
    if num_sites < 1 or num_weeks < 1:
        raise ValueError(f"segment_hist: num_sites={num_sites}, "
                         f"num_weeks={num_weeks}")
    return _hist_launches("segment_hist_kernel", rows, n, num_sites,
                          num_weeks, sm_count)


def packed_launch_plan(rows: int, length: int, *, num_sites_local: int,
                       num_partitions: int,
                       num_weeks: int = WEEKS_PER_YEAR,
                       sm_count: int) -> list:
    """The launches of ``segment_hist_packed_words`` (K3) on ``[rows,
    length]`` words (csrc/segment_hist_packed.cu:300-334)."""
    if rows > num_partitions or num_sites_local < 1 \
            or not 1 <= num_weeks <= 64:
        raise ValueError(f"segment_hist_packed_words: {rows} rows of "
                         f"{num_partitions} nodes, num_sites_local="
                         f"{num_sites_local}, num_weeks={num_weeks}")
    return _hist_launches("packed_hist_kernel", rows, length,
                          num_sites_local, num_weeks, sm_count)


def analysis_cases() -> list:
    """The shapes the kernel passes check the plans at: JAX's two cases
    (K4 over one node's 2^16 records into the B preset's 100,000 sites, K3
    over the words of P = 4 nodes), the main path's (K3 over a counting
    round's ``[8, 2^24]`` words, K4 over the other backends' ``[8,
    2^23]``), and the longest rows (2^31 - 1 records)."""
    def k4(name, rows, n, sites):
        def run(device):
            col = torch.zeros(rows, n, dtype=torch.int32, device=device)
            valid = torch.zeros_like(col, dtype=torch.bool)
            segment_hist(col, col, col, valid, num_sites=sites)

        return {"name": f"segment_hist/{name}", "source": "segment_hist",
                "shape": (rows, n, sites),
                "plan": lambda sms: launch_plan(rows, n, num_sites=sites,
                                               sm_count=sms),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    def k3(name, rows, length, s_local, parts):
        def run(device):
            segment_hist_packed_words(
                torch.zeros(rows, length, dtype=torch.int32, device=device),
                num_sites_local=s_local, num_partitions=parts)

        return {"name": f"segment_hist/{name}",
                "source": "segment_hist_packed",
                "shape": (rows, length, s_local, parts),
                "plan": lambda sms: packed_launch_plan(
                    rows, length, num_sites_local=s_local,
                    num_partitions=parts, sm_count=sms),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    return [k4("b_preset", 1, 1 << 16, 100_000),
            k3("packed_words", 4, 1 << 16, 25_000, 4),
            k3("main_path", 8, 1 << 24, 12_500, 8),
            k4("other_backends", 8, 1 << 23, 100_000),
            k4("longest_row", 1, 2**31 - 1, 100_000),
            k3("packed_longest_row", 1, 2**31 - 1, 100_000, 1)]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_geometry(t: torch.Tensor, n: int,
                    num_weeks: int) -> HistGeometry:
    """The geometry the wrappers use for rows of ``n`` records on ``t``'s
    device: its SM count on a card, an H100's for a CPU tensor."""
    if t.device.type != "cuda":
        return hist_geometry(n, num_weeks, H100_SMS)
    index = t.device.index
    return hist_geometry(n, num_weeks, sm_count(
        torch.cuda.current_device() if index is None else index))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# argument kinds of each C entry point, as declared in its source
PACKED_SIGNATURES = {"packed_hist": "ppppqiiiiiiiiip",
                     "packed_hist_hot_sites": "ppqiiiiiiip",
                     "packed_hist_tiled": "ppppqiiiiiiip",
                     "kernel_attributes": "ip"}
HIST_SIGNATURES = {"segment_hist": "pppppppqiiiiiiiip",
                   "segment_hist_hot_sites": "ppppqiiiiiip",
                   "segment_hist_tiled": "pppppppqiiiiiip",
                   "kernel_attributes": "ip"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(library("segment_hist_packed"), PACKED_SIGNATURES)


@functools.cache
def _hist_lib() -> ctypes.CDLL:
    return bind(library("segment_hist"), HIST_SIGNATURES)


def attributes(source: str) -> dict:
    """What the card reports for each kernel of ``source``
    (``_build.kernel_attributes``)."""
    lib = _hist_lib() if source == "segment_hist" else _lib()
    return kernel_attributes(lib, KERNELS[source])


def _work(t: torch.Tensor) -> torch.Tensor:
    """The histogram launch's chunk counter (one int; the launch zeroes
    it)."""
    return torch.empty(1, dtype=torch.int32, device=t.device)


def hot_sites_plain(keys: torch.Tensor, sample: int,
                    threshold: int) -> torch.Tensor:
    """Plain version of the hot-site launch: int32 ``[P, HOT_LIST]``.

    ``keys`` is ``[P, n]``: each record's (local) site, or -1 where it
    counts nowhere. Row r samples positions ``k * n // sample`` for k <
    ``sample`` and lists the sites seen at least ``threshold`` times, most
    frequent first, ties by site, at most ``HOT_SITES``: ``{h, site_0,
    ..., site_{h-1}, -1, ...}``. ``threshold`` must be at least
    ``ceil(sample / CANDIDATES)``, as ``hist_geometry`` sets it.
    """
    p, n = keys.shape
    out = torch.full((p, HOT_LIST), -1, dtype=torch.int32)
    out[:, 0] = 0
    if sample == 0:
        return out
    if threshold * CANDIDATES < sample:
        raise ValueError(f"hot_sites_plain: threshold {threshold} lets more "
                         f"than {CANDIDATES} of {sample} samples' sites pass")
    pos = torch.arange(sample, dtype=torch.int64) * n // sample
    for r, row in enumerate(keys.cpu()[:, pos]):
        sites, counts = torch.unique(row[row >= 0], return_counts=True)
        keep = counts >= threshold
        sites, counts = sites[keep], counts[keep]
        hot = sites[torch.argsort(-counts, stable=True)][:HOT_SITES]
        out[r, 0] = len(hot)
        out[r, 1:1 + len(hot)] = hot.to(torch.int32)
    return out.to(keys.device)


def record_sites(site: torch.Tensor, week: torch.Tensor, valid: torch.Tensor,
                 *, num_sites: int, num_weeks: int,
                 site_offset: int = 0) -> torch.Tensor:
    """K4's key of each record: its rebased site (int32 wrap), or -1 where
    the record counts nowhere."""
    s = ((site.to(torch.int64) - site_offset + 2**31) % 2**32) - 2**31
    ok = valid & (s >= 0) & (s < num_sites) & (week >= 0) & (week < num_weeks)
    return torch.where(ok, s, -1)


def _row_nodes(words: torch.Tensor, first_node: int) -> torch.Tensor:
    """``[rows, 1]``: the node of each row of the words."""
    return torch.arange(first_node, first_node + words.shape[0],
                        device=words.device).unsqueeze(1)


def word_sites(words: torch.Tensor, *, num_sites_local: int,
               num_partitions: int, num_weeks: int = WEEKS_PER_YEAR,
               first_node: int = 0) -> torch.Tensor:
    """K3's key of each word: its local site ``site // P`` where the node
    of row r (``first_node + r``) owns it and its week is in range, else
    -1."""
    site, week, _, valid = unpack_site_week_mark(words)
    node = _row_nodes(words, first_node)
    local = site // num_partitions
    ok = (valid & (site % num_partitions == node) & (local < num_sites_local)
          & (week < num_weeks))
    return torch.where(ok, local, -1)


def segment_hist_plain(site: torch.Tensor, week: torch.Tensor,
                       mark: torch.Tensor, valid: torch.Tensor, *,
                       num_sites: int, num_weeks: int = WEEKS_PER_YEAR,
                       site_offset: int = 0) -> torch.Tensor:
    """Plain version of K4: ``segment_hist_ref`` of the rebased sites."""
    return segment_hist_ref(site - site_offset, week, mark, valid,
                            num_sites, num_weeks)


def _check_columns(site, week, mark, valid, num_sites, num_weeks,
                   site_offset) -> None:
    """Raise unless the columns are K4's input (``mark`` None: not
    checked)."""
    for name, t, dtype in (("site", site, torch.int32),
                           ("week", week, torch.int32),
                           ("mark", mark, torch.int32),
                           ("valid", valid, torch.bool)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape != site.shape:
            raise ValueError(f"segment_hist: {name} must be [P, n] like "
                             f"site {tuple(site.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"segment_hist: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if t.device != site.device:
            raise ValueError(f"segment_hist: {name} on {t.device}, site on "
                             f"{site.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_hist: {name} must be contiguous")
    if num_sites < 1 or num_weeks < 1:
        raise ValueError(f"segment_hist: num_sites={num_sites}, "
                         f"num_weeks={num_weeks}")
    if not _INT32_MIN <= site_offset <= _INT32_MAX:
        raise ValueError(f"segment_hist: site_offset {site_offset} is not "
                         f"an int32")


def _check_hot(hot: torch.Tensor, rows: int, device) -> None:
    if (hot.dtype != torch.int32 or tuple(hot.shape) != (rows, HOT_LIST)
            or hot.device != device or not hot.is_contiguous()):
        raise ValueError(f"hot list must be contiguous int32 [{rows}, "
                         f"{HOT_LIST}] on {device}, got {hot.dtype} "
                         f"{tuple(hot.shape)} on {hot.device}")


def segment_hist(site: torch.Tensor, week: torch.Tensor, mark: torch.Tensor,
                 valid: torch.Tensor, *, num_sites: int,
                 num_weeks: int = WEEKS_PER_YEAR,
                 site_offset: int = 0) -> torch.Tensor:
    """int32 ``[P, num_sites, num_weeks, 2]`` (total, marked) histograms of
    ``[P, n]`` columns, one per row. ``site``, ``week`` and ``mark`` are
    int32, ``valid`` bool. A row counts where it is valid and ``site -
    site_offset`` and ``week`` are in range; ``marked`` counts ``mark >
    0``."""
    _check_columns(site, week, mark, valid, num_sites, num_weeks,
                   site_offset)
    if site.device.type != "cuda":
        return segment_hist_plain(site, week, mark, valid,
                                  num_sites=num_sites, num_weeks=num_weeks,
                                  site_offset=site_offset)
    p, n = site.shape
    geo = launch_geometry(site, n, num_weeks)
    hist = torch.zeros(p, num_sites, num_weeks, 2, dtype=torch.int32,
                       device=site.device)
    hot = torch.empty(p, HOT_LIST, dtype=torch.int32, device=site.device)
    work = _work(site)
    segment_hist.launches += 1
    _check(_hist_lib().segment_hist(
        site.data_ptr(), week.data_ptr(), mark.data_ptr(), valid.data_ptr(),
        hist.data_ptr(), hot.data_ptr(), work.data_ptr(), n, p, num_sites,
        num_weeks, site_offset, geo.blocks, geo.hot_capacity, geo.sample,
        geo.threshold, _stream(site)), "segment_hist")
    return hist


segment_hist.launches = 0


def segment_hist_hot_sites(site: torch.Tensor, week: torch.Tensor,
                           valid: torch.Tensor, *, num_sites: int,
                           num_weeks: int = WEEKS_PER_YEAR,
                           site_offset: int = 0) -> torch.Tensor:
    """The hot list ``segment_hist`` derives from the columns, int32 ``[P,
    HOT_LIST]``: K4's first launch alone on a CUDA tensor,
    ``hot_sites_plain`` on a CPU tensor (with an H100's geometry)."""
    _check_columns(site, week, None, valid, num_sites, num_weeks,
                   site_offset)
    p, n = site.shape
    geo = launch_geometry(site, n, num_weeks)
    if site.device.type != "cuda":
        keys = record_sites(site, week, valid, num_sites=num_sites,
                            num_weeks=num_weeks, site_offset=site_offset)
        return hot_sites_plain(keys, geo.sample, geo.threshold)
    hot = torch.empty(p, HOT_LIST, dtype=torch.int32, device=site.device)
    _check(_hist_lib().segment_hist_hot_sites(
        site.data_ptr(), week.data_ptr(), valid.data_ptr(), hot.data_ptr(), n,
        p, num_sites, num_weeks, site_offset, geo.sample, geo.threshold,
        _stream(site)), "segment_hist_hot_sites")
    return hot


def segment_hist_tiled(site: torch.Tensor, week: torch.Tensor,
                       mark: torch.Tensor, valid: torch.Tensor,
                       hot: torch.Tensor, *, num_sites: int,
                       num_weeks: int = WEEKS_PER_YEAR,
                       site_offset: int = 0) -> torch.Tensor:
    """``segment_hist`` with the hot list given (int32 ``[P, HOT_LIST]``;
    any sites, in any order): K4's histogram launch alone. The result does
    not depend on the list."""
    _check_columns(site, week, mark, valid, num_sites, num_weeks,
                   site_offset)
    _check_hot(hot, site.shape[0], site.device)
    if site.device.type != "cuda":
        return segment_hist_plain(site, week, mark, valid,
                                  num_sites=num_sites, num_weeks=num_weeks,
                                  site_offset=site_offset)
    p, n = site.shape
    geo = launch_geometry(site, n, num_weeks)
    hist = torch.zeros(p, num_sites, num_weeks, 2, dtype=torch.int32,
                       device=site.device)
    work = _work(site)
    segment_hist.launches += 1
    _check(_hist_lib().segment_hist_tiled(
        site.data_ptr(), week.data_ptr(), mark.data_ptr(), valid.data_ptr(),
        hot.data_ptr(), hist.data_ptr(), work.data_ptr(), n, p, num_sites,
        num_weeks, site_offset, geo.blocks, geo.hot_capacity, _stream(site)),
        "segment_hist_tiled")
    return hist


def segment_hist_eventlog(log: EventLog, num_sites: int,
                          num_weeks: int = WEEKS_PER_YEAR,
                          site_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``core.spm.site_week_histogram`` over a ``[P, n]`` log,
    backed by K4 on the card: int32 ``[P, num_sites, num_weeks, 2]``."""
    return segment_hist(
        log.site_id.contiguous(), log.week(num_weeks=num_weeks).contiguous(),
        log.mark.contiguous(), log.valid_mask().contiguous(),
        num_sites=num_sites, num_weeks=num_weeks, site_offset=site_offset)


def segment_hist_packed_words_plain(words: torch.Tensor, *,
                                    num_sites_local: int,
                                    num_partitions: int,
                                    num_weeks: int = WEEKS_PER_YEAR,
                                    first_node: int = 0) -> torch.Tensor:
    """Plain version: unpack, keep the words the node of row r
    (``first_node + r``) owns (``site % P`` is that node), rebase to ``site
    // P``, histogram."""
    site, week, mark, valid = unpack_site_week_mark(words)
    ok = valid & (site % num_partitions == _row_nodes(words, first_node))
    return segment_hist_ref(site // num_partitions, week, mark, ok,
                            num_sites_local, num_weeks)


def _check_words(words, num_sites_local, num_partitions, num_weeks,
                 first_node) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"segment_hist_packed_words: expected int32 "
                         f"[rows, L] words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if first_node < 0 or first_node + words.shape[0] > num_partitions:
        raise ValueError(f"segment_hist_packed_words: {words.shape[0]} rows "
                         f"from node {first_node} for {num_partitions} "
                         f"nodes")
    if not words.is_contiguous():
        raise ValueError("segment_hist_packed_words: words must be "
                         "contiguous")
    if num_sites_local < 1 or not 1 <= num_weeks <= 64:
        raise ValueError(f"segment_hist_packed_words: num_sites_local="
                         f"{num_sites_local}, num_weeks={num_weeks}")


def segment_hist_packed_words(words: torch.Tensor, *, num_sites_local: int,
                              num_partitions: int,
                              num_weeks: int = WEEKS_PER_YEAR,
                              first_node: int = 0) -> torch.Tensor:
    """Owned int32 ``[rows, num_sites_local, num_weeks, 2]`` histograms of
    the shuffled words, one per receiving node: row r is node ``first_node
    + r`` of ``num_partitions``. Invalid slots are zero words; words that
    the row's node does not own, or whose rebased site or week is out of
    range, count nowhere."""
    _check_words(words, num_sites_local, num_partitions, num_weeks,
                 first_node)
    if words.device.type != "cuda":
        return segment_hist_packed_words_plain(
            words, num_sites_local=num_sites_local,
            num_partitions=num_partitions, num_weeks=num_weeks,
            first_node=first_node)
    p, length = words.shape
    geo = launch_geometry(words, length, num_weeks)
    hist = torch.zeros(p, num_sites_local, num_weeks, 2, dtype=torch.int32,
                       device=words.device)
    hot = torch.empty(p, HOT_LIST, dtype=torch.int32, device=words.device)
    work = _work(words)
    segment_hist_packed_words.launches += 1
    _check(_lib().packed_hist(
        words.data_ptr(), hist.data_ptr(), hot.data_ptr(), work.data_ptr(),
        length, p, num_partitions, first_node, num_sites_local, num_weeks,
        geo.blocks, geo.hot_capacity, geo.sample, geo.threshold,
        _stream(words)), "packed_hist")
    return hist


segment_hist_packed_words.launches = 0


def segment_hist_packed_hot_sites(words: torch.Tensor, *,
                                  num_sites_local: int, num_partitions: int,
                                  num_weeks: int = WEEKS_PER_YEAR,
                                  first_node: int = 0) -> torch.Tensor:
    """The hot list ``segment_hist_packed_words`` derives from the words,
    int32 ``[rows, HOT_LIST]`` of local sites: K3's first launch alone on a
    CUDA tensor, ``hot_sites_plain`` on a CPU tensor (with an H100's
    geometry)."""
    _check_words(words, num_sites_local, num_partitions, num_weeks,
                 first_node)
    p, length = words.shape
    geo = launch_geometry(words, length, num_weeks)
    if words.device.type != "cuda":
        keys = word_sites(words, num_sites_local=num_sites_local,
                          num_partitions=num_partitions, num_weeks=num_weeks,
                          first_node=first_node)
        return hot_sites_plain(keys, geo.sample, geo.threshold)
    hot = torch.empty(p, HOT_LIST, dtype=torch.int32, device=words.device)
    _check(_lib().packed_hist_hot_sites(
        words.data_ptr(), hot.data_ptr(), length, p, num_partitions,
        first_node, num_sites_local, num_weeks, geo.sample, geo.threshold,
        _stream(words)), "packed_hist_hot_sites")
    return hot


def segment_hist_packed_words_tiled(words: torch.Tensor, hot: torch.Tensor,
                                    *, num_sites_local: int,
                                    num_partitions: int,
                                    num_weeks: int = WEEKS_PER_YEAR,
                                    first_node: int = 0) -> torch.Tensor:
    """``segment_hist_packed_words`` with the hot list of local sites given
    (int32 ``[rows, HOT_LIST]``): K3's histogram launch alone. The result
    does not depend on the list."""
    _check_words(words, num_sites_local, num_partitions, num_weeks,
                 first_node)
    _check_hot(hot, words.shape[0], words.device)
    if words.device.type != "cuda":
        return segment_hist_packed_words_plain(
            words, num_sites_local=num_sites_local,
            num_partitions=num_partitions, num_weeks=num_weeks,
            first_node=first_node)
    p, length = words.shape
    geo = launch_geometry(words, length, num_weeks)
    hist = torch.zeros(p, num_sites_local, num_weeks, 2, dtype=torch.int32,
                       device=words.device)
    work = _work(words)
    segment_hist_packed_words.launches += 1
    _check(_lib().packed_hist_tiled(
        words.data_ptr(), hot.data_ptr(), hist.data_ptr(), work.data_ptr(),
        length, p, num_partitions, first_node, num_sites_local, num_weeks,
        geo.blocks, geo.hot_capacity, _stream(words)), "packed_hist_tiled")
    return hist
