"""The port's kernel modules against the JAX package, exactly.

On the CPU each wrapper runs its plain PyTorch version; the expected values
come from the JAX package's Pallas fused reducer in interpret mode and
its count_scatter oracles, on the same inputs made with numpy (``test_torch_cuda.py``
holds the CUDA kernels against these plain versions on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.count_scatter import count_scatter as jax_count_scatter
from repro.kernels.count_scatter.ref import count_scatter_ref as jax_cs_ref
from repro.kernels.segment_hist.ops import (
    segment_hist_packed_words as jax_packed_words,
)
from repro_torch.kernels import count_scatter as cs
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.count_scatter import ops as cs_ops
from repro_torch.kernels.segment_hist import ops as sh_ops
from repro_torch.kernels.segment_hist import segment_hist_packed_words


def _case(seed, rows, n, p):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, p + 1, size=(rows, n), dtype=np.int32)
    # random words are almost surely distinct, so equal outputs mean equal
    # permutations, not just equal multisets
    words = rng.integers(0, 2**32, size=(rows, n), dtype=np.uint32)
    return words, dest


def _jax_count_scatter(words_row, dest_row, p):
    """Expected (words_sorted, starts) of one row: the JAX package's
    ``count_scatter`` as it runs off-TPU (``impl="auto"``, its jnp
    oracle), checked against the stable-argsort formulation as well.

    The Pallas scatter kernel cannot run in interpret mode on jax 0.9.0
    (``pl.store`` is gone; ROADMAP.md Queue 3), so the oracles stand in
    for it, as they do in the JAX package's own CPU runs.
    """
    w, d = jnp.asarray(words_row), jnp.asarray(dest_row)
    got = jax_count_scatter(w, d, p)
    order = jnp.argsort(d, stable=True)
    argsort = (w[order], jnp.searchsorted(d[order], jnp.arange(p + 1)))
    for a, b in zip(got, (jax_cs_ref(w, d, p))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(got, argsort):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return np.asarray(got[0]), np.asarray(got[1])


def _port_count_scatter(words, dest, p, fn=cs.count_scatter):
    sorted_t, starts = fn(torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(dest), p)
    return sorted_t.numpy().view(np.uint32), starts.numpy()


@pytest.mark.parametrize("n,p", [
    (1000, 3),    # n not a multiple of the tile
    (100, 4),     # n smaller than one tile
    (700, 1),
    (1024, 8),
    (600, 16),
    (3000, 4),    # three tiles: the per-tile bases between K1 and K2
])
def test_count_scatter_matches_jax(n, p):
    words, dest = _case(n + p, 1, n, p)
    want_w, want_s = _jax_count_scatter(words[0], dest[0], p)
    for fn in (cs.count_scatter, cs.count_scatter_ref):
        got_w, got_s = _port_count_scatter(words, dest, p, fn)
        np.testing.assert_array_equal(got_w[0], want_w)
        np.testing.assert_array_equal(got_s[0], want_s)


@pytest.mark.parametrize("d0", [0, 5, 8])
def test_count_scatter_all_one_destination(d0):
    """Every record on one destination; d0 = 8 is the pseudo-destination
    of invalid rows. The permutation is the identity."""
    n, p = 1500, 8
    words, _ = _case(d0, 1, n, p)
    dest = np.full((1, n), d0, np.int32)
    want_w, want_s = _jax_count_scatter(words[0], dest[0], p)
    got_w, got_s = _port_count_scatter(words, dest, p)
    np.testing.assert_array_equal(got_w[0], want_w)
    np.testing.assert_array_equal(got_w[0], words[0])
    np.testing.assert_array_equal(got_s[0], want_s)


def test_count_scatter_zero_word_invalid_rows():
    """The exchange's payload: invalid rows pack to word 0 and go to the
    pseudo-destination P."""
    n, p = 800, 4
    words, dest = _case(23, 1, n, p - 1)
    invalid = np.random.default_rng(5).random((1, n)) < 0.3
    words[invalid] = 0
    dest[invalid] = p
    want_w, want_s = _jax_count_scatter(words[0], dest[0], p)
    got_w, got_s = _port_count_scatter(words, dest, p)
    np.testing.assert_array_equal(got_w[0], want_w)
    np.testing.assert_array_equal(got_s[0], want_s)


def test_count_scatter_batched_rows_match_separate_jax_calls():
    rows, n, p = 4, 900, 4
    words, dest = _case(7, rows, n, p)
    got_w, got_s = _port_count_scatter(words, dest, p)
    for r in range(rows):
        want_w, want_s = _jax_count_scatter(words[r], dest[r], p)
        np.testing.assert_array_equal(got_w[r], want_w, err_msg=f"row {r}")
        np.testing.assert_array_equal(got_s[r], want_s, err_msg=f"row {r}")


def test_count_and_scatter_plain_kernels_compose_to_count_scatter():
    """K1's and K2's plain versions, joined by the torch glue that runs
    between the kernels on the card, give the stable-argsort oracle over
    several tiles: the tiling, prefix sums and per-tile bases are right."""
    rows, n, p = 3, 2 * cs_ops.TILE + 77, 5
    words, dest = _case(11, rows, n, p)
    w_t = torch.from_numpy(words.view(np.int32))
    d_t = torch.from_numpy(dest)
    counts_t = cs_ops.count_tiles_plain(d_t, p + 1)
    assert counts_t.shape == (rows, cs_ops.num_tiles(n), p + 1)
    base, starts = cs_ops.tile_bases(counts_t)
    got = cs_ops.scatter_tiles_plain(w_t, d_t, base)
    want_w, want_s = cs.count_scatter_ref(w_t, d_t, p)
    torch.testing.assert_close(got, want_w, rtol=0, atol=0)
    torch.testing.assert_close(starts, want_s, rtol=0, atol=0)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("num_dests", [1, 2, 9, 1025])
@pytest.mark.parametrize("n", [cs_ops.TILE - 1, cs_ops.TILE + 1,
                               2 * cs_ops.TILE + 77])
def test_count_scatter_at_the_tile_matches_jax(n, num_dests, rows):
    """Rows one record short of a tile, one past it and ragged across
    three, at one destination (only the pseudo-destination), two, the
    chip cell's nine and the kernel's most (1025), with a share of
    invalid rows sent to the pseudo-destination as the exchange sends
    them: the port and its K1/K2 plain versions equal JAX row by row."""
    p = num_dests - 1
    words, dest = _case(n * num_dests + rows, rows, n, p)
    invalid = np.random.default_rng(n + rows).random((rows, n)) < 0.25
    words[invalid] = 0
    dest[invalid] = p
    got_w, got_s = _port_count_scatter(words, dest, p)
    w_t, d_t = torch.from_numpy(words.view(np.int32)), torch.from_numpy(dest)
    counts_t = cs_ops.count_tiles_plain(d_t, num_dests)
    assert counts_t.shape == (rows, cs_ops.num_tiles(n), num_dests)
    base, starts = cs_ops.tile_bases(counts_t)
    plain_w = cs_ops.scatter_tiles_plain(w_t, d_t, base).numpy()
    for r in range(rows):
        want_w, want_s = _jax_count_scatter(words[r], dest[r], p)
        np.testing.assert_array_equal(got_w[r], want_w, err_msg=f"row {r}")
        np.testing.assert_array_equal(got_s[r], want_s, err_msg=f"row {r}")
        np.testing.assert_array_equal(plain_w[r].view(np.uint32), want_w,
                                      err_msg=f"plain K2, row {r}")
        np.testing.assert_array_equal(starts[r].numpy(), want_s)


@pytest.mark.parametrize("num_dests", [1, 2, 9, 1025])
def test_plain_k1_k2_drop_destinations_out_of_range(num_dests):
    """K1 and K2 take destinations outside ``[0, D)`` as no record: they
    count nowhere and land nowhere, and the other records keep the stable
    order of the argsort over the valid ones (the slots after them are
    left as the plain version's zeros)."""
    rows, n = 3, 2 * cs_ops.TILE + 77
    words, dest = _case(num_dests, rows, n, num_dests - 1)
    rng = np.random.default_rng(num_dests)
    out = rng.random((rows, n)) < 0.3
    dest[out] = rng.choice([-7, -1, num_dests, num_dests + 5],
                           size=int(out.sum()))
    w_t, d_t = torch.from_numpy(words.view(np.int32)), torch.from_numpy(dest)
    counts_t = cs_ops.count_tiles_plain(d_t, num_dests)
    np.testing.assert_array_equal(counts_t.sum(dim=(1, 2)).numpy(),
                                  (~out).sum(axis=1))
    base, _ = cs_ops.tile_bases(counts_t)
    got = cs_ops.scatter_tiles_plain(w_t, d_t, base).numpy()
    for r in range(rows):
        keep = ~out[r]
        want = jnp.asarray(words[r][keep])[
            jnp.argsort(jnp.asarray(dest[r][keep]), stable=True)]
        k = int(keep.sum())
        np.testing.assert_array_equal(got[r, :k].view(np.uint32),
                                      np.asarray(want))
        assert not got[r, k:].any()


def _packed_case(seed, p, length, s_local, num_weeks):
    rng = np.random.default_rng(seed)
    site = rng.integers(0, s_local * p, size=(p, length))
    week = rng.integers(0, num_weeks, size=(p, length))
    mark = rng.integers(0, 2, size=(p, length))
    words = ((site << 8) | (week << 2) | (mark << 1) | 1).astype(np.uint32)
    kind = rng.random((p, length))
    words[kind < 0.15] = 0                                  # zero words
    big = rng.integers(1 << 23, 1 << 24, size=(p, length))  # bit 31 set
    words[(kind >= 0.15) & (kind < 0.25)] = (
        (big << 8) | 1).astype(np.uint32)[(kind >= 0.15) & (kind < 0.25)]
    return words


@pytest.mark.parametrize("p,s_local", [(1, 37), (4, 40), (3, 300)])
def test_packed_hist_matches_jax(p, s_local):
    """Each node's row against the Pallas fused reducer at that node's
    index: words owned by other nodes, zero words and words with bit 31
    set (sites past the block, dropped) all count right."""
    num_weeks, length = 52, 1500
    words = _packed_case(p * 100 + s_local, p, length, s_local, num_weeks)
    got = segment_hist_packed_words(
        torch.from_numpy(words.view(np.int32)), num_sites_local=s_local,
        num_partitions=p, num_weeks=num_weeks).numpy()
    assert got.shape == (p, s_local, num_weeks, 2)
    for r in range(p):
        want = jax_packed_words(jnp.asarray(words[r]), jnp.int32(r),
                                num_sites_local=s_local, num_partitions=p,
                                num_weeks=num_weeks, interpret=True)
        np.testing.assert_array_equal(got[r], np.asarray(want),
                                      err_msg=f"node {r}")
    assert got.sum() > 0


@pytest.mark.parametrize("p,first_node,rows", [
    (4, 1, 2), (4, 3, 1), (8, 1, 4), (8, 3, 4), (8, 7, 1)])
def test_packed_hist_first_node_matches_jax(p, first_node, rows):
    """A process of a gang holds the rows of nodes first_node ..
    first_node + rows - 1: row r against the Pallas fused reducer told
    ``my_index = first_node + r``; the hot list and the tiled launch of
    those rows agree with the one-process call's rows."""
    num_weeks, length, s_local = 52, 1500, 40
    words = _packed_case(p * 10 + first_node, p, length, s_local,
                         num_weeks)
    mine = torch.from_numpy(words.view(np.int32)[first_node:first_node
                                                 + rows].copy())
    kw = dict(num_sites_local=s_local, num_partitions=p,
              num_weeks=num_weeks)
    got = segment_hist_packed_words(mine, first_node=first_node, **kw)
    assert got.shape == (rows, s_local, num_weeks, 2)
    for r in range(rows):
        want = jax_packed_words(jnp.asarray(words[first_node + r]),
                                jnp.int32(first_node + r), interpret=True,
                                **kw)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want),
                                      err_msg=f"node {first_node + r}")
    assert got.sum() > 0
    every = segment_hist_packed_words(torch.from_numpy(words.view(np.int32)),
                                      **kw)
    assert torch.equal(got, every[first_node:first_node + rows])
    hot = sh_ops.segment_hist_packed_hot_sites(mine, first_node=first_node,
                                               **kw)
    assert torch.equal(hot, sh_ops.segment_hist_packed_hot_sites(
        torch.from_numpy(words.view(np.int32)),
        **kw)[first_node:first_node + rows])
    assert torch.equal(sh_ops.segment_hist_packed_words_tiled(
        mine, hot, first_node=first_node, **kw), got)


def test_packed_hist_counts_sites_with_bit_31_set():
    """Sites >= 2^23 set bit 31 of the int32 word; with a block large
    enough to own them they must count, at the site a uint32 unpack
    gives (numpy oracle)."""
    p, s_local, num_weeks, length = 2, 1 << 23, 1, 4000
    rng = np.random.default_rng(3)
    site = rng.integers((1 << 24) - 64, 1 << 24, size=(p, length))
    mark = rng.integers(0, 2, size=(p, length))
    words = ((site << 8) | (mark << 1) | 1).astype(np.uint32)
    got = segment_hist_packed_words(
        torch.from_numpy(words.view(np.int32)), num_sites_local=s_local,
        num_partitions=p, num_weeks=num_weeks)
    want = np.zeros((p, s_local, num_weeks, 2), np.int64)
    for r in range(p):
        own = site[r] % p == r
        np.add.at(want[r, :, 0, 0], site[r][own] // p, 1)
        np.add.at(want[r, :, 0, 1], site[r][own] // p, mark[r][own])
    assert want[..., 0].sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_validate_inputs():
    words = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cs.count_scatter(words.to(torch.int64), words, 2)
    # rows are nodes first_node .. first_node + rows - 1 of num_partitions
    for first_node, parts in ((0, 1), (2, 3), (-1, 3)):
        with pytest.raises(ValueError, match="rows"):
            segment_hist_packed_words(words, num_sites_local=4,
                                      num_partitions=parts,
                                      first_node=first_node)
    with pytest.raises(ValueError, match="base"):
        cs_ops.scatter_tiles(words, words, torch.zeros(2, 1, 3))


def test_cpu_tensors_never_launch_a_kernel():
    reset_launch_counts()
    words, dest = _case(1, 2, 300, 2)
    _port_count_scatter(words, dest, 2)
    segment_hist_packed_words(torch.zeros(2, 16, dtype=torch.int32),
                              num_sites_local=4, num_partitions=2)
    assert set(launch_counts().values()) == {0}
