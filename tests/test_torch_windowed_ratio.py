"""The port's window ratios (K5's and K7's plain versions, on the CPU)
against the JAX package: its Pallas ``_masked_kernel`` and ``_kernel`` in
interpret mode and its ``masked_window_ratio_ref`` and
``windowed_ratio_ref``.

Equality is exact: sums as integers, rho by its bits. The inputs are made
from a seed with numpy and handed to both packages. The Pallas kernels sum
in f32, so they are held against the port only for counts under 2^24; the
references at any size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.windowed_ratio.ops import (
    masked_window_ratio as jax_masked_window_ratio,
)
from repro.kernels.windowed_ratio.ops import (
    windowed_ratio as jax_windowed_ratio,
)
from repro.kernels.windowed_ratio.ref import (
    masked_window_ratio_ref as jax_masked_window_ratio_ref,
)
from repro.kernels.windowed_ratio.ref import (
    windowed_ratio_ref as jax_windowed_ratio_ref,
)
from repro_torch.common.types import safe_ratio
from repro_torch.core import spm
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.windowed_ratio import (
    masked_window_ratio,
    masked_window_ratio_plain,
    masked_window_ratio_ref,
    windowed_ratio,
    windowed_ratio_plain,
    windowed_ratio_ref,
)


def _case(seed, n, w, s, *, high=1000, density=0.5):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, high, size=(s, w, 2), dtype=np.int32)
    hist[rng.random(s) < 0.2] = 0                   # empty sites
    nm = rng.random((n, w)) < density
    dm = rng.random((n, w)) < density
    return hist, nm, dm


def _port(fn, hist, nm, dm):
    return [x.numpy() for x in fn(torch.from_numpy(hist),
                                  torch.from_numpy(nm),
                                  torch.from_numpy(dm))]


def _jax(fn, hist, nm, dm, **kw):
    return [np.asarray(x) for x in fn(jnp.asarray(hist), jnp.asarray(nm),
                                      jnp.asarray(dm), **kw)]


def _assert_equal(got, want, msg=""):
    for name, a, b in zip(("rho", "num", "den"), got, want):
        assert a.shape == b.shape, f"{name} {msg}"
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{name} {msg}")


@pytest.mark.parametrize("n", (1, 9, 52, 57))
@pytest.mark.parametrize("w,s", ((1, 1), (52, 700), (64, 513), (65, 129)))
def test_masked_window_ratio_matches_jax(n, w, s):
    hist, nm, dm = _case(n * 1000 + w * 10 + s, n, w, s)
    got = _port(masked_window_ratio, hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio, hist, nm, dm,
                            interpret=True), "vs the Pallas kernel")
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, nm, dm),
                  "vs masked_window_ratio_ref")
    _assert_equal(got, _port(masked_window_ratio_ref, hist, nm, dm),
                  "vs the port's ref")


def test_zero_denominators_give_zero():
    hist, nm, _ = _case(3, 9, 52, 700)
    dm = np.zeros_like(nm)
    got = _port(masked_window_ratio, hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio, hist, nm, dm,
                            interpret=True))
    assert not got[0].any() and not got[2].any() and got[1].any()
    # all masks empty, and an all-zero histogram
    zero = np.zeros_like(hist)
    _assert_equal(_port(masked_window_ratio, zero, nm, nm),
                  _jax(jax_masked_window_ratio_ref, zero, nm, nm))


def test_counts_past_2_24_follow_the_exact_reference():
    """The Pallas body sums in f32: one count of 2^24 + 1 rounds to 2^24
    there. The port (and ``masked_window_ratio_ref``) sum in int32."""
    hist = np.zeros((3, 52, 2), np.int32)
    hist[1, 7] = (2**24 + 1, 2**24 + 1)
    hist[2, :, 0] = 2**20                  # 52 weeks: a sum of 52 * 2^20
    mask = np.ones((1, 52), bool)
    got = _port(masked_window_ratio, hist, mask, mask)
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, mask, mask))
    assert got[1][0, 1] == got[2][0, 1] == 2**24 + 1
    assert got[2][0, 2] == 52 * 2**20
    pallas = _jax(jax_masked_window_ratio, hist, mask, mask, interpret=True)
    assert pallas[1][0, 1] == 2**24, "the Pallas f32 sum no longer rounds"


def test_sums_wrap_as_int32():
    hist, nm, dm = _case(5, 9, 65, 300, high=1 << 27, density=0.9)
    got = _port(masked_window_ratio, hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, nm, dm))
    _assert_equal(got, _port(masked_window_ratio_ref, hist, nm, dm))
    assert (got[1] < 0).any(), "no sum passed 2^31"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    hist, nm, dm = _case(6, 9, 52, 100)
    reset_launch_counts()
    got = _port(masked_window_ratio, hist, nm, dm)
    assert launch_counts()["windowed_ratio.masked"] == 0
    _assert_equal(got, _port(masked_window_ratio_plain, hist, nm, dm))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    hist = torch.zeros(10, 52, 2, dtype=torch.int32)
    mask = torch.ones(3, 52, dtype=torch.bool)
    bad = [
        (hist.to(torch.int64), mask, mask, "int32"),
        (hist[..., :1], mask, mask, "int32"),
        (hist, mask.to(torch.int32), mask, "bool"),
        (hist, mask[:, :51], mask[:, :51], "bool"),
        (hist, mask, mask[:2], "differ"),
        (hist, mask[:0], mask[:0], "N=0"),
        (hist[:0], mask, mask, "S=0"),
        (hist.transpose(0, 1).contiguous().transpose(0, 1), mask, mask,
         "contiguous"),
        (hist, mask.t().contiguous().t(), mask, "contiguous"),
    ]
    for h, nm, dm, match in bad:
        with pytest.raises(ValueError, match=match):
            masked_window_ratio(h, nm, dm)


# --------------------------- K5's design: prefix differences over mask runs
WEEK_CHUNK = 64     # kWeekChunk in csrc/windowed_ratio_masked.cu
MASK_KINDS = ("none", "first", "last", "all", "alternating", "window",
              "random")


def _mask_kind(kind, n, w, rng):
    """N masks of one shape: no week; one run from the first week or to
    the last; every week; alternating weeks (both phases); one run
    anywhere (a window); or each week at random."""
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


def _edge_bytes(mask):
    """The kernel's edge list of one mask over one week chunk: each
    position j in [0, wc] where the mask (unset outside the chunk) differs
    from the week before, as the byte ``j << 1 | starts-a-run``."""
    m = np.concatenate([[False], mask, [False]])
    return [(int(j) << 1) | int(m[j + 1])
            for j in np.flatnonzero(m[1:] != m[:-1])]


def _prefix_model(hist, nm, dm):
    """A torch model of K5's arithmetic: per chunk of WEEK_CHUNK weeks,
    each site's exclusive prefix sums P_c of both channels in uint32, and
    each query's sum as P_c at its mask's run ends minus P_c at its run
    starts, mod 2^32, added onto the earlier chunks' sums."""
    h = torch.from_numpy(hist).to(torch.int64)
    s, w, _ = h.shape
    sums = torch.zeros(2, nm.shape[0], s, dtype=torch.int64)
    for w0 in range(0, w, WEEK_CHUNK):
        wc = min(WEEK_CHUNK, w - w0)
        pre = torch.zeros(2, wc + 1, s, dtype=torch.int64)
        pre[:, 1:] = torch.cumsum(h[:, w0:w0 + wc].permute(2, 1, 0),
                                  dim=1) % 2**32
        for c, masks in ((0, dm), (1, nm)):
            for q in range(masks.shape[0]):
                for e in _edge_bytes(masks[q, w0:w0 + wc]):
                    v = pre[c, e >> 1]
                    sums[c, q] += -v if e & 1 else v
        sums %= 2**32
    den, num = (torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)
                for x in sums)
    return [x.numpy() for x in (safe_ratio(num, den), num, den)]


@pytest.mark.parametrize("high", (1000, 1 << 20, 1 << 27))
@pytest.mark.parametrize("w", (1, 52, 64, 65))
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_prefix_difference_model_equals_the_references(kind, w, high):
    """K5's run encoding and prefix differences give the exact wrapping
    int32 sums for every mask shape, at W of one week, the service's 52,
    one chunk (64) and one week past it (65), with counts whose sums stay
    small, pass 2^24 or pass 2^31."""
    rng = np.random.default_rng(len(kind) * 1000 + w * 10 + high % 7)
    hist, _, _ = _case(w + high % 11, 9, w, 129, high=high, density=0.9)
    nm, dm = _mask_kind(kind, 9, w, rng), _mask_kind(kind, 9, w, rng)
    got = _prefix_model(hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, nm, dm),
                  f"{kind} vs JAX's masked_window_ratio_ref")
    _assert_equal(got, _port(masked_window_ratio_ref, hist, nm, dm),
                  f"{kind} vs the port's ref")
    _assert_equal(got, _port(masked_window_ratio, hist, nm, dm),
                  f"{kind} vs the plain version")
    if high == 1 << 27 and kind in ("all", "last") and w >= 52:
        assert (got[1] < 0).any(), "no sum passed 2^31"
    if high == 1 << 20 and kind == "all" and w > 1:
        assert (got[1] > 1 << 24).any(), "no sum passed 2^24"


@pytest.mark.parametrize("w", (1, 52, 64, 65))
def test_edge_lists_of_the_mask_shapes(w):
    """Edges per mask: none for an empty mask, two for one run (the end
    at W when the run reaches the last week), and for alternating weeks
    one start and one end a run: 26 runs and 52 edges at W = 52."""
    assert _edge_bytes(np.zeros(w, bool)) == []
    assert _edge_bytes(np.ones(w, bool)) == [1, w << 1]
    first = np.arange(w) < 1
    assert _edge_bytes(first) == [1, 2]
    last = np.arange(w) == w - 1
    assert _edge_bytes(last) == [((w - 1) << 1) | 1, w << 1]
    alt = np.arange(w) % 2 == 0
    edges = _edge_bytes(alt)
    assert len(edges) == w + (w % 2)
    assert len(edges) // 2 == alt.sum()            # one start, one end a run
    assert [e & 1 for e in edges] == [1, 0] * (len(edges) // 2)
    if w == 52:
        assert len(edges) == 52


# ------------------------------------------------- windowed_ratio (K7)
def _hist(seed, s, w, *, high=1000):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, high, size=(s, w, 2), dtype=np.int32)
    hist[rng.random(s) < 0.2] = 0                   # empty sites
    hist[:, rng.random(w) < 0.2] = 0                # zero weeks
    return hist


def _port1(fn, hist):
    return [x.numpy() for x in fn(torch.from_numpy(hist))]


def _jax1(fn, hist, **kw):
    return [np.asarray(x) for x in fn(jnp.asarray(hist), **kw)]


def _assert_equal1(got, want, msg=""):
    for name, a, b in zip(("rho", "cum_total", "cum_marked"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{name} {msg}"
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{name} {msg}")


@pytest.mark.parametrize("s", (1, 513, 2048))
@pytest.mark.parametrize("w", (1, 52))
def test_windowed_ratio_matches_jax(s, w):
    hist = _hist(s * 100 + w, s, w)
    got = _port1(windowed_ratio, hist)
    assert got[0].shape == (s, w) and got[0].dtype == np.float32
    _assert_equal1(got, _jax1(jax_windowed_ratio, hist, interpret=True),
                   "vs the Pallas kernel")
    _assert_equal1(got, _jax1(jax_windowed_ratio_ref, hist),
                   "vs windowed_ratio_ref")
    _assert_equal1(got, _port1(windowed_ratio_ref, hist), "vs the port's ref")
    b = spm.malstone_b(torch.from_numpy(hist))
    _assert_equal1(got, [b.rho.numpy(), b.total.numpy(), b.marked.numpy()],
                   "vs spm.malstone_b")


def test_windowed_ratio_past_2_24_follows_the_exact_reference():
    """The Pallas body scans with an f32 matmul: week counts 2^24 + 1, 1
    give cum_total 2^24, 2^24 there and rho 1.0 in week 2; the int32
    reference (and the port) give 2^24 + 1, 2^24 + 2 and rho 0.9999999."""
    hist = np.zeros((2, 2, 2), np.int32)
    hist[0, :, 0] = (2**24 + 1, 1)
    hist[0, :, 1] = (2**24, 1)
    hist[1] = 7
    got = _port1(windowed_ratio, hist)
    _assert_equal1(got, _jax1(jax_windowed_ratio_ref, hist))
    assert got[1][0].tolist() == [2**24 + 1, 2**24 + 2]
    assert got[2][0].tolist() == [2**24, 2**24 + 1]
    assert got[0][0, 1] == np.float32(0.9999999)
    pallas = _jax1(jax_windowed_ratio, hist, interpret=True)
    assert pallas[1][0].tolist() == [2**24, 2**24], \
        "the Pallas f32 scan no longer rounds"
    assert pallas[0][0, 1] == 1.0
    _assert_equal1([x[1:] for x in got], [x[1:] for x in pallas])


def test_windowed_ratio_wraps_past_2_31_where_pallas_saturates():
    """2^30 in every week: the int32 reference wraps (2^30, -2^31, -2^30,
    0) and its rho is 0 where the wrapped denominator is <= 0; the Pallas
    cast saturates at 2^31 - 1 and its rho stays 1.0."""
    hist = np.full((1, 4, 2), 2**30, np.int32)
    got = _port1(windowed_ratio, hist)
    _assert_equal1(got, _jax1(jax_windowed_ratio_ref, hist))
    assert got[1][0].tolist() == [2**30, -2**31, -2**30, 0]
    assert got[0][0].tolist() == [1.0, 0.0, 0.0, 0.0]
    pallas = _jax1(jax_windowed_ratio, hist, interpret=True)
    assert pallas[1][0].tolist() == [2**30] + [2**31 - 1] * 3
    assert pallas[0][0].tolist() == [1.0] * 4
    big = _hist(9, 300, 52, high=1 << 27)
    got = _port1(windowed_ratio, big)
    _assert_equal1(got, _jax1(jax_windowed_ratio_ref, big))
    assert (got[1] < 0).any(), "no running sum passed 2^31"


def test_windowed_ratio_cpu_tensors_take_the_plain_version():
    hist = _hist(4, 100, 52)
    reset_launch_counts()
    got = _port1(windowed_ratio, hist)
    assert launch_counts()["windowed_ratio"] == 0
    _assert_equal1(got, _port1(windowed_ratio_plain, hist))


def test_windowed_ratio_rejects_what_the_kernel_does_not_take():
    hist = torch.zeros(10, 52, 2, dtype=torch.int32)
    for bad, match in ((hist.to(torch.int64), "int32"),
                       (hist[..., :1], "int32"),
                       (hist[0], "int32"),
                       (hist[:0], "S=0"),
                       (hist[:, :0], "W=0"),
                       (hist.transpose(0, 1).contiguous().transpose(0, 1),
                        "contiguous")):
        with pytest.raises(ValueError, match=match):
            windowed_ratio(bad)


@pytest.mark.parametrize("shape", ((1, 1), (513, 52), (4, 250, 52),
                                   (2, 3, 40, 130)))
def test_malstone_b_on_the_cpu_equals_jax(shape):
    """MalStone B's finalize on a CPU histogram ``[..., W, 2]`` (a full
    ``[S, W, 2]`` or the partitioned ``[P, S/P, W, 2]`` blocks) stays the
    two int32 cumsums and ``safe_ratio``, equal to JAX's ``malstone_b``,
    and launches nothing."""
    from repro.core import spm as jax_spm

    rng = np.random.default_rng(sum(shape))
    hist = rng.integers(0, 1 << 27, size=(*shape, 2), dtype=np.int32)
    hist[..., rng.random(shape[-1]) < 0.2, :] = 0      # zero weeks
    reset_launch_counts()
    got = spm.malstone_b(torch.from_numpy(hist))
    assert launch_counts()["windowed_ratio"] == 0
    want = jax_spm.malstone_b(jnp.asarray(hist))
    _assert_equal1([got.rho.numpy(), got.total.numpy(), got.marked.numpy()],
                   [np.asarray(want.rho), np.asarray(want.total),
                    np.asarray(want.marked)], f"{shape}")
