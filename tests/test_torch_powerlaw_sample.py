"""The port's power-law site sampler (K6's plain version, on the CPU) and
its oracle against the JAX package: its Pallas ``_kernel`` in interpret
mode and its ``powerlaw_sample_ref``; K6's guide table modelled in torch
(``_guide``, ``_bracket``); MalGen's ``sample_sites`` on the CPU against
JAX's.

Equality is exact (int32 site indices). The draws are made from a seed with
numpy; the CDF tables are JAX's ``power_law_cdf`` and the port's
``masked_site_cdf`` of JAX's weights. Both packages get the same arrays.

The masked table is the port's: its scan adds in index order, so the table
never steps down. JAX's ``masked_site_cdf`` scans with XLA's CPU cumsum,
which leaves a few entries 1-2 ulp below their predecessor after runs of
zero weights; on such a table the count of ``cdf <= u`` (the Pallas body)
and a binary search (the reference) are different functions, and the
sampler's contract (a non-decreasing CDF) does not hold.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.powerlaw_sample.ops import (
    powerlaw_sample as jax_powerlaw_sample,
)
from repro.kernels.powerlaw_sample.ref import (
    powerlaw_sample_ref as jax_powerlaw_sample_ref,
)
from repro.malgen import powerlaw as jax_powerlaw
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.powerlaw_sample import (
    powerlaw_sample,
    powerlaw_sample_join,
    powerlaw_sample_plain,
    powerlaw_sample_ref,
)
from repro_torch.kernels._build import CSRC
from repro_torch.malgen import power_law_cdf, power_law_weights, sample_sites
from repro_torch.malgen.powerlaw import masked_site_cdf


def _cdf(kind: str, s: int, seed: int) -> np.ndarray:
    """JAX's power-law CDF, or the port's masked CDF of JAX's weights with
    runs of zero-weight sites (repeated CDF entries)."""
    w = jax_powerlaw.power_law_weights(s)
    if kind == "power_law":
        return np.asarray(jax_powerlaw.power_law_cdf(w))
    rng = np.random.default_rng(seed)
    mask = rng.random(s) < 0.6
    for start in rng.integers(0, s, 3):          # zero-weight runs
        mask[start:start + max(1, s // 10)] = False
    mask[rng.integers(0, s)] = True
    cdf = masked_site_cdf(torch.tensor(np.asarray(w)),
                          torch.from_numpy(mask)).numpy()
    assert (np.diff(cdf) >= 0).all()
    return cdf


def _draws(n: int, cdf: np.ndarray, seed: int) -> np.ndarray:
    """Uniform draws, a quarter of them exactly on CDF entries, and the
    edges: -0.0, 0.0, 1.0, above 1, below 0 and +-inf."""
    rng = np.random.default_rng(seed)
    u = rng.random(n, dtype=np.float32)
    on = rng.random(n) < 0.25
    u[on] = cdf[rng.integers(0, cdf.shape[0], int(on.sum()))]
    edges = np.array([-0.0, 0.0, 1.0, 2.0, -1.0, np.inf, -np.inf],
                     np.float32)
    u[rng.integers(0, n, min(n, 7))] = edges[:min(n, 7)]
    return u


def _port(fn, u, cdf):
    return fn(torch.tensor(u), torch.tensor(cdf)).numpy()


def _jax(fn, u, cdf, **kw):
    return np.asarray(fn(jnp.asarray(u), jnp.asarray(cdf), **kw))


@pytest.mark.parametrize("kind", ("power_law", "masked"))
@pytest.mark.parametrize("s", (1, 7, 2048, 5000))
@pytest.mark.parametrize("n", (1, 513, 4096))
def test_powerlaw_sample_matches_jax(kind, s, n):
    cdf = _cdf(kind, s, s + n)
    u = _draws(n, cdf, s * 7 + n)
    got = _port(powerlaw_sample, u, cdf)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, _jax(jax_powerlaw_sample_ref, u, cdf))
    np.testing.assert_array_equal(
        got, _jax(jax_powerlaw_sample, u, cdf, interpret=True))
    np.testing.assert_array_equal(got, _port(powerlaw_sample_ref, u, cdf))
    assert ((got >= 0) & (got < s)).all()


def test_ties_go_right_and_repeated_entries_are_skipped():
    cdf = np.array([0.0, 0.0, 0.25, 0.25, 0.5, 1.0], np.float32)
    u = np.array([-0.0, 0.0, 0.25, 0.9999999, 1.0, 2.0, np.inf, -1.0,
                  -np.inf], np.float32)
    want = [2, 2, 4, 5, 5, 5, 5, 0, 0]
    np.testing.assert_array_equal(_port(powerlaw_sample, u, cdf), want)
    np.testing.assert_array_equal(
        _jax(jax_powerlaw_sample, u, cdf, interpret=True), want)


def test_nan_draw_gives_the_last_site_like_the_reference():
    """``searchsorted`` sorts NaN last, so the reference gives S - 1; the
    Pallas body counts ``cdf <= NaN``, never true, and gives 0. The port
    follows the reference."""
    cdf = np.array([0.0, 0.0, 0.25, 0.25, 0.5, 1.0], np.float32)
    u = np.array([np.nan, 0.3], np.float32)
    got = _port(powerlaw_sample, u, cdf)
    np.testing.assert_array_equal(got, [5, 4])
    np.testing.assert_array_equal(got, _jax(jax_powerlaw_sample_ref, u, cdf))
    np.testing.assert_array_equal(got, _port(powerlaw_sample_ref, u, cdf))
    pallas = _jax(jax_powerlaw_sample, u, cdf, interpret=True)
    assert pallas[0] == 0, "the Pallas body no longer gives 0 for NaN"
    assert pallas[1] == got[1]


def test_power_law_cdf_matches_jax():
    """The f32 scan drifts from XLA's by rounding (the seed-table rule):
    equal at rtol=1e-6, last entry exactly 1."""
    for s in (1, 7, 2048, 100_000):
        got = power_law_cdf(power_law_weights(s)).numpy()
        want = np.asarray(jax_powerlaw.power_law_cdf(
            jax_powerlaw.power_law_weights(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got[-1] == 1.0 and (np.diff(got) >= 0).all()


def test_sites_equal_jax_when_handed_jaxs_cdf():
    """MalGen's sampling: the port's sites equal JAX's
    ``jnp.searchsorted`` path (``powerlaw.py:38``) on JAX's table."""
    s, n = 100_000, 1 << 14
    cdf = np.asarray(jax_powerlaw.power_law_cdf(
        jax_powerlaw.power_law_weights(s)))
    u = np.random.default_rng(3).random(n, dtype=np.float32)
    got = _port(powerlaw_sample, u, cdf)
    np.testing.assert_array_equal(got, _jax(jax_powerlaw_sample_ref, u, cdf))
    idx = np.clip(np.searchsorted(cdf, u, side="right"), 0, s - 1)
    np.testing.assert_array_equal(got, idx)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    cdf = _cdf("masked", 700, 1)
    u = _draws(3000, cdf, 2)
    reset_launch_counts()
    got = _port(powerlaw_sample, u, cdf)
    assert launch_counts()["powerlaw_sample"] == 0
    np.testing.assert_array_equal(
        got, _port(powerlaw_sample_plain, u, cdf))


def _join_case(n: int, skew: int, seed: int):
    """A join call's arguments over ``n`` records, every column at
    ``skew`` ints into its buffer (as the unmarked half of a row lies)."""
    rng = np.random.default_rng(seed)
    cdf = _cdf("masked", 700, seed)
    entity = rng.integers(0, 50, n + skew, dtype=np.int32)
    ts = rng.integers(0, 1000, n + skew, dtype=np.int32)
    u = np.concatenate([np.zeros(skew, np.float32), _draws(n, cdf, seed)])
    cols = [torch.tensor(u)[skew:], torch.tensor(cdf),
            torch.tensor(entity)[skew:], torch.tensor(ts)[skew:],
            torch.tensor(rng.integers(0, 1000, 50, dtype=np.int32))]
    out = [torch.full((n + skew,), -7, dtype=torch.int32)[skew:]
           for _ in range(4)]
    return cols, out


@pytest.mark.parametrize("skew", (0, 1, 3))
def test_join_on_cpu_takes_the_plain_version_and_counts_no_launch(skew):
    """The join pass on CPU tensors: K6's answer (the plain count), the
    mark joined, the event ids from ``seq_start`` and the hash, each
    written into its slice and nothing outside it; no launch counted."""
    (u, cdf, entity, ts, mark_time), out = _join_case(3001, skew, 4)
    reset_launch_counts()
    powerlaw_sample_join(u, cdf, entity, ts, mark_time, *out,
                         seq_start=838_861, hash_value=-5)
    assert launch_counts()["powerlaw_sample"] == 0
    site, mark, seq, hsh = out
    assert torch.equal(site, powerlaw_sample_plain(u, cdf))
    assert torch.equal(mark, (mark_time[entity.long()] <= ts).int())
    assert mark.sum() > 0 and (1 - mark).sum() > 0
    assert torch.equal(seq, torch.arange(838_861, 838_861 + 3001,
                                         dtype=torch.int32))
    assert (hsh == -5).all()
    for col in out:
        assert col.dtype == torch.int32
        if skew:
            assert (col._base[:skew] == -7).all()


def test_join_rejects_what_the_kernel_does_not_take():
    (u, cdf, entity, ts, mark_time), out = _join_case(10, 0, 1)
    site, mark, seq, hsh = out

    def call(**kw):
        args = dict(u=u, cdf=cdf, entity=entity, timestamp=ts,
                    mark_time=mark_time, site=site, mark=mark, event_seq=seq,
                    shard_hash=hsh)
        args.update(kw)
        powerlaw_sample_join(**args, seq_start=0, hash_value=0)

    bad = [
        (dict(u=u.double()), "u must be"),
        (dict(cdf=cdf.double()), "cdf must be"),
        (dict(entity=entity[:9]), "entity must be"),
        (dict(mark=mark.long()), "mark must be"),
        (dict(site=torch.zeros(20, dtype=torch.int32)[::2]), "contiguous"),
        (dict(mark_time=mark_time[:0]), "mark_time is empty"),
        (dict(mark_time=mark_time.reshape(5, 10)), "mark_time must be"),
        (dict(u=u[:0], entity=entity[:0], timestamp=ts[:0], site=site[:0],
              mark=mark[:0], event_seq=seq[:0], shard_hash=hsh[:0]), "n=0"),
        (dict(shard_hash=hsh.to("meta")), "shard_hash on"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            call(**kw)
    with pytest.raises(ValueError, match="leave int32"):
        powerlaw_sample_join(u, cdf, entity, ts, mark_time, *out,
                             seq_start=2**31 - 10, hash_value=0)


def test_plain_version_is_the_comparison_count():
    """The merge gives ``sum_s 1{cdf[s] <= u}`` entry by entry, whatever
    the order of the table (as the Pallas body's count does), with zeros
    of either sign tied."""
    rng = np.random.default_rng(5)
    cdf = rng.random(300).astype(np.float32)          # not sorted
    cdf[:40] = cdf[40:80]                             # repeated entries
    cdf[80:90] = 0.0
    cdf[90:95] = -0.0
    u = np.concatenate([rng.random(500).astype(np.float32), cdf[::7],
                        np.float32([0.0, -0.0, -1.0, 2.0])])
    count = (cdf[None, :] <= u[:, None]).sum(1)
    np.testing.assert_array_equal(
        _port(powerlaw_sample_plain, u, cdf), np.clip(count, 0, 299))
    np.testing.assert_array_equal(
        _port(powerlaw_sample_plain, u, cdf),
        _jax(jax_powerlaw_sample, u, cdf, interpret=True))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u = torch.rand(10)
    cdf = torch.linspace(0.1, 1.0, 6)
    bad = [
        (u.double(), cdf, "float32"),
        (u, cdf.double(), "float32"),
        (u.reshape(2, 5), cdf, "float32"),
        (u[::2], cdf, "contiguous"),
        (u, cdf.repeat(2)[::2], "contiguous"),
        (u[:0], cdf, "n=0"),
        (u, cdf[:0], "S=0"),
        (u, cdf.to("meta"), "cdf on"),
    ]
    for a, b, match in bad:
        with pytest.raises(ValueError, match=match):
            powerlaw_sample(a, b)


# ------------------------------------------- K6's guide table, on the CPU
# G, the table's buckets of [0, 1), as the kernel's source sets it
GUIDE = 1 << int(re.search(r"constexpr int kLogGuide = (\d+);",
                           (CSRC / "powerlaw_sample.cu").read_text())
                 .group(1))


def _guide(cdf: torch.Tensor) -> torch.Tensor:
    """K6's table, int64 ``[G + 1]``: entry b counts the entries of the
    (non-decreasing) CDF ``<= b / G``."""
    edges = torch.arange(GUIDE + 1, dtype=torch.float32) / GUIDE
    return torch.searchsorted(cdf, edges, right=True)


def _bracket(u: torch.Tensor, cdf: torch.Tensor):
    """(lo, hi) int64: the indices K6 searches for each draw, from
    ``_guide`` as the kernel takes them: ``[guide[b], guide[b + 1]]`` for
    x in [0, 1) with ``b = (int)(x * G)``; ``[0, guide[0]]`` for x < 0,
    ``[guide[G], S]`` for x >= 1; ``[S - 1, S - 1]`` for NaN."""
    guide = _guide(cdf)
    s = cdf.shape[0]
    inside = (u >= 0) & (u < 1)
    b = torch.where(inside, u * GUIDE, 0).to(torch.int64)
    lo = torch.where(inside, guide[b], 0)
    hi = torch.where(inside, guide[b + 1], guide[0])
    lo = torch.where(u >= 1, guide[GUIDE], lo)
    hi = torch.where(u >= 1, s, hi)
    nan = torch.isnan(u)
    return torch.where(nan, s - 1, lo), torch.where(nan, s - 1, hi)


def _permuted_cdf(s: int, seed: int) -> np.ndarray:
    """A MalGen-like table: JAX's weights under a random permutation,
    restricted to a random mask of about 90% of the sites (the unmarked
    CDF's shape: zero entries anywhere, heavy sites anywhere), scanned as
    the port scans."""
    rng = np.random.default_rng(seed)
    perm = jnp.asarray(rng.permutation(s).astype(np.int32))
    w = jax_powerlaw.power_law_weights(s, permutation=perm)
    mask = rng.random(s) < 0.9
    mask[:3] = False                                 # leading zero entries
    mask[rng.integers(0, s)] = True
    return masked_site_cdf(torch.tensor(np.asarray(w)),
                           torch.from_numpy(mask)).numpy()


def _guide_draws(n: int, cdf: np.ndarray, seed: int) -> np.ndarray:
    """``_draws`` plus draws on the guide's bucket edges b / G, just below
    them, and NaN."""
    u = _draws(n, cdf, seed)
    rng = np.random.default_rng(seed + 1)
    k = n // 8
    edges = (rng.integers(0, GUIDE + 1, k) / GUIDE).astype(np.float32)
    u[rng.integers(0, n, k)] = edges
    u[rng.integers(0, n, k)] = np.nextafter(edges, np.float32(-1))
    u[rng.integers(0, n, 3)] = np.nan
    return u


@pytest.mark.parametrize("kind", ("power_law", "masked", "permuted"))
@pytest.mark.parametrize("s", (1, 7, 5000, 100_000))
def test_guide_brackets_hold_the_reference_answer(kind, s):
    """K6 finishes each draw's search inside [guide[b], guide[b + 1]] (or
    [0, guide[0]] below 0, [guide[G], S] from 1 on): the bracket holds the
    unclipped count of ``cdf <= u``, whose clip is JAX's
    ``powerlaw_sample_ref``; a NaN draw's bracket is S - 1 alone."""
    cdf = (_permuted_cdf(s, s) if kind == "permuted"
           else _cdf(kind, s, s + 1))
    u = _guide_draws(4096, cdf, s + 2)
    lo, hi = (x.numpy() for x in _bracket(torch.tensor(u),
                                               torch.tensor(cdf)))
    count = np.searchsorted(cdf, u, side="right")
    nan = np.isnan(u)
    assert ((lo <= count) & (count <= hi))[~nan].all()
    assert (lo[nan] == s - 1).all() and (hi[nan] == s - 1).all()
    ref = _jax(jax_powerlaw_sample_ref, u, cdf)
    np.testing.assert_array_equal(
        np.where(nan, s - 1, np.clip(count, 0, s - 1)), ref)
    if kind != "power_law" and s == 100_000:
        # most MalGen-like brackets are one index: no search at all
        assert (lo == hi).mean() > 0.5


def test_guide_of_a_cdf_below_1_and_outside_0_1():
    """A last entry below 1 leaves the draws in [cdf[-1], 1) the bracket
    [S, S] (clipped to S - 1); entries below 0 and above 1 fall in the
    brackets of x < 0 and x >= 1."""
    cdf = np.array([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0],
                   np.float32)
    u = np.array([-1.0, -0.3, -0.0, 0.0, 0.1, 0.75, 0.99, 1.0, 1.7, 3.0,
                  np.inf, -np.inf], np.float32)
    lo, hi = (x.numpy() for x in _bracket(torch.tensor(u),
                                               torch.tensor(cdf)))
    count = np.searchsorted(cdf, u, side="right")
    assert ((lo <= count) & (count <= hi)).all()
    below = cdf[:6] * np.float32(0.9)                  # last entry 0.675
    u = np.array([0.6, 0.675, 0.7, 0.9999999], np.float32)
    lo, hi = (x.numpy() for x in _bracket(torch.tensor(u),
                                               torch.tensor(below)))
    assert lo.tolist()[2:] == [6, 6] and hi.tolist()[2:] == [6, 6]
    np.testing.assert_array_equal(_port(powerlaw_sample, u, below),
                                  _jax(jax_powerlaw_sample_ref, u, below))


@pytest.mark.parametrize("kind", ("power_law", "permuted"))
def test_sample_sites_on_the_cpu_equals_jax(kind):
    """MalGen's ``sample_sites`` on a CPU table stays
    ``torch.searchsorted`` and gives JAX's ``sample_sites`` sites on JAX's
    draws."""
    import jax

    s, n = 5000, 20_000
    cdf = _permuted_cdf(s, 8) if kind == "permuted" else _cdf(kind, s, 9)
    key = jax.random.key(11)
    u = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32))
    got = sample_sites(torch.tensor(cdf), torch.tensor(u)).numpy()
    want = np.asarray(jax_powerlaw.sample_sites(key, jnp.asarray(cdf), n))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    reset_launch_counts()
    sample_sites(torch.tensor(cdf), torch.tensor(u))
    assert launch_counts()["powerlaw_sample"] == 0
