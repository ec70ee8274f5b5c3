"""The port's power-law site sampler (K6's plain version, on the CPU) and
its oracle against the JAX package: its Pallas ``_kernel`` in interpret
mode and its ``powerlaw_sample_ref``.

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
    powerlaw_sample_plain,
    powerlaw_sample_ref,
)
from repro_torch.malgen import power_law_cdf, power_law_weights
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
