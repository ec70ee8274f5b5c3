"""The port's single-device oracle and the SPM helpers of ``core/spm.py``
against the JAX package's, exactly.

The same log, made with numpy from a seed, goes to both sides: JAX's
``malstone_single_device`` (``repro/core/runner.py:671``),
``malstone_{a,b}_from_log`` and ``spm_entity_sets``
(``repro/core/spm.py:101-143``) against the port's. Equality is exact:
integer totals and the bits of ``rho``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import EventLog as JaxLog
from repro.core import malstone_single_device as jax_single_device
from repro.core import spm as jax_spm
from repro_torch.common.types import NEVER_MARKED, EventLog
from repro_torch.core import malstone_single_device
from repro_torch.core import spm
from repro_torch.kernels import launch_counts, reset_launch_counts

SECONDS_PER_YEAR = 31_536_000
STATISTICS = ("A", "B", "B-fixed")
# (seed, records, sites, weeks, with padding rows)
LOGS = ((1, 5_000, 301, 52, False), (2, 20_000, 64, 52, True),
        (3, 3_000, 1_000, 13, True), (4, 1, 7, 52, False))


def _np_log(seed, n, num_sites, with_padding):
    """Columns with sites and timestamps partly out of range (they count
    nowhere, or in the edge week), marks 0/1/2 and, optionally, padding
    rows."""
    rng = np.random.default_rng(seed)
    cols = dict(
        site_id=rng.integers(-3, num_sites + 3, n, dtype=np.int32),
        entity_id=rng.integers(0, 5_000, n, dtype=np.int32),
        timestamp=rng.integers(-100_000, SECONDS_PER_YEAR + 100_000, n,
                               dtype=np.int32),
        mark=rng.integers(0, 3, n, dtype=np.int32))
    if with_padding:
        cols["valid"] = rng.random(n) < 0.9
    return cols


def _logs(cols):
    jlog = JaxLog(**{k: jnp.asarray(v) for k, v in cols.items()})
    tlog = EventLog(**{k: torch.from_numpy(v) for k, v in cols.items()})
    return jlog, tlog


def _assert_equal(got, want, msg):
    for f in ("total", "marked"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {msg}")
    np.testing.assert_array_equal(
        got.rho.numpy().view(np.int32),
        np.asarray(want.rho).view(np.int32), err_msg=f"rho bits {msg}")


@pytest.mark.parametrize("statistic", STATISTICS)
@pytest.mark.parametrize("seed,n,num_sites,num_weeks,padding", LOGS)
def test_single_device_matches_jax(seed, n, num_sites, num_weeks, padding,
                                   statistic):
    jlog, tlog = _logs(_np_log(seed, n, num_sites, padding))
    want = jax_single_device(jlog, num_sites, statistic=statistic,
                             num_weeks=num_weeks)
    reset_launch_counts()
    got = malstone_single_device(tlog, num_sites, statistic=statistic,
                                 num_weeks=num_weeks)
    assert set(launch_counts().values()) == {0}       # a CPU log
    assert got.rho.shape == ((num_sites,) if statistic == "A"
                             else (num_sites, num_weeks))
    _assert_equal(got, want, f"{statistic} seed={seed}")


def test_single_device_takes_a_histogram_fn():
    jlog, tlog = _logs(_np_log(5, 4_000, 128, False))
    calls = []

    def hist_fn(log, num_sites, num_weeks):
        calls.append((num_sites, num_weeks))
        return spm.site_week_histogram(log, num_sites, num_weeks)

    got = malstone_single_device(tlog, 128, histogram_fn=hist_fn)
    assert calls == [(128, 52)]
    _assert_equal(got, jax_single_device(jlog, 128), "histogram_fn")
    with pytest.raises(ValueError, match="statistic"):
        malstone_single_device(tlog, 128, statistic="C")


@pytest.mark.parametrize("seed,n,num_sites,num_weeks,padding", LOGS)
def test_from_log_finalizers_match_jax(seed, n, num_sites, num_weeks,
                                       padding):
    jlog, tlog = _logs(_np_log(seed, n, num_sites, padding))
    _assert_equal(spm.malstone_a_from_log(tlog, num_sites, num_weeks),
                  jax_spm.malstone_a_from_log(jlog, num_sites, num_weeks),
                  "A from log")
    _assert_equal(spm.malstone_b_from_log(tlog, num_sites, num_weeks),
                  jax_spm.malstone_b_from_log(jlog, num_sites, num_weeks),
                  "B from log")
    # and they are the single-device path's A and B
    _assert_equal(spm.malstone_b_from_log(tlog, num_sites, num_weeks),
                  malstone_single_device(tlog, num_sites, "B", num_weeks),
                  "B from log vs oracle")


# (exposure start, end, monitor start, end)
WINDOWS = ((0, SECONDS_PER_YEAR, 0, SECONDS_PER_YEAR),
           (0, SECONDS_PER_YEAR // 2, SECONDS_PER_YEAR // 2,
            SECONDS_PER_YEAR),
           (604_800, 604_800 * 10, 0, 604_800 * 3),
           (100, 100, 0, SECONDS_PER_YEAR),
           (-5, 3, -5, 3))


def _entity_case(seed, n, num_sites, num_entities):
    rng = np.random.default_rng(seed)
    site = rng.integers(0, num_sites, n, dtype=np.int32)
    entity = rng.integers(0, num_entities, n, dtype=np.int32)
    ts = rng.integers(0, SECONDS_PER_YEAR, n, dtype=np.int32)
    mark_time = rng.integers(0, SECONDS_PER_YEAR, num_entities,
                             dtype=np.int32)
    mark_time[rng.random(num_entities) < 0.4] = NEVER_MARKED
    return site, entity, ts, mark_time


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("seed,n,num_sites,num_entities",
                         ((1, 2_000, 37, 150), (2, 500, 5, 400),
                          (3, 3, 11, 7)))
def test_spm_entity_sets_matches_jax(seed, n, num_sites, num_entities,
                                     window):
    site, entity, ts, mark_time = _entity_case(seed, n, num_sites,
                                               num_entities)
    want = jax_spm.spm_entity_sets(
        jnp.asarray(site), jnp.asarray(entity), jnp.asarray(ts),
        jnp.asarray(mark_time), num_sites, *window,
        num_entities=num_entities)
    got = spm.spm_entity_sets(
        torch.from_numpy(site), torch.from_numpy(entity),
        torch.from_numpy(ts), torch.from_numpy(mark_time), num_sites,
        *window, num_entities=num_entities)
    assert got.dtype == torch.float32 and got.shape == (num_sites,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_spm_entity_sets_counts_each_entity_once():
    """Definition 1 counts entities, not visits: an entity that visits a
    site many times before its mark counts once in A_j and B_j; an empty
    site gives 0, not a negative fill value."""
    site = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32)
    entity = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    ts = torch.tensor([10, 20, 30, 40, 50], dtype=torch.int32)
    mark_time = torch.tensor([100, NEVER_MARKED, 45], dtype=torch.int32)
    rho = spm.spm_entity_sets(site, entity, ts, mark_time, 3, 0, 1000, 0,
                              1000, num_entities=3)
    # site 0: A = {0, 1}, B = {0}; site 1: entity 2 visits at 50, after
    # its mark at 45, so A = {1}, B = {}; site 2: empty
    assert rho.tolist() == [0.5, 0.0, 0.0]
