"""The port's NodeDoctor (``core/nodedoctor.py``) against the JAX
package's, on the same telemetry.

``rho``, ``alarm``, ``suspect_rank`` and ``cusum`` are exact (the floats
by their bits): the port adds the CUSUM's cumsum in the order of XLA's CPU
cumsum (``nodedoctor._cumsum_xla``, held against ``jnp.cumsum`` here), so
hosts whose final CUSUMs nearly tie rank as in JAX. The telemetry covers a degrading
host, a healthy and a uniformly flaky fleet, idle hosts, hosts tied at a
zero CUSUM (the stable ranking), the median baseline over odd and even
host counts (an even count averages the two middle proportions) and the
fixed baselines the fault telemetry uses. JAX runs eagerly, as the fault
telemetry calls it (compiled whole, its float32 rounding can differ from
the eager one's and reorder hosts whose CUSUMs nearly tie); the cases
share shapes where they can, since every new shape compiles every op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import SECONDS_PER_WEEK
from repro.core.nodedoctor import diagnose as jax_diagnose
from repro.core.nodedoctor import diagnose_telemetry as jax_diagnose_telemetry
from repro.core.nodedoctor import host_telemetry_log as jax_log
from repro_torch.core import nodedoctor
from repro_torch.core.nodedoctor import (
    diagnose,
    diagnose_telemetry,
    host_telemetry_log,
)


def synth_telemetry(num_hosts=8, steps_per_bucket=20, buckets=20,
                    bad_host=3, fail_after=10, fail_rate=0.6, seed=0,
                    base_rate=0.02, idle_hosts=()):
    """``tests/test_nodedoctor.py``'s telemetry, as numpy; hosts in
    ``idle_hosts`` serve no step."""
    rng = np.random.default_rng(seed)
    host, step, bucket, failed = [], [], [], []
    sid = 0
    for b in range(buckets):
        for h in range(num_hosts):
            if h in idle_hosts:
                continue
            for _ in range(steps_per_bucket):
                host.append(h)
                step.append(sid)
                bucket.append(b)
                p = base_rate
                if h == bad_host and b >= fail_after:
                    p = fail_rate
                failed.append(int(rng.random() < p))
                sid += 1
    return tuple(np.asarray(x, np.int32) for x in (host, step, bucket,
                                                    failed))


# (case, synth_telemetry kwargs, diagnose kwargs); 8 hosts is an even
# count: the median baseline averages the 4th and 5th proportions
CASES = (
    ("degrading", dict(), dict()),
    ("healthy", dict(bad_host=-1), dict()),
    ("flaky_fleet", dict(bad_host=-1, seed=1, base_rate=0.3), dict()),
    ("fixed_baseline", dict(bad_host=0, seed=6),
     dict(baseline=0.05, threshold_sigmas=6.0)),
    ("drift_and_threshold", dict(bad_host=4, seed=7, fail_rate=0.2),
     dict(drift_sigmas=0.25, threshold_sigmas=3.0)),
    ("odd_hosts_median", dict(num_hosts=7, bad_host=5, seed=5,
                              base_rate=0.1), dict()),
    ("idle_hosts", dict(num_hosts=9, bad_host=2, idle_hosts=(0, 7)),
     dict()),
    ("all_idle_but_one", dict(num_hosts=4, bad_host=-1,
                              idle_hosts=(0, 1, 3)), dict()),
    ("many_weeks", dict(num_hosts=3, bad_host=1, buckets=52,
                        steps_per_bucket=3, seed=8), dict()),
)


def _assert_report(got, want, msg):
    np.testing.assert_array_equal(got.rho.numpy().view(np.int32),
                                  np.asarray(want.rho).view(np.int32),
                                  err_msg=f"rho bits {msg}")
    np.testing.assert_array_equal(got.alarm.numpy(), np.asarray(want.alarm),
                                  err_msg=f"alarm {msg}")
    np.testing.assert_array_equal(got.suspect_rank.numpy(),
                                  np.asarray(want.suspect_rank),
                                  err_msg=f"suspect_rank {msg}")
    np.testing.assert_array_equal(got.cusum.numpy().view(np.int32),
                                  np.asarray(want.cusum).view(np.int32),
                                  err_msg=f"cusum bits {msg}")
    assert got.rho.dtype == torch.float32 and got.alarm.dtype == torch.bool


@pytest.mark.parametrize("case,synth,kw", CASES, ids=[c[0] for c in CASES])
def test_diagnose_matches_jax(case, synth, kw):
    h, s, b, f = synth_telemetry(**synth)
    buckets = synth.get("buckets", 20)
    num_hosts = synth.get("num_hosts", 8)
    want = jax_diagnose(
        jax_log(jnp.asarray(h), jnp.asarray(s),
                jnp.asarray(b) * SECONDS_PER_WEEK, jnp.asarray(f)),
        num_hosts, num_buckets=buckets, **kw)
    log = host_telemetry_log(torch.from_numpy(h), torch.from_numpy(s),
                             torch.from_numpy(b) * SECONDS_PER_WEEK,
                             torch.from_numpy(f))
    got = diagnose(log, num_hosts, num_buckets=buckets, **kw)
    _assert_report(got, want, case)
    if case == "degrading":
        assert got.alarm.tolist() == [h == 3 for h in range(8)]
        assert int(got.suspect_rank[0]) == 3
    if case in ("healthy", "flaky_fleet"):
        assert not got.alarm.any()
    assert bool((got.cusum >= 0).all())


@pytest.mark.parametrize("num_hosts", (4, 5))
def test_diagnose_telemetry_matches_jax(num_hosts):
    """The fault buffer's front end: Python lists of bucket indices,
    diagnosed at the buffer's fixed baseline and at the median."""
    h, s, b, f = synth_telemetry(num_hosts=num_hosts, buckets=8,
                                 steps_per_bucket=4, bad_host=1, seed=9)
    for kw in (dict(baseline=0.05, threshold_sigmas=6.0), dict()):
        want = jax_diagnose_telemetry(list(h), list(s), list(b),
                                      [bool(x) for x in f],
                                      num_hosts=num_hosts, num_buckets=8,
                                      **kw)
        got = diagnose_telemetry(list(h), list(s), list(b),
                                 [bool(x) for x in f], num_hosts=num_hosts,
                                 num_buckets=8, device="cpu", **kw)
        _assert_report(got, want, f"{num_hosts} hosts {kw}")


def test_median_averages_the_two_middle_values():
    """``jnp.nanmedian``'s linear interpolation, NaNs left out, where
    ``torch.nanmedian`` would return the lower middle value."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 4, 7, 8, 16):
        for nans in (0, 1, 3):
            x = rng.random(n + nans).astype(np.float32)
            x[rng.permutation(n + nans)[:nans]] = np.nan
            want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
            got = nodedoctor._nanmedian(torch.from_numpy(x)).numpy()
            assert got.view(np.int32) == want.view(np.int32), (n, nans)
    two = torch.tensor([0.25, 0.5], dtype=torch.float32)
    assert float(nodedoctor._nanmedian(two)) == 0.375
    assert float(torch.nanmedian(two)) == 0.25
    assert torch.isnan(nodedoctor._nanmedian(
        torch.full((3,), float("nan"))))


@pytest.mark.parametrize("width", (1, 8, 16, 17, 24, 52, 200, 1000))
def test_cumsum_adds_in_xla_order(width):
    """``jnp.cumsum`` on the CPU adds sequentially within blocks of 16 and
    adds each block's prefix once; ``torch.cumsum`` rounds otherwise."""
    z = (np.random.default_rng(width).standard_normal((64, width)) * 3
         ).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(z), axis=-1))
    got = nodedoctor._cumsum_xla(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if width >= 24:
        assert not np.array_equal(torch.cumsum(torch.from_numpy(z), -1)
                                  .numpy(), want)


def test_ties_rank_stably_as_jax():
    """Every host served and none failed: every final CUSUM is 0, and the
    suspects rank in host order (a stable sort of ties, -0 equal to 0)."""
    h, s, b, f = synth_telemetry(num_hosts=6, bad_host=-1, base_rate=0.0)
    got = diagnose_telemetry(h, s, b, f, num_hosts=6, num_buckets=20,
                             device="cpu")
    assert got.suspect_rank.tolist() == list(range(6))
    assert not got.alarm.any()


def test_host_telemetry_log_columns():
    log = host_telemetry_log(torch.tensor([1, 2]), torch.tensor([3, 4]),
                             torch.tensor([0, 5]), torch.tensor([True,
                                                                 False]))
    assert all(c.dtype == torch.int32 for c in log[:4])
    assert log.mark.tolist() == [1, 0] and log.valid is None


def test_diagnose_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diagnose_telemetry([0], [0], [0], [True], num_hosts=1)
