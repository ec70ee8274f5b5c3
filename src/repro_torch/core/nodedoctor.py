"""NodeDoctor: the SPM statistic as cluster fault attribution.

Counterpart of ``repro/core/nodedoctor.py``. Paper §8 notes that changes
over time in rho_{j,t} can be found with CUSUM and related change
detection; Table 1's generalization applies it to the cluster itself:

    site   = host id
    entity = step (or segment) id
    mark   = "this step failed / straggled"

A host whose rho_{host,t} breaks upward is marking the steps it touches.
The resumable runner (``core/resume.py``, through
``faults/telemetry.py``) reroutes shards away from hosts whose CUSUM alarm
fires.

The report is computed on the device of the log: on the card, MalStone B's
finalize is K7 at ``W = num_buckets`` and ``S = hosts``, and the histogram
is the plain ``spm.site_week_histogram``. Four details keep the port's
answers JAX's: the median of an even count averages the two middle values
(``jnp.nanmedian``; ``torch.nanmedian`` returns the lower one), the CUSUM's
cumsum adds in the order of XLA's CPU cumsum (``_cumsum_xla``), the suspect
ranking is a stable argsort (as ``jnp.argsort``), and the baseline is a
float32 scalar before ``1 - baseline`` is formed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import (
    EventLog,
    SECONDS_PER_WEEK,
    WEEKS_PER_YEAR,
)
from repro_torch.core.spm import malstone_b, site_week_histogram


class DoctorReport(NamedTuple):
    rho: torch.Tensor           # [hosts, buckets] running failure proportion
    cusum: torch.Tensor         # [hosts, buckets] one-sided CUSUM statistic
    alarm: torch.Tensor         # bool [hosts]: CUSUM crossed the threshold
    suspect_rank: torch.Tensor  # [hosts] argsort by final CUSUM, worst first


def host_telemetry_log(host_id: torch.Tensor, step_id: torch.Tensor,
                       step_time_bucket: torch.Tensor,
                       failed: torch.Tensor) -> EventLog:
    """Pack runtime telemetry into the site-entity-mark model."""
    return EventLog(site_id=host_id.to(torch.int32),
                    entity_id=step_id.to(torch.int32),
                    timestamp=step_time_bucket.to(torch.int32),
                    mark=failed.to(torch.int32))


def diagnose_telemetry(host_id, step_id, step_time_bucket, failed,
                       *, num_hosts: int,
                       num_buckets: int = WEEKS_PER_YEAR, device=None,
                       **diagnose_kw) -> DoctorReport:
    """Front end for host callers (the fault telemetry buffer): pack
    Python sequences into a log on ``device`` (the card unless
    ``device="cpu"``) and diagnose. ``diagnose_kw`` forwards the
    threshold and baseline knobs of :func:`diagnose`.

    ``step_time_bucket`` is a bucket *index*; it is scaled to week
    seconds here, since the histogram buckets timestamps by
    ``SECONDS_PER_WEEK``."""
    device = resolve_device(device)

    def col(x):
        return torch.as_tensor(x, device=device).to(torch.int32)

    log = host_telemetry_log(col(host_id), col(step_id),
                             col(step_time_bucket) * SECONDS_PER_WEEK,
                             col(failed))
    return diagnose(log, num_hosts, num_buckets=num_buckets, **diagnose_kw)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a float32 vector: the linear interpolation of
    the sorted non-NaN values at q = 0.5 (an even count averages the two
    middle values); NaN when every value is NaN."""
    vals = torch.sort(x[~torch.isnan(x)]).values
    n = vals.numel()
    if n == 0:
        return torch.tensor(math.nan, dtype=x.dtype, device=x.device)
    q = 0.5 * (n - 1)
    lo, hi = math.floor(q), math.ceil(q)
    w_hi = torch.tensor(q - lo, dtype=x.dtype, device=x.device)
    return vals[lo] * (1.0 - w_hi) + vals[hi] * w_hi


# XLA's CPU cumsum (a reduce-window rewritten into a blocked scan)
_SCAN_BLOCK = 16


def _cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 cumsum over the last axis, associated as ``jnp.cumsum`` on
    the CPU: sequential adds within blocks of 16, then each block's
    exclusive prefix (the same scan of the block totals) added once.
    ``torch.cumsum`` accumulates in double on the CPU, so its rounding
    differs, and near ties in the final CUSUM would rank otherwise."""
    w = x.shape[-1]
    if w <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for t in range(1, w):
            cols.append(cols[-1] + x[..., t])
        return torch.stack(cols, dim=-1)
    nb = -(-w // _SCAN_BLOCK)
    padded = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - w))
    inner = _cumsum_xla(padded.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    prefix = _cumsum_xla(inner[..., -1])
    before = torch.cat([torch.zeros_like(prefix[..., :1]),
                        prefix[..., :-1]], dim=-1)
    out = inner + before[..., None]
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :w]


def diagnose(log: EventLog, num_hosts: int,
             num_buckets: int = WEEKS_PER_YEAR,
             drift_sigmas: float = 0.5,
             threshold_sigmas: float = 6.0,
             baseline: float | None = None) -> DoctorReport:
    """Run MalStone B over telemetry and a normalized one-sided CUSUM over
    the *per-bucket* mark counts.

    Per bucket, the host's marked count is compared against the cluster
    baseline proportion in binomial-std units::

        sigma_t = sqrt(total_t * baseline * (1 - baseline))
        z_t     = (marked_t - baseline * total_t) / sigma_t - drift_sigmas
        c_t     = max(0, c_{t-1} + z_t);  alarm iff max_t c_t > threshold

    The default ``baseline`` is the median per-host mark proportion, so a
    uniformly flaky fleet stays quiet and only *relatively* bad hosts
    alarm. ``rho`` is the paper's MalStone B running ratio.
    """
    hist = site_week_histogram(log, num_hosts, num_buckets)
    rho = malstone_b(hist).rho  # [hosts, buckets]

    total_t = hist[..., 0].to(torch.float32)   # per-bucket counts
    marked_t = hist[..., 1].to(torch.float32)

    if baseline is None:
        # median per-host mark proportion: robust to one bad host
        # dominating the record stream (a global mean would rise with the
        # bad host's own failures and mask it)
        host_total = total_t.sum(dim=-1)
        host_marked = marked_t.sum(dim=-1)
        prop = torch.where(host_total > 0,
                           host_marked / torch.clamp(host_total, min=1.0),
                           torch.full_like(host_total, math.nan))
        baseline = torch.nan_to_num(_nanmedian(prop), nan=0.0)
    baseline = torch.clamp(
        torch.as_tensor(baseline, dtype=torch.float32,
                        device=total_t.device), 1e-4, 1.0 - 1e-4)

    sigma = torch.sqrt(torch.clamp(total_t, min=1.0) * baseline
                       * (1.0 - baseline))
    z = (marked_t - baseline * total_t) / sigma - drift_sigmas
    z = torch.where(total_t > 0, z, torch.zeros_like(z))  # idle buckets

    # one-sided CUSUM without a scan:
    #   c_t = max(0, c_{t-1} + z_t) == cumsum(z)_t - min(0, cs_0..cs_t)
    cs = _cumsum_xla(z)
    padded = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    running_min = torch.cummin(padded, dim=-1).values
    cusum = cs - running_min[..., 1:]

    final = cusum[..., -1]
    alarm = cusum.max(dim=-1).values > threshold_sigmas
    # only hosts that actually served steps can be suspects
    served = total_t.sum(dim=-1) > 0
    alarm = alarm & served
    rank = torch.argsort(
        -torch.where(served, final, torch.full_like(final, -math.inf)),
        stable=True)
    return DoctorReport(rho=rho, cusum=cusum, alarm=alarm, suspect_rank=rank)
