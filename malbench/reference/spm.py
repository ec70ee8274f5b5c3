"""The histogram, MalStone B, the window queries and the record shuffle's
accounting, in plain PyTorch over the reference's records.

Counts are int64 here; the program's int32 counts must equal them (the
configurations keep every count under 2^31). ``ratio`` is MalStone's
``marked / total`` in float32 with 0/0 -> 0; ``precision="bfloat16"``
computes it a precision lower, as the control does.
"""

from __future__ import annotations

import numpy as np
import torch

from malbench.reference import malgen

SECONDS_PER_WEEK = malgen.SECONDS_PER_WEEK


def add_chunk(hist: torch.Tensor, cols, num_weeks: int) -> None:
    """Count one chunk's ``(site, week, mark)`` into the int64 ``[S, W,
    2]`` (total, marked) histogram."""
    site, week, mark = cols
    s = hist.shape[0]
    cells = torch.bincount(site * num_weeks + week, minlength=s * num_weeks)
    marked = torch.bincount((site * num_weeks + week)[mark > 0],
                            minlength=s * num_weeks)
    hist[..., 0] += cells.view(s, num_weeks)
    hist[..., 1] += marked.view(s, num_weeks)


def ratio(num: torch.Tensor, den: torch.Tensor,
          precision: str = "float32") -> torch.Tensor:
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    q = num.to(dtype) / torch.clamp(den.to(dtype), min=1.0)
    return torch.where(den > 0, q, torch.zeros_like(q)).to(torch.float32)


def malstone_b(hist: torch.Tensor, precision: str = "float32"):
    """(rho f32, cum_total, cum_marked), each ``[S, W]``."""
    cum_total = torch.cumsum(hist[..., 0], dim=1)
    cum_marked = torch.cumsum(hist[..., 1], dim=1)
    return ratio(cum_marked, cum_total, precision), cum_total, cum_marked


def week_mask(mon_start: int, mon_end: int, num_weeks: int,
              year_seconds: int) -> np.ndarray:
    """The week buckets a monitor window covers, fully or partly; the last
    bucket ends at the year's end."""
    starts = np.arange(num_weeks, dtype=np.int64) * SECONDS_PER_WEEK
    ends = np.minimum(starts + SECONDS_PER_WEEK, year_seconds)
    ends[-1] = year_seconds
    return (starts < mon_end) & (ends > mon_start)


def query_masks(query: dict, num_weeks: int, year_seconds: int):
    """(numerator, denominator) week masks of one query: A counts the
    monitor window in both; B the prefix from the year's start to the
    window's end in both; B-fixed the prefix over the exposure window."""
    exp_start, exp_end, mon_start, mon_end = query["window"]
    mon = week_mask(mon_start, mon_end, num_weeks, year_seconds)
    prefix = week_mask(0, mon_end, num_weeks, year_seconds)
    if query["statistic"] == "A":
        return mon, mon
    if query["statistic"] == "B":
        return prefix, prefix
    return prefix, week_mask(exp_start, exp_end, num_weeks, year_seconds)


def answer(hist: torch.Tensor, query: dict, num_weeks: int,
           year_seconds: int, precision: str = "float32") -> dict:
    """One query's answer over every site: rho, num (marked in the
    numerator weeks), den (total in the denominator weeks), the top-k sites
    by rho (ties: the lower site first) and the drill-down site's row."""
    nm, dm = query_masks(query, num_weeks, year_seconds)
    nm = torch.from_numpy(nm).to(hist.device)
    dm = torch.from_numpy(dm).to(hist.device)
    num = (hist[..., 1] * nm).sum(dim=1)
    den = (hist[..., 0] * dm).sum(dim=1)
    rho = ratio(num, den, precision)
    out = {"rho": rho.cpu().numpy(), "num": num.cpu().numpy(),
           "den": den.cpu().numpy()}
    k = query.get("top_k", 0)
    if k:
        order = np.argsort(-out["rho"], kind="stable")[:k]
        out["top_sites"] = order
        out["top_rho"] = out["rho"][order]
    site = query.get("site")
    if site is not None:
        out["site_rho"] = out["rho"][site]
        out["site_total"] = hist[site, :, 0].cpu().numpy()
        out["site_marked"] = hist[site, :, 1].cpu().numpy()
    return out


def shuffle_counts(site: torch.Tensor, nodes: int) -> torch.Tensor:
    """Records of one node's chunk bound for each destination node
    (``site % nodes``), int64 ``[nodes]``."""
    return torch.bincount(site % nodes, minlength=nodes)


def shuffle_rounds(counts: torch.Tensor, capacity: int) -> int:
    """Rounds the lossless exchange of one step takes: every destination
    segment of every node ships ``capacity`` records a round."""
    return max(1, int(-(-int(counts.max()) // capacity)))


def shuffle_residual(counts: torch.Tensor, capacity: int, rounds: int):
    """Records a node leaves for later rounds, summed over the rounds:
    int64 ``[nodes]`` of a ``[nodes, nodes]`` count table."""
    left = torch.zeros(counts.shape[0], dtype=torch.int64,
                       device=counts.device)
    for r in range(rounds):
        left += (counts - (r + 1) * capacity).clamp(min=0).sum(dim=1)
    return left


def wrap32(x: int) -> int:
    """An integer as the int32 it wraps to (the counters' stated rule)."""
    return (int(x) + 2**31) % 2**32 - 2**31
