"""Whether the timed path's outputs are correct: each compared against the
plain reference (``malbench/reference``), worked out again from the seed
and the configuration once the window has closed.

Every number compared is a count of values that differ, with the limit 0:
the configurations state exact integer counts and MalStone's float32 ratio
of them, so the program's answers must equal the reference's bit for bit.

- batch: the job's MalStone B over every site and week (cumulative total
  and marked counts, rho's bits), every job equal to the first, and on
  mapreduce the shuffle's accounting (``ShuffleStats``; its counters wrap
  as int32, the rule the configuration states);
- serve: every query batch due in the window answered, and a sample drawn
  from the seed (with the last batch) compared against the histogram of
  the steps folded before it was submitted: counts, rho's bits, the top-k
  and the drill-down.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from malbench.reference import malgen, spm


def reference_config(config: dict) -> dict:
    return dict(config["malgen"], num_weeks=config["num_weeks"])


def capacity(config: dict) -> int:
    """Records a destination's bucket holds a round (Python ``round``,
    halves to even)."""
    per_node = config["chunk_records"] / config["nodes"]
    return int(max(1, round(per_node * config["plan"]["capacity_factor"])))


def fold_reference(seed: int, config: dict, device, at_steps=(),
                   on_step=None, shuffle: bool = False) -> dict:
    """Fold the log's steps into an int64 histogram; ``on_step(k, hist)``
    sees it after each step count in ``at_steps`` (0 before any). With
    ``shuffle`` it also works out the exchange's rounds, residual and
    bytes."""
    cfg = reference_config(config)
    p, c, steps = config["nodes"], config["chunk_records"], config["steps"]
    tabs = malgen.tables(seed, cfg, p * steps, c, device)
    hist = torch.zeros(cfg["num_sites"], cfg["num_weeks"], 2,
                       dtype=torch.int64, device=device)
    last = steps if not at_steps else max(at_steps)
    if 0 in at_steps:
        on_step(0, hist)
    cap = capacity(config)
    acc = {"rounds": 0, "residual": 0, "bytes": 0}
    for j in range(last):
        counts = []
        for d in range(p):
            cols = malgen.chunk_records_of(seed, cfg, tabs, d * steps + j, c)
            spm.add_chunk(hist, cols, cfg["num_weeks"])
            if shuffle:
                counts.append(spm.shuffle_counts(cols[0], p))
        if shuffle:
            table = torch.stack(counts)
            r = spm.shuffle_rounds(table, cap)
            acc["rounds"] = max(acc["rounds"], r)
            acc["residual"] += int(spm.shuffle_residual(table, cap, r).sum())
            acc["bytes"] += p * r * p * cap * 4
        if j + 1 in at_steps:
            on_step(j + 1, hist)
    acc["hist"] = hist
    return acc


def differing(a, b) -> int:
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.to(torch.float32).view(torch.int32)
    else:
        a, b = a.to(torch.int64), b.to(torch.int64)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def batch_checks(run, outputs, precision: str = "float32") -> dict:
    """The numbers compared for a batch cell, given the program's
    ``(SpmResult, ShuffleStats or None)`` of its first job."""
    config = run.config
    shuffle = config["backend"] == "mapreduce"
    ref = fold_reference(run.seed, config, run.device, shuffle=shuffle)
    rho, cum_total, cum_marked = spm.malstone_b(ref.pop("hist"), precision)
    result, stats = outputs
    checks = {
        "jobs_unequal": run.counters.get("jobs_unequal", 0),
        "total_differing": differing(result.total.cpu(), cum_total.cpu()),
        "marked_differing": differing(result.marked.cpu(), cum_marked.cpu()),
        "rho_bits_differing": differing(result.rho.cpu(), rho.cpu()),
    }
    if shuffle:
        p, steps, c = config["nodes"], config["steps"], config["chunk_records"]
        want = {"sent": spm.wrap32(p * steps * c), "overflow": 0,
                "capacity": capacity(config), "rounds": ref["rounds"],
                "residual": spm.wrap32(ref["residual"]),
                "bytes_exchanged": spm.wrap32(ref["bytes"])}
        checks["shuffle_fields_differing"] = (
            sum(int(getattr(stats, k)) != v for k, v in want.items())
            if stats is not None else len(want))
    return checks


def serve_checks(run, kept, precision: str = "float32") -> dict:
    """The numbers compared for a serve cell, given the kept batches
    ``(index, steps folded at submission, answers)``."""
    config, queries = run.config, run.traffic["queries"]
    cfg = reference_config(config)
    year = cfg["span_seconds"]
    by_k: dict = {}
    for _, folded, answers in kept:
        by_k.setdefault(folded, []).append(answers)
    checks = {"batches_missing": (run.counters.get("batches_due", 0)
                                  - run.counters.get("batches", 0)),
              "counts_differing": 0, "rho_bits_differing": 0,
              "topk_differing": 0}

    def on_step(k, hist):
        for answers in by_k[k]:
            if len(answers) != len(queries):
                checks["counts_differing"] += 1
                continue
            for q, got in zip(queries, answers):
                want = spm.answer(hist, q, cfg["num_weeks"], year, precision)
                checks["counts_differing"] += (differing(got.num, want["num"])
                                               + differing(got.den,
                                                           want["den"]))
                checks["rho_bits_differing"] += differing(got.rho,
                                                          want["rho"])
                if q.get("top_k"):
                    checks["topk_differing"] += (
                        differing(got.top_sites, want["top_sites"])
                        + differing(got.top_rho, want["top_rho"]))
                if q.get("site") is not None:
                    checks["rho_bits_differing"] += differing(
                        np.float32(got.site_rho), np.float32(want["site_rho"]))
                    checks["counts_differing"] += (
                        differing(got.site_total, want["site_total"])
                        + differing(got.site_marked, want["site_marked"]))

    if by_k:
        fold_reference(run.seed, config, run.device, at_steps=set(by_k),
                       on_step=on_step)
    return checks


def compare(run, outputs) -> dict:
    """``{"correct", "attempted", "failed", "checks"}``: each number with
    its limit (0)."""
    if run.traffic["kind"] == "batch":
        numbers = batch_checks(run, outputs)
        attempted = run.counters["jobs"]
        failed = run.counters["jobs_unequal"] + (
            any(v for k, v in numbers.items() if k != "jobs_unequal"))
    else:
        numbers = serve_checks(run, outputs)
        attempted = run.counters["batches_due"]
        failed = numbers["batches_missing"] + (
            any(v for k, v in numbers.items() if k != "batches_missing"))
    checks = {k: {"value": int(v), "limit": 0} for k, v in numbers.items()}
    return {"correct": all(v["value"] <= v["limit"]
                           for v in checks.values()),
            "attempted": int(attempted), "failed": int(min(failed, attempted)),
            "checks": checks}


def control_outputs(run, precision: str = "bfloat16"):
    """The reference computed a precision lower, in the program's place:
    the control that the checks must fail."""
    config = run.config
    if run.traffic["kind"] == "batch":
        ref = fold_reference(run.seed, config, run.device)
        rho, total, marked = spm.malstone_b(ref["hist"], precision)
        return (types.SimpleNamespace(rho=rho, total=total, marked=marked),
                None)
    cfg = reference_config(config)
    rng = np.random.default_rng(run.seed)
    ks = sorted(set(rng.integers(1, config["steps"] + 1,
                                 size=run.traffic["kept_batches"]).tolist())
                | {config["steps"]})
    kept = []

    def on_step(k, hist):
        answers = [types.SimpleNamespace(**spm.answer(
            hist, q, cfg["num_weeks"], cfg["span_seconds"], precision))
            for q in run.traffic["queries"]]
        kept.append((len(kept), k, answers))

    fold_reference(run.seed, config, run.device, at_steps=set(ks),
                   on_step=on_step)
    return kept
