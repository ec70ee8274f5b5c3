"""The ``BENCH_<name>.json`` document of the port: the JAX package's
schema (``repro/bench/schema.py``), same field names and validator, written
by the port's launchers.

The schema's ``jax_version`` field is kept for the compare tools and holds
``"n/a"``; ``torch_version`` names the framework that ran. ``platform`` is
``"gpu"`` or ``"cpu"`` and ``device_count`` counts the CUDA devices (1 on
the CPU).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time
from typing import Optional

import torch

from repro_torch.bench.timing import TimingResult

SCHEMA_VERSION = 1
PERCENTILE_KEYS = ("p50", "p95", "p99")

_REQUIRED_TOP = {
    "schema_version": int, "name": str, "created_unix": (int, float),
    "git_sha": str, "jax_version": str, "platform": str,
    "device_count": int, "results": list,
}
_REQUIRED_RESULT = {
    "scenario": str, "params": dict, "us_per_call": (int, float),
    "us_min": (int, float), "us_mean": (int, float), "us_std": (int, float),
    "rel_dispersion": (int, float), "samples_us": list, "warmup_iters": int,
    "iters": int, "steady": bool,
}


class BenchSchemaError(ValueError):
    """A document does not conform to the BENCH_*.json schema."""


def latency_percentiles(samples_us) -> dict:
    """``{"p50", "p95", "p99"}`` of the samples (microseconds), linear
    interpolation over the sorted samples; stored under
    ``derived["latency_percentiles"]``."""
    samples = sorted(float(s) for s in samples_us)
    if not samples:
        raise ValueError("need at least one sample")

    def pct(p: float) -> float:
        if len(samples) == 1:
            return samples[0]
        rank = p / 100.0 * (len(samples) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(samples) - 1)
        return samples[lo] + (samples[hi] - samples[lo]) * (rank - lo)

    return {"p50": pct(50.0), "p95": pct(95.0), "p99": pct(99.0)}


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3]


def git_sha() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo_root(),
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"


def new_document(name: str, *, env: Optional[dict] = None) -> dict:
    cuda = torch.cuda.is_available()
    doc = {
        "schema_version": SCHEMA_VERSION, "name": name,
        "created_unix": time.time(), "git_sha": git_sha(),
        "jax_version": "n/a", "torch_version": torch.__version__,
        "platform": "gpu" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "results": [],
    }
    if env:
        doc["env"] = env
    return doc


def add_result(doc: dict, scenario: str, params: dict, timing: TimingResult,
               *, records: Optional[int] = None,
               derived: Optional[dict] = None) -> dict:
    """Append one scenario result (and return it)."""
    entry = {"scenario": scenario, "params": dict(params)}
    entry.update(timing.as_dict())
    if records is not None:
        entry["records"] = int(records)
        if timing.us_per_call > 0:
            entry["records_per_s"] = records / (timing.us_per_call / 1e6)
    if derived:
        entry["derived"] = dict(derived)
    doc["results"].append(entry)
    return entry


def _check_fields(obj: dict, spec: dict, where: str) -> None:
    for key, typ in spec.items():
        if key not in obj:
            raise BenchSchemaError(f"{where}: missing required key {key!r}")
        allowed = typ if isinstance(typ, tuple) else (typ,)
        if not isinstance(obj[key], typ) or (
                bool not in allowed and isinstance(obj[key], bool)):
            raise BenchSchemaError(f"{where}: key {key!r} has type "
                                   f"{type(obj[key]).__name__}")


def _check_latency_percentiles(block, where: str) -> None:
    if not isinstance(block, dict) or set(block) != set(PERCENTILE_KEYS):
        raise BenchSchemaError(f"{where}: derived.latency_percentiles must "
                               f"hold exactly {list(PERCENTILE_KEYS)}")
    prev = 0.0
    for key in PERCENTILE_KEYS:
        val = block[key]
        if (not isinstance(val, (int, float)) or isinstance(val, bool)
                or val < prev):
            raise BenchSchemaError(f"{where}: latency percentiles must be "
                                   f"non-decreasing numbers >= 0")
        prev = float(val)


def validate_document(doc: dict) -> None:
    """Raise ``BenchSchemaError`` unless ``doc`` conforms to the schema."""
    if not isinstance(doc, dict):
        raise BenchSchemaError(f"document is {type(doc).__name__}, not dict")
    _check_fields(doc, _REQUIRED_TOP, "document")
    if doc["schema_version"] != SCHEMA_VERSION or doc["device_count"] < 1:
        raise BenchSchemaError("bad schema_version or device_count")
    seen = set()
    for i, res in enumerate(doc["results"]):
        where = f"results[{i}]"
        if not isinstance(res, dict):
            raise BenchSchemaError(f"{where} is not a dict")
        _check_fields(res, _REQUIRED_RESULT, where)
        if res["scenario"] in seen:
            raise BenchSchemaError(f"{where}: duplicate scenario")
        seen.add(res["scenario"])
        if (res["us_per_call"] < 0 or res["iters"] < 1
                or len(res["samples_us"]) != res["iters"]):
            raise BenchSchemaError(f"{where}: bad timing fields")
        derived = res.get("derived")
        if isinstance(derived, dict) and "latency_percentiles" in derived:
            _check_latency_percentiles(derived["latency_percentiles"], where)


def write_document(doc: dict, path) -> pathlib.Path:
    """Validate ``doc`` and write it to ``path``."""
    validate_document(doc)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2) + "\n")
    return path
