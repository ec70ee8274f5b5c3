"""The result line's keys, the check that no module of JAX or of the JAX
package loads, and a run that finds no card prints no result."""

import json
import shutil
import subprocess
import sys

import pytest

from malbench import harness

ROOT = harness.ROOT


def test_result_line_keys(tiny_cell):
    result = harness.execute(tiny_cell("malstone-b10-sphere.batch"),
                             2**31 + 11, 0.2, False, "cpu", 0.0)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    assert set(result["metrics"]) == {"records_per_s", "setup_s"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_traced_line_has_breakdown_and_window(tiny_cell):
    result = harness.execute(tiny_cell("malstone-b10-sphere.serve"),
                             2**31 + 12, 0.2, True, "cpu", 0.0)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "query.submit_ms.p50" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_forbidden_modules_compare_whole_names():
    port = ["repro_torch", "repro_torch.core.api", "reprolike", "jaxtyping"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules(port + ["jax.numpy", "repro.core",
                                             "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def _run(cwd, cell="malstone-b10-sphere.batch"):
    return subprocess.run(
        [sys.executable, "malbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    proc = _run(ROOT)
    assert proc.returncode not in (0, None)
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's
    folder (no program) prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "malbench", tmp_path / "malbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["malstone-b10-sphere.batch",
                                  "malstone-b10-mapreduce.serve"])
def test_run_imports_no_jax(cell):
    """A whole run (tiny, on the CPU), in a fresh process, loads no module
    of JAX or of the JAX package, though it loads the port."""
    code = (
        "import sys; sys.path[:0] = ['src', '.', 'malbench/tests']\n"
        "from conftest import tiny\n"
        "from malbench import harness\n"
        f"r = harness.execute(tiny({cell!r}), 2**31 + 5, 0.2, False, 'cpu',"
        " 0.0)\n"
        "assert r['correct'], r\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
