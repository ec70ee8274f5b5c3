"""Test settings of the benchmark: the ``cuda`` marker (tests that need a
card skip here, deciding inside a fixture), and a tiny configuration of
each cell that runs on the CPU in seconds."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m cuda "
                    "malbench/tests on the card)")
    return torch.device("cuda")


def tiny(cell: str) -> dict:
    """The cell resolved from ``BENCHMARK.json`` at a size the CPU runs in
    well under a second: 8 nodes x 3 steps of 4,096 records, 512 sites."""
    from malbench import harness

    resolved = harness.resolve(harness.load_spec(ROOT), cell)
    config, traffic = resolved["config"], resolved["traffic"]
    config["malgen"].update(num_sites=512, num_entities=4096)
    config.update(chunk_records=4096, steps=3)
    for q in traffic.get("queries", []):
        if q.get("site") is not None:
            q["site"] = 511
    if traffic["kind"] == "serve":
        traffic["rate_per_s"] = 40
    return resolved


@pytest.fixture
def tiny_cell():
    return tiny
