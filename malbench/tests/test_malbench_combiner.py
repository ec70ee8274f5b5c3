"""The cell ``malstone-b10-combiner.batch``: its entries, K8's work, a
tiny run on the CPU against the reference, the control and each fault of
``test_malbench_faults.FAULTS`` read as not correct."""

import pytest

from malbench import check, harness, roofline
from malbench.roofline_k8 import k8_work
from test_malbench_faults import FAULTS

CELL = "malstone-b10-combiner.batch"


def test_the_cell_resolves_with_its_metrics():
    resolved = harness.resolve(harness.load_spec(), CELL)
    assert resolved["cell"]["chips"] == 1
    config = resolved["config"]
    assert config["backend"] == "mapreduce_combiner"
    assert (config["nodes"], config["chunk_records"], config["steps"]) == (
        8, 2**23, 119)
    assert {m["name"] for m in resolved["end_to_end"]} == {
        "records_per_s", "peak_gib", "setup_s"}
    assert {m["name"] for m in resolved["per_layer"]} == {
        "combine.k4_roofline", "device.idle_share.batch",
        "exchange.k8_roofline"}


def test_k8_work_at_the_cells_shapes():
    config = harness.resolve(harness.load_spec(), CELL)["config"]
    s_pad = roofline.padded_sites(config)
    assert s_pad == 120_000
    assert k8_work(config["nodes"], s_pad, config["num_weeks"]) == (
        499_200_000, 0)
    least, by = roofline.bound_seconds(499_200_000, 0)
    assert by == "bytes" and least == pytest.approx(1.49e-4, rel=1e-3)


def _k8_reader_run(ops):
    resolved = harness.resolve(harness.load_spec(), CELL)
    run = harness.Run(resolved, 1, 0.0, True, "cpu", 0.0)
    run.trace = {"ops": ops}
    return run


def test_the_k8_reader_counts_its_kernel_records():
    read = harness.reader("exchange.k8_roofline")
    name = ("(anonymous namespace)::combine_blocks_kernel(int const*, int*, "
            "int, int, int, int, int)")
    got = read(_k8_reader_run({name: {"count": 4, "seconds": 4 * 2.5e-4},
                               "other_kernel(int)": {"count": 9,
                                                     "seconds": 1.0}}))
    assert got["bound_by"] == "bytes"
    assert got["value"] == pytest.approx(100 * 499.2e6 / 3.35e12 / 2.5e-4)
    # the parent's program has no K8: the reader finds nothing to read
    assert read(_k8_reader_run({"other_kernel(int)": {"count": 9,
                                                      "seconds": 1.0}})) \
        is None
    assert read(harness.Run(harness.resolve(harness.load_spec(), CELL), 1,
                            0.0, False, "cpu", 0.0)) is None


def test_a_tiny_run_is_correct(tiny_cell):
    result = harness.execute(tiny_cell(CELL), 2**31 + 4001, 0.3, False,
                             "cpu", 0.0)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"jobs_unequal", "total_differing",
                                     "marked_differing", "rho_bits_differing"}
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["metrics"]) == {"records_per_s", "setup_s"}


def test_the_control_is_not_correct(tiny_cell):
    run = harness.Run(tiny_cell(CELL), 2**31 + 4002, 0.3, False, "cpu", 0.0)
    run.counters["jobs"] = 1
    numbers = check.batch_checks(run, check.control_outputs(run))
    assert numbers["rho_bits_differing"] > 0, numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, tiny_cell, monkeypatch):
    """On the CPU the combiner's exchange runs the torch path through
    ``nodes.all_to_all``, so the exchange fault reaches it too."""
    FAULTS[fault](monkeypatch)
    result = harness.execute(tiny_cell(CELL), 2**31 + 4003, 0.3, False,
                             "cpu", 0.0)
    assert result["correct"] is False, result["checks"]
