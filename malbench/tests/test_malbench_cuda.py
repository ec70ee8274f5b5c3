"""On the card (``python -m pytest -m cuda malbench/tests``): a short run
of a cell is correct, and the control at the cell's own size is not."""

import pytest

from malbench import control, harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["malstone-b10-sphere.batch",
                                  "malstone-b10-mapreduce.serve"])
def test_short_run_is_correct(cell, cuda_device):
    resolved = harness.resolve(harness.load_spec(), cell)
    result = harness.execute(resolved, 2**31 + 901, 2.0, False, cuda_device,
                             0.0)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["malstone-b10-mapreduce.batch",
                                  "malstone-b10-sphere.serve"])
def test_control_fails_at_the_cells_size(cell, cuda_device):
    resolved = harness.resolve(harness.load_spec(), cell)
    numbers = control.readings(resolved, 2**31 + 902, cuda_device)
    assert numbers["rho_bits_differing"] > 0, numbers
