"""The roofline's byte and operation counts against hand counts at small
shapes."""

import pytest

from malbench import roofline


@pytest.mark.parametrize("work, want", [
    # K1: 2 rows x 5,000 destinations read; 2 tiles x 3 counters a row
    (roofline.k1_work(2, 5000, 2), (4 * 10000 + 4 * 2 * 2 * 3, 0)),
    # K2: words and destinations read, words written, the bases read
    (roofline.k2_work(2, 5000, 2), (12 * 10000 + 4 * 2 * 2 * 3, 0)),
    # K3: 2 x 100 words read, [2, 10, 52, 2] int32 written
    (roofline.k3_work(2, 100, 10, 52), (800 + 4 * 2 * 10 * 52 * 2, 0)),
    # K4: 13 bytes a record, [2, 16, 52, 2] int32 written
    (roofline.k4_work(2, 100, 16, 52), (2600 + 4 * 2 * 16 * 52 * 2, 0)),
    # K5: the histogram, two [3, 52] masks of bytes, three [3, 10] answers
    (roofline.k5_work(10, 52, 3, 4), (4 * 10 * 52 * 2 + 2 * 3 * 52
                                      + 12 * 3 * 10,
                                      2 * 520 + 2 * 4 * 10 + 30)),
    # K6: draws read, sites written, the CDF read; 17 levels of 120,000
    (roofline.k6_work(1000, 120_000), (8000 + 480_000, 17_000)),
    # K7: the histogram read, three [10, 52] outputs written
    (roofline.k7_work(10, 52), (20 * 520, 3 * 520)),
])
def test_work_counts(work, want):
    assert work == want


def test_mask_runs():
    assert roofline.mask_runs([[1, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1]]) == 3


def test_share_and_what_bounds_it():
    # 3.35e9 bytes is 1 ms at the card's rate: 2 ms of kernel time is 50%
    assert roofline.share(3.35e9, 0, 2e-3) == pytest.approx(
        {"value": 50.0, "bound_by": "bytes"})
    got = roofline.share(1, 67e9, 4e-3)
    assert got["bound_by"] == "operations"
    assert got["value"] == pytest.approx(25.0)
    assert roofline.share(1e9, 0, 0.0) is None


def test_padded_sites():
    cfg = {"nodes": 8, "malgen": {"num_sites": 100_001}}
    assert roofline.padded_sites(cfg) == 100_008
