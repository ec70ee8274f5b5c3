"""The trace's reduction: busy time as the union of the device's
activity, idle gaps named by the innermost host span, kernel records by
name."""

import pytest

from malbench import trace

HOST = [("malbench.window", 0, 100), ("malbench.job", 0, 40),
        ("malbench.ingest", 40, 100), ("malbench.query.wait", 55, 90)]
DEV = [("a_kernel(int)", 10, 20), ("b_kernel(int)", 15, 30),
       ("a_kernel(int)", 50, 60), ("c_kernel(float)", 95, 120),
       ("a_kernel(int)", 150, 160)]


def test_busy_gaps_and_ops():
    r = trace.reduce(HOST, DEV)
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx(35e-9)
    assert r["breakdown"]["idle_gaps"] == [
        ["host: malbench.query.wait", pytest.approx(35e-9)],
        ["host: malbench.ingest", pytest.approx(20e-9)],
        ["host: malbench.job", pytest.approx(10e-9)]]
    assert r["idle_s_by_host_span"] == {
        "host: malbench.query.wait": pytest.approx(35e-9),
        "host: malbench.ingest": pytest.approx(20e-9),
        "host: malbench.job": pytest.approx(10e-9)}
    ops = r["ops"]
    assert ops["a_kernel(int)"]["count"] == 2
    assert ops["c_kernel(float)"]["seconds"] == pytest.approx(5e-9)
    assert r["breakdown"]["device_ops"][0][0] == "a_kernel(int)"
    assert trace.kernel_records(ops, "a_kernel(") == (2, pytest.approx(
        20e-9))


def test_one_window_span_required():
    with pytest.raises(RuntimeError):
        trace.reduce(HOST[1:], DEV)


def test_union():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 9)]) == [[1, 4], [5, 9]]
