"""The comparison that decides ``correct`` has to fail: the control (the
reference a precision lower, in the program's place), and a run whose
timed path is broken underneath, once for each fault a cell can have."""

import pytest
import torch

from malbench import check, harness

BATCH = ["malstone-b10-sphere.batch", "malstone-b10-mapreduce.batch"]
SERVE = ["malstone-b10-sphere.serve", "malstone-b10-mapreduce.serve"]


@pytest.mark.parametrize("cell", BATCH + SERVE)
def test_control_is_not_correct(cell, tiny_cell):
    resolved = tiny_cell(cell)
    run = harness.Run(resolved, 2**31 + 21, 0.3, False, "cpu", 0.0)
    if resolved["traffic"]["kind"] == "batch":
        run.counters["jobs"] = 1
        numbers = check.batch_checks(run, check.control_outputs(run))
    else:
        numbers = check.serve_checks(run, check.control_outputs(run))
    assert numbers["rho_bits_differing"] > 0, numbers


def _state_unchanged(monkeypatch):
    from repro_torch.core import streaming

    fold = streaming._accumulate_chunk
    calls = [0]

    def skipping(carry, chunk, *args, **kwargs):
        calls[0] += 1
        if calls[0] % 3 == 2:      # one step returns its state unchanged
            return carry
        return fold(carry, chunk, *args, **kwargs)

    monkeypatch.setattr(streaming, "_accumulate_chunk", skipping)


def _half_left_out(monkeypatch):
    from repro_torch.core import streaming

    fold = streaming._accumulate_chunk

    def halved(carry, chunk, *args, **kwargs):
        half = chunk.map(lambda c: c[:, : c.shape[1] // 2].contiguous())
        return fold(carry, half, *args, **kwargs)

    monkeypatch.setattr(streaming, "_accumulate_chunk", halved)


def _exchange_left_out(monkeypatch):
    from repro_torch.common import nodes

    def own_block(x, group=None):
        p = x.shape[0]
        blocks = x.reshape(p, p, x.shape[1] // p, *x.shape[2:])
        return blocks[torch.arange(p), torch.arange(p)]

    monkeypatch.setattr(nodes, "all_to_all", lambda b, group=None: b)
    monkeypatch.setattr(nodes, "psum_scatter", own_block)


def _answer_altered(monkeypatch):
    from repro_torch.core import runner
    from repro_torch.serve import engine

    finalize, query = runner._finalize, engine.batched_query

    def finalize_altered(hist, statistic):
        out = finalize(hist, statistic)
        out.rho.view(-1)[7] += 1.0
        return out

    def query_altered(*args, **kwargs):
        out = query(*args, **kwargs)
        out[1][0, 7] += 1
        return out

    monkeypatch.setattr(runner, "_finalize", finalize_altered)
    monkeypatch.setattr(engine, "batched_query", query_altered)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "exchange_left_out": _exchange_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", BATCH + SERVE)
def test_broken_timed_path_is_not_correct(cell, fault, tiny_cell,
                                          monkeypatch):
    """The harness's whole run, its look for a card skipped, with the
    program broken underneath the timed path."""
    FAULTS[fault](monkeypatch)
    result = harness.execute(tiny_cell(cell), 2**31 + 31, 0.3, False, "cpu",
                             0.0)
    assert result["correct"] is False, result["checks"]
