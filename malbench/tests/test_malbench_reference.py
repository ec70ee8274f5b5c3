"""The plain reference against the port at a tiny size on the CPU: the
same seed tables, and every cell's run correct against it."""

import pytest
import torch

from malbench import harness
from malbench.reference import malgen

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def _port_seed(config, seed, chunks):
    from repro_torch.malgen import MalGenConfig, make_seed_streaming

    mg = config["malgen"]
    cfg = MalGenConfig(**{k: mg[k] for k in MalGenConfig._fields})
    return cfg, make_seed_streaming(seed, cfg, chunks,
                                    config["chunk_records"], device="cpu")


def test_site_draws_are_malgens_own(tiny_cell):
    config = tiny_cell("malstone-b10-sphere.batch")["config"]
    mg = config["malgen"]
    seed = 2**31 + 5
    _, port = _port_seed(config, seed, 1)
    perm, marked = malgen.site_draws(seed, mg, "cpu")
    sites = torch.arange(mg["num_sites"])
    assert torch.equal(torch.sort(perm).values, sites)
    assert marked.numel() == int(mg["num_sites"] * mg["marked_site_fraction"])
    assert torch.equal(torch.nonzero(port.marked_mask).flatten(),
                       torch.sort(marked).values)
    other, _ = malgen.site_draws(seed + 1, mg, "cpu")
    assert not torch.equal(perm, other)


def test_reference_tables_equal_the_ports_seed(tiny_cell):
    config = tiny_cell("malstone-b10-sphere.batch")["config"]
    mg = config["malgen"]
    chunks = config["nodes"] * config["steps"]
    seed = 2**31 + 77
    _, port = _port_seed(config, seed, chunks)
    ref = malgen.tables(seed, mg, chunks, config["chunk_records"], "cpu")
    assert torch.equal(ref.marked_cdf, port.marked_cdf)
    assert torch.equal(ref.unmarked_cdf, port.unmarked_cdf)
    assert torch.equal(ref.mark_time, port.entity_mark_time)


def test_reference_records_equal_the_ports_chunk(tiny_cell):
    from repro_torch.malgen import generate_chunk

    config = tiny_cell("malstone-b10-sphere.batch")["config"]
    mg = dict(config["malgen"], num_weeks=52)
    c, seed = config["chunk_records"], 2**31 + 78
    cfg, port_seed = _port_seed(config, seed, 4)
    tabs = malgen.tables(seed, mg, 4, c, "cpu")
    for chunk in range(4):
        log = generate_chunk(port_seed, cfg, chunk, c)
        site, week, mark = malgen.chunk_records_of(seed, mg, tabs, chunk, c)
        assert torch.equal(site, log.site_id.to(torch.int64))
        assert torch.equal(week, log.week().to(torch.int64))
        assert torch.equal(mark, log.mark.to(torch.int64))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_at_a_tiny_size(cell, tiny_cell):
    result = harness.execute(tiny_cell(cell), 2**31 + 101, 0.3, False, "cpu",
                             0.0)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
