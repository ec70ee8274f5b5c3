"""``BENCHMARK.json`` against the benchmark's contract, and the files each
entry names; a configuration, a traffic mix and a metric added as new
files are found with no edit."""

import json
import re
import shutil

import pytest

from malbench import harness

ROOT = harness.ROOT
SPEC = harness.load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["malbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, cells // 4)


def test_names_units_and_keys():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    resolved = harness.resolve(SPEC, cell)
    assert resolved["config"]["name"] == resolved["cell"]["config"]
    assert resolved["traffic"]["kind"] in ("batch", "serve")
    e2e = {m["name"] for m in resolved["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert resolved["per_layer"]
    for m in resolved["end_to_end"] + resolved["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for m in resolved["per_layer"]:
        assert m["moves"] in e2e


def test_files_are_named_from_names():
    for path in (ROOT / "malbench").rglob("*"):
        if "__pycache__" in path.parts or not path.is_file():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_new_files_are_found_with_no_edit(tmp_path):
    """A later change adds a configuration, a mix and a metric as files and
    entries: the harness finds them by name."""
    shutil.copytree(ROOT / "malbench", tmp_path / "malbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "malbench"
    conf = json.loads((here / "configs/malstone-b10-sphere.json").read_text())
    conf["name"] = "malstone-b10-streams"
    conf["backend"] = "streams"
    (here / "configs/malstone-b10-streams.json").write_text(json.dumps(conf))
    mix = {"kind": "batch", "about": "a new mix"}
    (here / "traffic/batch-again.json").write_text(json.dumps(mix))
    (here / "metrics/jobs_done.py").write_text(
        "def read(run):\n    return {'value': run.counters['jobs']}\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0],
                                name="malstone-b10-streams",
                                file="malbench/configs/malstone-b10-streams"
                                     ".json"))
    spec["workloads"].append({"name": "malstone-b10-streams.batch",
                              "config": "malstone-b10-streams",
                              "traffic": "batch-again", "chips": 1,
                              "why": "streams"})
    rate = next(m for m in spec["end_to_end"]
                if m["name"] == "records_per_s")
    rate["workloads"].append("malstone-b10-streams.batch")
    spec["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "records_per_s"})
    resolved = harness.resolve(spec, "malstone-b10-streams.batch", here)
    assert resolved["config"]["backend"] == "streams"
    assert resolved["traffic"] == mix
    assert "jobs_done" in [m["name"] for m in resolved["per_layer"]]
    read = harness.reader("jobs_done", here)
    assert read(type("R", (), {"counters": {"jobs": 3}})()) == {"value": 3}
