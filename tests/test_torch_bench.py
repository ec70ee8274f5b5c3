"""The port's bench subsystem against the JAX package's (``tests/test_bench.py``
mirrored):

- the timing protocol's accounting;
- the schema: round trip, the validator's refusals, and documents of either
  package passing the other's validator;
- compare: the same report from both packages on the same pair of
  documents, and the CLI's exit codes 0 / 1 / 2;
- the registry: JAX's scenario names minus the three the port does not
  register yet, with equal groups and params; the kernel pairs' inputs;
  the smoke selection; every scenario callable on the CPU at a tiny scale;
  the overlap pair's shared measurement and JAX's derived keys;
- the run CLI writing a valid document.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.bench import compare as jax_compare
from repro.bench import registry as jax_registry
from repro.bench import schema as jax_schema
from repro_torch.bench import compare, registry, schema
from repro_torch.bench.run import run_scenarios
from repro_torch.bench.timing import TimingResult, time_callable
from repro_torch.kernels import launch_counts, reset_launch_counts

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = registry.Scale(records_per_node=512, num_sites=64, num_entities=256,
                      chunk_records=256, warmup=1, iters=1)
# JAX scenarios whose module the port does not have yet (ROADMAP.md
# Queue 1 item 7, the multi-process launcher)
UNREGISTERED = {
    "sweep_multiproc_p1", "sweep_multiproc_p2", "sweep_multiproc_p4",
}


# ------------------------------------------------------------------- timing
def test_timing_sample_accounting():
    calls = []
    timing, out = time_callable(lambda: calls.append(0) or 7,
                                warmup=2, iters=4)
    assert out == 7
    assert timing.iters == 4 and len(timing.samples_us) == 4
    assert 2 <= timing.warmup_iters <= 8
    assert len(calls) == timing.warmup_iters + timing.iters
    assert timing.us_min <= timing.us_per_call <= max(timing.samples_us)
    assert timing.us_min > 0
    with pytest.raises(ValueError):
        time_callable(lambda: 1, iters=0)
    d = timing.as_dict()
    assert isinstance(d["samples_us"], list) and isinstance(d["steady"], bool)


def test_timing_max_warmup_and_on_sample():
    calls, seen = [], []
    timing, _ = time_callable(lambda: calls.append(0), warmup=1, iters=3,
                              max_warmup=1, on_sample=lambda i, us:
                              seen.append((i, us)))
    assert timing.warmup_iters == 1 and not timing.steady
    assert len(calls) == 4
    assert [i for i, _ in seen] == [0, 1, 2]
    assert [us for _, us in seen] == list(timing.samples_us)


# ------------------------------------------------------------------- schema
def _fake_timing(us: float) -> TimingResult:
    return TimingResult(us_per_call=us, us_min=us * 0.9, us_mean=us,
                        us_std=0.0, rel_dispersion=0.0, samples_us=(us,),
                        warmup_iters=1, iters=1, steady=True)


def _fake_doc(name="unit", scenarios=("s1", "s2"), us=100.0):
    doc = schema.new_document(name, device="cpu")
    for s in scenarios:
        schema.add_result(doc, s, {"backend": "streams"}, _fake_timing(us),
                          records=1000)
    return doc


def _jax_doc(name="jax", scenarios=("s1", "s2"), us=100.0):
    doc = jax_schema.new_document(name, preset="smoke")
    for s in scenarios:
        jax_schema.add_result(
            doc, s, {"backend": "streams"},
            jax_registry.TimingResult(**_fake_timing(us).__dict__),
            records=1000, derived={"latency_percentiles":
                                   jax_schema.latency_percentiles([us])})
    return doc


def test_schema_round_trip(tmp_path):
    doc = _fake_doc()
    assert doc["platform"] == "cpu" and doc["device_count"] == 1
    path = schema.write_document(doc, path=tmp_path / "BENCH_unit.json")
    loaded = schema.load_document(path)
    assert loaded == json.loads(json.dumps(doc))
    schema.validate_document(loaded)
    assert schema.results_by_scenario(loaded)["s2"]["records"] == 1000
    assert schema.bench_path("x", tmp_path) == tmp_path / "BENCH_x.json"
    assert schema.bench_path("x") == ROOT / "BENCH_x.json"


def test_schema_derived_units():
    doc = _fake_doc(us=1e6)
    assert doc["results"][0]["records_per_s"] == pytest.approx(1000.0)


def test_new_document_records_the_device_the_run_used(monkeypatch):
    """A CPU run on a machine that has a card says "cpu", as the JAX
    package's ``jax.default_backend()`` would."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    doc = schema.new_document("unit", device=torch.device("cpu"),
                              preset="smoke")
    assert doc["platform"] == "cpu" and doc["device_count"] == 1
    assert doc["preset"] == "smoke"
    doc = schema.new_document("unit", device="cuda")
    assert doc["platform"] == "gpu" and doc["device_count"] == 4
    assert "preset" not in doc


@pytest.mark.parametrize("mutate, msg", [
    (lambda d: d.pop("git_sha"), "missing required key"),
    (lambda d: d.__setitem__("schema_version", 99), "schema_version"),
    (lambda d: d.__setitem__("device_count", 0), "device_count"),
    (lambda d: d.__setitem__("device_count", True), "bool"),
    (lambda d: d["results"][0].pop("us_per_call"), "missing required"),
    (lambda d: d["results"][0].__setitem__("iters", 3), "samples_us"),
    (lambda d: d["results"].append(dict(d["results"][0])), "duplicate"),
    (lambda d: d["results"][0].__setitem__("us_per_call", -1.0),
     "negative"),
    (lambda d: d["results"][0].__setitem__("samples_us", [-1.0]),
     "samples_us must be"),
    (lambda d: d["results"][0].__setitem__("records", 1.5), "records"),
    (lambda d: d["results"][0].__setitem__(
        "derived", {"latency_percentiles": {"p50": 2.0, "p95": 1.0,
                                            "p99": 3.0}}),
     "non-decreasing"),
    (lambda d: d["results"][0].__setitem__(
        "derived", {"latency_percentiles": {"p50": 1.0, "p95": 2.0}}),
     "missing 'p99'"),
    (lambda d: d["results"][0].__setitem__(
        "derived", {"latency_percentiles": {"p50": 1.0, "p95": 2.0,
                                            "p99": 3.0, "p42": 1.5}}),
     "unknown latency percentile"),
    (lambda d: d["results"][0].__setitem__(
        "derived", {"latency_percentiles": {"p50": -1.0, "p95": 2.0,
                                            "p99": 3.0}}),
     ">= 0"),
    (lambda d: d["results"][0].__setitem__(
        "derived", {"latency_percentiles": [1.0, 2.0, 3.0]}),
     "must be a dict"),
])
def test_validator_rejects_what_jax_rejects(mutate, msg):
    doc = json.loads(json.dumps(_fake_doc()))
    mutate(doc)
    with pytest.raises(schema.BenchSchemaError, match=msg):
        schema.validate_document(doc)
    with pytest.raises(jax_schema.BenchSchemaError, match=msg):
        jax_schema.validate_document(doc)


def test_latency_percentiles_helper_matches_jax():
    for samples in ([0.0, 100.0], [10.0, 20.0, 30.0], [7.5],
                    [5.0, 1.0, 3.0, 9.0, 2.0]):
        assert schema.latency_percentiles(samples) \
            == jax_schema.latency_percentiles(samples)
    with pytest.raises(ValueError):
        schema.latency_percentiles([])


def test_load_rejects_garbage(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    with pytest.raises(schema.BenchSchemaError):
        schema.load_document(p)
    with pytest.raises(schema.BenchSchemaError):
        schema.load_document(tmp_path / "absent.json")


def test_documents_pass_both_validators(tmp_path, cpu_ctx):
    """A document of either package, the port's from real scenario rows,
    passes the other package's validator and loader."""
    port = schema.new_document("torch_unit", device="cpu", preset="smoke")
    run_scenarios(["kernel_windowed_ratio_pallas", "serving_query_batch"],
                  TINY, cpu_ctx, port, verbose=False)
    for doc in (port, _jax_doc()):
        for mod in (schema, jax_schema):
            path = tmp_path / f"BENCH_{doc['name']}_{mod.__name__}.json"
            path.write_text(json.dumps(doc))
            jax_schema.load_document(path)
            schema.load_document(path)
            mod.validate_document(doc)


# ------------------------------------------------------------------ compare
def _write(tmp_path, name, make=_fake_doc, **kw):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(make(name=name, **kw)))
    return str(path)


@pytest.mark.parametrize("base_kw, cur_kw, args, code", [
    ({"us": 100.0}, {"us": 100.0}, ["--tolerance", "0.15"], 0),
    ({"us": 100.0}, {"us": 200.0}, ["--tolerance", "0.15"], 1),
    ({"us": 200.0}, {"us": 100.0}, ["--tolerance", "0.15"], 0),
    ({"us": 100.0}, {"us": 110.0}, ["--tolerance", "0.15"], 0),
    ({"us": 100.0}, {"us": 110.0}, ["--tolerance", "0.05"], 1),
    ({"scenarios": ("s1", "s2", "s3")}, {"scenarios": ("s1", "s2")}, [], 2),
    ({"scenarios": ("s1", "s2", "s3")}, {"scenarios": ("s1", "s2")},
     ["--allow-missing"], 0),
    ({"scenarios": ("s1", "s2")}, {"scenarios": ("s1", "s2", "s3")}, [], 0),
])
def test_compare_exit_codes_match_jax(tmp_path, base_kw, cur_kw, args, code):
    """The port's CLI gives the documented code on port documents and on
    a JAX baseline against a port run; the JAX CLI gives the same."""
    base = _write(tmp_path, "base", **base_kw)
    cur = _write(tmp_path, "cur", **cur_kw)
    jax_base = _write(tmp_path, "jax_base", make=_jax_doc, **base_kw)
    assert compare.main([base, cur, *args]) == code
    assert compare.main([jax_base, cur, *args]) == code
    assert jax_compare.main([jax_base, cur, *args]) == code


def test_compare_invalid_document_exits_2(tmp_path):
    base = _write(tmp_path, "base")
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert compare.main([base, str(bad)]) == 2
    assert compare.main([base, str(tmp_path / "absent.json")]) == 2


@pytest.mark.parametrize("tolerance", (0.15, 5.0))
@pytest.mark.parametrize("metric", compare.METRICS)
def test_compare_report_equals_jax(tolerance, metric):
    base = _jax_doc(scenarios=("s1", "s2", "s3"), us=100.0)
    cur = _fake_doc(scenarios=("s1", "s2", "s4"), us=300.0)
    cur["results"][1]["us_per_call"] = cur["results"][1]["us_min"] = 10.0
    cur["results"][1]["us_mean"] = 10.0
    cur["results"][0]["steady"] = False
    for kw in ({}, {"allow_missing": True}):
        got = compare.compare_documents(base, cur, tolerance=tolerance,
                                        metric=metric, **kw)
        want = jax_compare.compare_documents(base, cur, tolerance=tolerance,
                                             metric=metric, **kw)
        assert got == want
        assert compare.format_report(got) == jax_compare.format_report(want)
    # s1 is 3x slower: a regression at 15%, not at 500%
    assert got["status"] == ("regression" if tolerance < 2 else "ok")
    assert got["missing"] == ["s3"] and got["new_scenarios"] == ["s4"]
    with pytest.raises(ValueError):
        compare.compare_documents(base, cur, metric="us_max")


# ----------------------------------------------------------------- registry
@pytest.fixture(scope="module")
def cpu_ctx():
    """One context for the module, so the scenarios share logs, seeds and
    services."""
    return registry.BenchContext(nodes=2, device="cpu")


def test_scenarios_are_jax_minus_the_unregistered():
    want = set(jax_registry.SCENARIOS) - UNREGISTERED
    assert len(jax_registry.SCENARIOS) == 69
    assert UNREGISTERED <= set(jax_registry.SCENARIOS)
    assert set(registry.SCENARIOS) == want and len(want) == 66
    for name, sc in registry.SCENARIOS.items():
        jsc = jax_registry.SCENARIOS[name]
        assert (sc.group, sc.params) == (jsc.group, jsc.params), name
    assert list(registry.SCENARIOS) == [
        n for n in jax_registry.SCENARIOS if n in want]


def test_presets_equal_jax():
    assert registry.PRESETS.keys() == jax_registry.PRESETS.keys()
    for name, scale in registry.PRESETS.items():
        assert scale.as_params() == jax_registry.PRESETS[name].as_params()


def test_smoke_selection_is_jax_minus_the_unregistered():
    jax_smoke = jax_registry.preset_scenario_names("smoke")
    smoke = registry.preset_scenario_names("smoke")
    assert len(jax_smoke) == 47
    assert len(set(jax_smoke) & UNREGISTERED) == 2
    assert smoke == [n for n in jax_smoke if n not in UNREGISTERED]
    assert len(smoke) == 45
    assert {"streaming_overlap_on", "streaming_overlap_off"} <= set(smoke)
    assert registry.preset_scenario_names("full") == list(registry.SCENARIOS)
    with pytest.raises(ValueError):
        registry.preset_scenario_names("nope")
    with pytest.raises(KeyError):
        list(registry.iter_scenarios(["nope"]))


@pytest.mark.parametrize("kernel", ("segment_hist", "windowed_ratio"))
def test_kernel_inputs_equal_jax(kernel):
    got = registry._kernel_inputs(TINY, kernel, "cpu")
    want = jax_registry._kernel_inputs(TINY, kernel)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().reshape(b.shape),
                                      b.astype(a.numpy().dtype))


def test_powerlaw_kernel_inputs():
    u, cdf = registry._kernel_inputs(TINY, "powerlaw_sample", "cpu")
    assert u.shape == (TINY.records_per_node,) and u.dtype == torch.float32
    assert ((u >= 0) & (u < 1)).all()
    assert cdf.shape == (TINY.num_sites,) and cdf[-1] == 1.0


@pytest.mark.parametrize("name", list(registry.SCENARIOS))
def test_every_scenario_runs_on_the_cpu(name, cpu_ctx):
    sc = registry.SCENARIOS[name]
    reset_launch_counts()
    res = sc.run(TINY, cpu_ctx)
    assert set(launch_counts().values()) == {0}      # CPU tensors
    assert res.timing.us_per_call > 0
    assert res.timing.iters == len(res.timing.samples_us)
    nodes = (res.effective or {}).get("nodes", cpu_ctx.nodes)
    rpn = (res.effective or {}).get("records_per_node",
                                    TINY.records_per_node)
    if sc.group in ("malstone", "lossless", "e2e") or (
            sc.group == "sweep"):
        assert res.records == nodes * rpn
        if sc.params.get("sweep") == "records_per_node":
            assert rpn == TINY.records_per_node * sc.params["multiplier"]
        if sc.params.get("sweep") in ("mesh_size", "gen_device_mesh"):
            assert nodes == sc.params["nodes"]
    elif sc.group == "kernel":
        assert res.records == (TINY.num_sites
                               if sc.params["kernel"] == "windowed_ratio"
                               else TINY.records_per_node)
    if sc.group == "lossless":
        assert res.derived["shuffle_overflow"] == 0
        assert res.derived["shuffle_rounds"] >= 1


def test_kernel_pairs_compute_the_same_function():
    for kernel in registry.KERNELS:
        args = registry._kernel_inputs(TINY, kernel, "cpu")
        fast, plain = registry.kernel_fns(kernel, TINY)
        got, want = fast(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), kernel


def test_packed_scenario_derived_bytes(cpu_ctx):
    """The word and 4-column exchanges at one factor: the same rounds,
    17/4 times the bytes for the columns."""
    packed = registry.SCENARIOS["mapreduce_packed_cf0p5"].run(TINY, cpu_ctx)
    counting = registry.SCENARIOS["mapreduce_counting_cf0p5"].run(
        TINY, cpu_ctx)
    columns = registry.SCENARIOS["mapreduce_lossless_cf0p5"].run(
        TINY, cpu_ctx)
    assert packed.derived["shuffle_packed"] is True
    assert counting.derived["shuffle_impl"] == "counting"
    assert columns.derived["shuffle_packed"] is False
    for d in (packed.derived, counting.derived):
        assert d["shuffle_rounds"] == columns.derived["shuffle_rounds"]
        assert columns.derived["shuffle_bytes_exchanged"] \
            == d["shuffle_bytes_exchanged"] * 17 // 4


def test_overlap_pair_shares_one_measurement(cpu_ctx):
    """Both rows come from one runner and one interleaved measurement, at
    JAX's chunk size, with JAX's derived keys (its pair run at the same
    scale on one device)."""
    on = registry.SCENARIOS["streaming_overlap_on"].run(TINY, cpu_ctx)
    off = registry.SCENARIOS["streaming_overlap_off"].run(TINY, cpu_ctx)
    chunk = registry.OVERLAP_CHUNK_RECORDS
    num_chunks = cpu_ctx.nodes * TINY.records_per_node // chunk
    assert chunk == jax_registry.OVERLAP_CHUNK_RECORDS == 64
    assert (on.derived["overlap"], off.derived["overlap"]) == (True, False)
    for row in (on, off):
        assert row.records == num_chunks * chunk
        assert row.derived["num_chunks"] == num_chunks
        assert row.effective == {"nodes": cpu_ctx.nodes,
                                 "chunk_records": chunk}
        assert row.timing.iters == 15 and row.timing.steady
    for key in ("shuffle_rounds", "shuffle_overflow",
                "shuffle_bytes_exchanged"):
        assert on.derived[key] == off.derived[key]
    assert on.derived["shuffle_overflow"] == 0
    assert len(cpu_ctx._overlap) == len(cpu_ctx._overlap_timings) == 1

    jax_tiny = jax_registry.Scale(**TINY.as_params())
    jax_on = jax_registry.SCENARIOS["streaming_overlap_on"].run(
        jax_tiny, jax_registry.BenchContext(nodes=1))
    assert on.derived.keys() == jax_on.derived.keys()
    assert on.effective.keys() == jax_on.effective.keys()
    assert jax_on.effective["chunk_records"] == chunk


def test_serving_scenarios(cpu_ctx):
    ingest = registry.SCENARIOS["serving_ingest_latency"].run(TINY, cpu_ctx)
    assert ingest.records == cpu_ctx.nodes * TINY.chunk_records
    query = registry.SCENARIOS["serving_query_batch"].run(TINY, cpu_ctx)
    assert query.records == query.derived["batch_queries"] == 5
    pcts = query.derived["latency_percentiles"]
    assert 0 <= pcts["p50"] <= pcts["p95"] <= pcts["p99"]
    sustained = registry.SCENARIOS["serving_sustained_qps"].run(
        TINY, cpu_ctx)
    assert sustained.records == sustained.derived["batches"] * 5
    assert sustained.derived["queries_per_s"] > 0


def test_run_cli_writes_a_valid_document(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = tmp_path / "BENCH_torch_unit.json"
    names = ["kernel_powerlaw_sample_pallas", "kernel_powerlaw_sample_jnp",
             "malstone_b_mapreduce_oneshot", "malgen_encode"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--device", "cpu",
         "--preset", "smoke", "--out", str(out)]
        + [a for n in names for a in ("--scenario", n)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("name,us_per_call,derived")
    doc = schema.load_document(out)
    jax_schema.validate_document(doc)
    assert [r["scenario"] for r in doc["results"]] == names
    assert doc["platform"] == "cpu" and doc["preset"] == "smoke"
    assert doc["results"][2]["params"]["nodes"] == 2
    listing = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--list"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert listing.returncode == 0
    assert "(45/66)" in listing.stdout
