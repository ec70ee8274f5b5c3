"""The port's query service against the JAX package, exactly.

- ``MalStoneService`` log-mode ingest of a JAX-made log equals JAX's
  ``MalStoneService(kernel_path="ref")``: snapshot histogram, every
  ``ShuffleStats`` field, the rho bits of A, B and B-fixed, and the query
  answers; all four backends, at P = 1 in this process and at P = 4
  through a subprocess (this file run as a script, ``python
  tests/test_torch_serve.py OUT.npz``, forces 4 JAX host devices).
- ``batched_query`` equals JAX's ``batched_query(kernel_path="pallas",
  interpret=True)`` called on a plain array (no mesh), in all six outputs,
  top-k order among ties included.
- The rest holds the port's service to its own streaming engine: uneven
  seed-mode schedules, reset, tickets, stats, validation, the CLI.
"""

import json
import os
import pathlib
import subprocess
import sys

if __name__ == "__main__":
    from repro.common.env import force_host_devices

    force_host_devices(4)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.common.types import ExchangePlan as JaxPlan
from repro.common.types import WindowSpec as JaxWindow
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import generate_chunked_log as jax_chunked_log
from repro.malgen import make_seed_streaming as jax_seed_streaming
from repro.serve import MalStoneService as JaxService
from repro.serve import QuerySpec as JaxSpec
from repro.serve import batched_query as jax_batched_query
from repro.serve import default_query_mix as jax_default_mix
from repro.serve import encode_query_batch as jax_encode
from repro.serve import growing_window_specs as jax_growing

HERE = pathlib.Path(__file__).resolve().parent
KW = dict(num_sites=301, num_entities=1000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
JCFG = JaxConfig(**KW)
KEY, NUM_CHUNKS, CHUNK = 17, 8, 512
N_LOG = NUM_CHUNKS * CHUNK - 300
SERVE_CHUNK = 256
P4 = 4
COLS = ("site_id", "entity_id", "timestamp", "mark")
STATS = ("sent", "overflow", "capacity", "rounds", "residual",
         "bytes_exchanged")
STATISTICS = ("A", "B", "B-fixed")
BACKENDS = ("streams", "sphere", "mapreduce", "mapreduce_combiner")
CF = 0.5


def _jax_log():
    seed = jax_seed_streaming(jax.random.key(KEY), JCFG, NUM_CHUNKS, CHUNK)
    log = jax_chunked_log(seed, JCFG, NUM_CHUNKS, CHUNK)
    return jax.tree.map(lambda x: x[:N_LOG], log)


def _query_specs(spec_cls, window_cls, default_mix, growing):
    """The default mix, every 13th growing window and a few partial
    windows of every statistic, built from one package's classes."""
    year = 31_536_000
    week = 604_800
    extra = [spec_cls(statistic=s, window=window_cls(
                 week * 3, week * 20, week * 5, week * 30 + 7),
                 top_k=12, site=17)
             for s in ("A", "B", "B-fixed")]
    return (list(default_mix(num_sites=KW["num_sites"], top_k=8))
            + list(growing("B"))[12::13] + extra
            + [spec_cls(statistic="A", window=window_cls(0, year, year - 5,
                                                         year))])


def _jax_service(log, backend, mesh):
    """JAX's service over the log (the ``ref`` query path): its snapshot,
    stats, the three statistics and the query answers."""
    svc = JaxService(mesh=mesh, num_sites=KW["num_sites"],
                     chunk_records=SERVE_CHUNK, backend=backend,
                     kernel_path="ref",
                     plan=JaxPlan(impl="counting", capacity_factor=CF))
    steps = svc.ingest_log(log)
    hist, stats = svc.snapshot()
    out = {"hist": np.asarray(hist), "steps": np.asarray(steps)}
    if stats is not None:
        out.update({f"stats/{f}": np.asarray(int(getattr(stats, f)))
                    for f in STATS})
    for stat in STATISTICS:
        out[f"{stat}/rho"] = np.asarray(svc.result(stat).rho)
    answers = svc.query(_query_specs(JaxSpec, JaxWindow, jax_default_mix,
                                     jax_growing))
    for i, a in enumerate(answers):
        for f in ("rho", "num", "den", "top_sites", "top_rho",
                  "site_total", "site_marked"):
            if getattr(a, f) is not None:
                out[f"answer{i}/{f}"] = np.asarray(getattr(a, f))
    return out


def _oracle_main(out_path):
    assert jax.device_count() == P4, jax.devices()
    mesh = jax.make_mesh((P4,), ("data",))
    log = _jax_log()
    out = {}
    for backend in BACKENDS:
        out.update({f"{backend}/{k}": v for k, v in
                    _jax_service(log, backend, mesh).items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    _oracle_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.common.types import WindowSpec  # noqa: E402
from repro_torch.core import run  # noqa: E402
from repro_torch.malgen import MalGenConfig, make_seed_streaming  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MalStoneService,
    QuerySpec,
    batched_query,
    decode_answers,
    default_query_mix,
    encode_query_batch,
    growing_window_specs,
    ingest_slices,
    query_masks,
)

TCFG = MalGenConfig(**KW)
PLAN = ExchangePlan(impl="counting", capacity_factor=CF)


def _port_log(jlog):
    return EventLog(*[torch.from_numpy(np.array(getattr(jlog, c)))
                      for c in COLS])


def _port_specs():
    return _query_specs(QuerySpec, WindowSpec, default_query_mix,
                        growing_window_specs)


def _assert_bits(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    view = np.int32 if got.dtype.itemsize == 4 else got.dtype
    np.testing.assert_array_equal(got.view(view), want.view(view),
                                  err_msg=msg)


def _check_service(svc, want, msg):
    hist, stats = svc.snapshot()
    _assert_bits(hist.numpy(), want["hist"], f"hist {msg}")
    if svc.backend == "mapreduce":
        for f in STATS:
            assert int(getattr(stats, f)) == int(want[f"stats/{f}"]), \
                f"ShuffleStats.{f} {msg}"
        assert stats.rounds > 1, "want a chunk that needs several rounds"
    else:
        assert stats is None
    for stat in STATISTICS:
        _assert_bits(svc.result(stat).rho.numpy(), want[f"{stat}/rho"],
                     f"{stat} {msg}")
    answers = svc.query(_port_specs())
    for i, a in enumerate(answers):
        for f in ("rho", "num", "den", "top_sites", "top_rho",
                  "site_total", "site_marked"):
            key = f"answer{i}/{f}"
            if getattr(a, f) is None:
                assert key not in want, key
            else:
                _assert_bits(getattr(a, f), want[key], f"{key} {msg}")


@pytest.fixture(scope="module")
def p1():
    mesh = jax.make_mesh((1,), ("data",))
    log = _jax_log()
    return _port_log(log), {b: _jax_service(log, b, mesh) for b in BACKENDS}


@pytest.fixture(scope="module")
def p4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_serve_p4")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE.parent),
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_serve.py"),
         str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        out = dict(f)
    return _port_log(_jax_log()), out


def _service(nodes, backend, **kw):
    return MalStoneService(nodes=nodes, num_sites=KW["num_sites"],
                           chunk_records=SERVE_CHUNK, backend=backend,
                           plan=PLAN, device="cpu", **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_log_ingest_matches_jax_service_p1(p1, backend):
    log, want = p1
    svc = _service(1, backend)
    assert svc.ingest_log(log) == int(want[backend]["steps"])
    _check_service(svc, want[backend], f"{backend} P=1")


@pytest.mark.parametrize("backend", BACKENDS)
def test_log_ingest_matches_jax_service_p4(p4, backend):
    log, out = p4
    want = {k.split("/", 1)[1]: v for k, v in out.items()
            if k.startswith(backend + "/")}
    svc = _service(P4, backend)
    assert svc.ingest_log(log) == int(want["steps"])
    _check_service(svc, want, f"{backend} P=4")


# ----------------------------------------------------------- batched_query
def _tie_heavy_hist(seed, s=700, w=52):
    """Counts of 0-2, so many sites share rho exactly (0, 1/2, 1, ...)."""
    rng = np.random.default_rng(seed)
    total = rng.integers(0, 3, size=(s, w), dtype=np.int32)
    marked = np.minimum(total, rng.integers(0, 2, size=(s, w),
                                            dtype=np.int32))
    return np.stack([total, marked], -1)


@pytest.mark.parametrize("top_k", (0, 1, 8, 300))
def test_batched_query_matches_the_jax_pallas_kernel(top_k):
    hist = _tie_heavy_hist(top_k)
    specs = _port_specs()
    batch = encode_query_batch(specs, 52, hist.shape[0])
    jbatch = jax_encode(_query_specs(JaxSpec, JaxWindow, jax_default_mix,
                                     jax_growing), 52, hist.shape[0])
    for f in ("num_masks", "den_masks", "sites"):
        np.testing.assert_array_equal(getattr(batch, f), getattr(jbatch, f))
    got = batched_query(torch.from_numpy(hist),
                        torch.from_numpy(batch.num_masks),
                        torch.from_numpy(batch.den_masks),
                        torch.from_numpy(batch.sites), max_top_k=top_k)
    want = jax_batched_query(jnp.asarray(hist),
                             jnp.asarray(batch.num_masks),
                             jnp.asarray(batch.den_masks),
                             jnp.asarray(batch.sites), max_top_k=top_k,
                             kernel_path="pallas", interpret=True)
    names = ("rho", "num", "den", "top_rho", "top_sites", "site_rows")
    for name, a, b in zip(names, got, want):
        _assert_bits(a.numpy(), np.asarray(b), name)
    if top_k == 300:
        rho = got[0].numpy()
        assert len(np.unique(rho[3])) < 300, "want ties inside the top-k"
    # the decoded answers are the rows of the outputs
    answers = decode_answers(batch, got)
    assert len(answers[3].top_sites) == min(specs[3].top_k, top_k)
    assert answers[4].site_rho == float(got[0][4, specs[4].site])
    for i, spec in enumerate(specs):
        nm, dm = query_masks(spec, 52)
        assert torch.equal(nm, torch.from_numpy(batch.num_masks[i]))
        assert torch.equal(dm, torch.from_numpy(batch.den_masks[i]))


def test_topk_breaks_ties_by_the_lower_site():
    hist = np.zeros((6, 52, 2), np.int32)
    hist[:, 0, 0] = (2, 1, 2, 1, 1, 1)
    hist[:, 0, 1] = (1, 1, 1, 1, 0, 1)           # rho .5, 1, .5, 1, 0, 1
    mask = np.ones((1, 52), bool)
    got = batched_query(torch.from_numpy(hist), torch.from_numpy(mask),
                        torch.from_numpy(mask),
                        torch.zeros(1, dtype=torch.int32), max_top_k=4)
    want = jax_batched_query(jnp.asarray(hist), jnp.asarray(mask),
                             jnp.asarray(mask), jnp.zeros(1, jnp.int32),
                             max_top_k=4, kernel_path="pallas",
                             interpret=True)
    assert got[4].tolist() == [[1, 3, 5, 0]] == np.asarray(want[4]).tolist()


# ------------------------------------------------- the service, on its own
@pytest.fixture(scope="module")
def stream():
    seed = make_seed_streaming(11, TCFG, 8, 256, device="cpu")
    want = {stat: run(seed, engine="streaming", nodes=2, cfg=TCFG,
                      num_chunks=8, chunk_records=256, backend="mapreduce",
                      statistic=stat, plan=PLAN, device="cpu",
                      return_shuffle_stats=True)
            for stat in STATISTICS}
    return seed, want


def _seed_service(seed, backend="mapreduce"):
    return MalStoneService(nodes=2, num_sites=KW["num_sites"],
                           chunk_records=256, backend=backend, seed=seed,
                           cfg=TCFG, num_chunks=8, plan=PLAN, device="cpu")


def _assert_like_streaming(svc, want):
    for stat in STATISTICS:
        ref, ref_stats = want[stat]
        got = svc.result(stat)
        assert torch.equal(got.total, ref.total), stat
        assert torch.equal(got.rho.view(torch.int32),
                           ref.rho.view(torch.int32)), stat
    _, stats = svc.snapshot()
    assert [int(x) for x in stats] == [int(x) for x in ref_stats]


@pytest.mark.parametrize("schedule", ([1, 1, 1, 1], [3, 1], [4], [1, 2, 1]))
def test_uneven_seed_schedules_equal_the_streaming_run(stream, schedule):
    seed, want = stream
    svc = _seed_service(seed)
    for k in schedule:
        svc.ingest_chunks(k)
    assert svc.chunks_folded == 4
    _assert_like_streaming(svc, want)
    assert svc.stats().ingest_calls == len(schedule)
    assert svc.stats().records_ingested == 8 * 256


def test_reset_and_reingest(stream):
    seed, want = stream
    svc = _seed_service(seed)
    svc.ingest_chunks(2)
    first = svc.result("B")
    svc.reset()
    assert svc.chunks_folded == 0 and svc.stats().records_ingested == 0
    assert int(svc.snapshot()[0].sum()) == 0
    svc.ingest_chunks(4)
    _assert_like_streaming(svc, want)
    assert not torch.equal(first.total, svc.result("B").total)


def test_queries_interleave_with_ingest(stream):
    seed, _ = stream
    svc = _seed_service(seed, "streams")
    svc.ingest_chunks(1)
    early = svc.query([QuerySpec("A")])[0]
    svc.ingest_chunks(1)
    late = svc.query([QuerySpec("A")])[0]
    assert (late.den >= early.den).all() and (late.den > early.den).any()
    np.testing.assert_array_equal(late.rho, svc.result("A").rho.numpy())


def test_submit_wait_out_of_order_and_stats(stream):
    seed, _ = stream
    svc = _seed_service(seed, "streams")
    svc.ingest_chunks(4)
    specs = [default_query_mix(num_sites=KW["num_sites"]),
             growing_window_specs(), [QuerySpec("B-fixed", site=3)]]
    tickets = [svc.submit(s) for s in specs]
    st = svc.stats()
    assert (st.batches_submitted, st.pending, st.queries_submitted) == (
        3, 3, sum(map(len, specs)))
    late = svc.wait(tickets[2])
    assert late[0].site_total.shape == (52,)
    with pytest.raises(KeyError, match="ticket"):
        svc.wait(tickets[2])
    rest = svc.wait_all()
    assert sorted(rest) == tickets[:2]
    assert len(rest[tickets[1]]) == 52
    b = svc.result("B").rho.numpy()
    for i, a in enumerate(rest[tickets[1]]):
        np.testing.assert_array_equal(a.rho.view(np.int32),
                                      b[:, i].view(np.int32))
    st = svc.stats()
    assert (st.batches_answered, st.queries_answered, st.pending) == (
        3, sum(map(len, specs)), 0)
    assert st.chunks_folded == 4
    zero = svc.zero_state_host()
    assert zero.chunks_folded == 0 and zero.carry.shape == (2, 302, 52, 2)


def test_ingest_slices_regroup_the_streaming_layout():
    log = _port_log(_jax_log())
    slices = list(ingest_slices(log, 2, 256))
    per_node = len(slices) * 256
    assert len(slices) == -(-N_LOG // 512)
    for d in range(2):
        node = torch.cat([s.site_id[d * 256:(d + 1) * 256] for s in slices])
        rows = log.site_id[d * per_node:(d + 1) * per_node]
        assert torch.equal(node[:len(rows)], rows)
    assert int(sum(s.valid.sum() for s in slices)) == N_LOG


def test_validation_errors(stream):
    seed, _ = stream
    with pytest.raises(ValueError, match="unknown streaming backend"):
        _service(2, "hadoop")
    with pytest.raises(ValueError, match="chunk_records"):
        MalStoneService(nodes=2, num_sites=10, chunk_records=0, device="cpu")
    with pytest.raises(ValueError, match="all of seed"):
        _service(2, "streams", seed=seed)
    with pytest.raises(ValueError, match="divide"):
        _service(2, "streams", seed=seed, cfg=TCFG, num_chunks=7)
    svc = _service(2, "streams")
    with pytest.raises(ValueError, match="seed-mode"):
        svc.ingest_chunks(1)
    with pytest.raises(ValueError, match="folds 512"):
        svc.ingest(EventLog(*[torch.zeros(100, dtype=torch.int32)
                              for _ in COLS]))
    svc = _seed_service(seed)
    with pytest.raises(ValueError, match="k must be"):
        svc.ingest_chunks(0)
    svc.ingest_chunks(3)
    with pytest.raises(ValueError, match="overruns"):
        svc.ingest_chunks(2)
    with pytest.raises(ValueError, match="unknown statistic"):
        QuerySpec("C")
    with pytest.raises(ValueError, match="top_k"):
        QuerySpec(top_k=-1)
    with pytest.raises(ValueError, match="site"):
        QuerySpec(site=-2)
    with pytest.raises(ValueError, match="at least one"):
        svc.submit([])
    with pytest.raises(ValueError, match="out of range"):
        svc.submit([QuerySpec(site=301)])
    with pytest.raises(ValueError, match="exceeds"):
        svc.submit([QuerySpec(top_k=302)])


def test_serve_launcher_checks_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"),
                                         env.get("PYTHONPATH", "")])
    bench = tmp_path / "BENCH_serve.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_malstone",
         "--device", "cpu", "--nodes", "2", "--ingest-chunks", "3",
         "--backend", "mapreduce", "--capacity-factor", "0.5",
         "--query-mix", "mixed", "--query-batches", "3", "--check",
         "--bench-json", str(bench)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=HERE.parent)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "check OK" in proc.stdout and "ShuffleStats" in proc.stdout
    assert "queries/s" in proc.stdout
    doc = json.loads(bench.read_text())
    assert [r["scenario"] for r in doc["results"]] == [
        "launch_serve_ingest_mapreduce", "launch_serve_query_mapreduce",
        "launch_serve_sustained_mapreduce"]
    pct = doc["results"][1]["derived"]["latency_percentiles"]
    assert pct["p50"] <= pct["p95"] <= pct["p99"]
