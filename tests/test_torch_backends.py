"""The port's four backends, its columns exchange and K4 against the JAX
package, exactly.

Equality is exact: integer histograms, the bits of ``rho`` for A, B and
B-fixed (one IEEE divide), and, for the mapreduce columns exchange, all
six ``ShuffleStats`` fields. The port's ``histogram_impl="kernel"`` is held
against JAX's Pallas ``segment_hist`` in interpret mode, ``"segment_sum"``
against JAX's ``segment_sum``.

- P = 1 runs in this process against a 1-device JAX mesh.
- P = 4 needs 4 JAX host devices, so the JAX side runs once per module in
  a subprocess: this file run as a script (``python
  tests/test_torch_backends.py IN.npz OUT.npz``) forces 4 devices,
  computes every P = 4 case and exchanges npz files with the tests.
"""

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

from repro.common.types import EventLog as JaxLog
from repro.common.types import ExchangePlan as JaxPlan
from repro.core import malstone_run as jax_malstone_run
from repro.core import malstone_run_partitioned as jax_run_partitioned
from repro.core import pad_log_to as jax_pad_log_to
from repro.core import spm as jax_spm
from repro.kernels.segment_hist.ops import segment_hist as jax_segment_hist
from repro.kernels.segment_hist.ops import (
    segment_hist_eventlog as jax_segment_hist_eventlog,
)
from repro.kernels.segment_hist.ref import segment_hist_ref as jax_hist_ref
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import generate_full_log, generate_sharded_log

HERE = pathlib.Path(__file__).resolve().parent
# 550 sites do not divide by 4 nodes: the site range pads to 552
KW = dict(num_sites=550, num_entities=3000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
P4, N_NODE = 4, 2048
N = P4 * N_NODE
COLS = ("site_id", "entity_id", "timestamp", "mark")
STATS = ("sent", "overflow", "capacity", "rounds", "residual",
         "bytes_exchanged")
STATISTICS = ("A", "B", "B-fixed")
# (case, backend, exchange impl, capacity factor)
CASES = (("streams", "streams", "auto", 2.0),
         ("sphere", "sphere", "auto", 2.0),
         ("combiner", "mapreduce_combiner", "auto", 2.0),
         ("columns_cf0.5", "mapreduce", "columns", 0.5),
         ("columns_cf2", "mapreduce", "columns", 2.0))
# (case, log) at P = 4: every backend on the padded log, and the columns
# exchange with every record on one site
P4_CASES = tuple((c, "padded") for c in CASES) + (
    (("columns_one_site", "mapreduce", "columns", 0.5), "one_site"),)
# the port's histogram_impl and the JAX one it is held against
IMPLS = {"segment_sum": "segment_sum", "kernel": "pallas"}


# ------------------------------------------------------------ JAX oracle
def _jax_results(log, backend, impl, cf, histogram_impl, mesh, *,
                 num_weeks=52, partitioned=False):
    """One JAX run (statistic B) and the A / B-fixed finalizers of the
    same histogram, as a dict of numpy arrays."""
    fn = jax_run_partitioned if partitioned else jax_malstone_run
    res, stats = fn(log, KW["num_sites"], mesh=mesh, backend=backend,
                    statistic="B", num_weeks=num_weeks,
                    plan=JaxPlan(impl=impl, capacity_factor=cf,
                                 histogram_impl=histogram_impl),
                    return_shuffle_stats=True)
    total, marked = np.asarray(res.total), np.asarray(res.marked)
    first = lambda c: np.concatenate([c[:, :1], np.diff(c, axis=1)], 1)
    hist = jnp.asarray(np.stack([first(total), first(marked)], -1))
    finals = {"A": jax_spm.malstone_a(hist), "B": res,
              "B-fixed": jax_spm.malstone_b_fixed_denominator(hist)}
    out = {f"{stat}/{f}": np.asarray(getattr(r, f))
           for stat, r in finals.items() for f in ("rho", "total", "marked")}
    if stats is not None:
        out.update({f"stats/{f}": np.asarray(int(getattr(stats, f)))
                    for f in STATS})
    return out


def _oracle_main(in_path, out_path):
    """The P = 4 JAX side: makes the JAX logs, runs every case, writes
    logs and results to ``out_path``."""
    assert jax.device_count() == P4, jax.devices()
    mesh = jax.make_mesh((P4,), ("data",))
    port = np.load(in_path)
    log, _ = generate_sharded_log(jax.random.key(31), JaxConfig(**KW), P4,
                                  N_NODE)
    log = log._replace(event_seq=None, shard_hash=None)
    logs = {
        "padded": jax_pad_log_to(jax.tree.map(lambda x: x[:N - 100], log),
                                 N),
        "one_site": log._replace(site_id=jnp.zeros_like(log.site_id)),
        "port_generated": JaxLog(*[jnp.asarray(port[c]) for c in COLS]),
    }
    out = {}
    for name, lg in logs.items():
        for c in COLS:
            out[f"log/{name}/{c}"] = np.asarray(getattr(lg, c))
        out[f"log/{name}/valid"] = np.asarray(
            lg.valid if lg.valid is not None else np.ones(N, bool))

    def store(prefix, results):
        out.update({f"{prefix}/{k}": v for k, v in results.items()})

    for (case, backend, impl, cf), name in P4_CASES:
        for h in IMPLS.values():
            store(f"{case}/{h}", _jax_results(logs[name], backend, impl, cf,
                                              h, mesh))
    for case, backend, impl, cf in CASES:
        store(f"generated/{case}", _jax_results(
            logs["port_generated"], backend, impl, cf, "pallas", mesh))
        store(f"partitioned/{case}", _jax_results(
            logs["padded"], backend, impl, cf, "pallas", mesh,
            partitioned=True))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
    sys.exit(0)

import torch  # noqa: E402

from repro_torch.common import nodes  # noqa: E402
from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.core import run  # noqa: E402
from repro_torch.core.backends import resolve_exchange_impl  # noqa: E402
from repro_torch.core.backends.sphere import owned_site_range  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels.segment_hist import (  # noqa: E402
    segment_hist,
    segment_hist_eventlog,
)
from repro_torch.launch import malstone as launcher  # noqa: E402
from repro_torch.malgen import (  # noqa: E402
    MalGenConfig,
    generate_shards_device,
    make_seed,
)

TCFG = MalGenConfig(**KW)
GEN_SEED = 9


def _assert_result(got, want, msg, prefix="", partitioned=False):
    """``want`` maps "<prefix>rho"/"total"/"marked" to numpy; rho by its
    bits. A partitioned result's ``[P, S/P, ...]`` blocks are joined in
    node order first."""
    for f in ("total", "marked", "rho"):
        g = getattr(got, f)
        if partitioned:
            g = g.reshape(-1, *g.shape[2:])
        w = np.asarray(want[prefix + f])
        if f == "rho":
            g, w = g.view(torch.int32), w.view(np.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{f} {msg}")


def _assert_stats(got, want, msg, prefix="stats/"):
    for f in STATS:
        assert int(getattr(got, f)) == int(want[prefix + f]), f"{f} ({msg})"


def _port_plan(impl, cf, histogram_impl):
    return ExchangePlan(impl=impl, capacity_factor=cf,
                        histogram_impl=histogram_impl)


def _check_case(source, want, prefix, backend, impl, cf, histogram_impl,
                nodes_, msg, **kw):
    """Every statistic of one port run against the JAX results."""
    for stat in STATISTICS:
        got, stats = run(source, nodes=nodes_, backend=backend,
                         statistic=stat,
                         plan=_port_plan(impl, cf, histogram_impl),
                         device="cpu", return_shuffle_stats=True, **kw)
        _assert_result(got, want, f"{msg}/{stat}", f"{prefix}{stat}/",
                       kw.get("partitioned", False))
        if backend == "mapreduce":
            _assert_stats(stats, want, msg, f"{prefix}stats/")
        else:
            assert stats is None
    return stats


def _torch_log(arrays, prefix=""):
    return EventLog(*[torch.from_numpy(np.array(arrays[prefix + c]))
                      for c in COLS],
                    valid=torch.from_numpy(np.array(arrays[prefix + "valid"])))


# ---------------------------------------------------------------- P = 1
@pytest.fixture(scope="module")
def p1():
    """A JAX log and the JAX results at P = 1 for every case and impl."""
    mesh = jax.make_mesh((1,), ("data",))
    log, _ = generate_full_log(jax.random.key(17), JaxConfig(**KW), N)
    log = log._replace(event_seq=None, shard_hash=None)
    want = {(case, h): _jax_results(log, backend, impl, cf, h, mesh)
            for case, backend, impl, cf in CASES for h in IMPLS.values()}
    want["auto65"] = _jax_results(log, "mapreduce", "auto", 0.5, "pallas",
                                  mesh, num_weeks=65)
    port_log = EventLog(*[torch.from_numpy(np.array(getattr(log, c)))
                          for c in COLS])
    return port_log, want


@pytest.mark.parametrize("histogram_impl", tuple(IMPLS))
@pytest.mark.parametrize("case,backend,impl,cf", CASES,
                         ids=[c[0] for c in CASES])
def test_p1_matches_jax(p1, case, backend, impl, cf, histogram_impl):
    log, want = p1
    stats = _check_case(log, want[case, IMPLS[histogram_impl]], "",
                        backend, impl, cf, histogram_impl, 1, case,
                        num_sites=KW["num_sites"])
    if case == "columns_cf0.5":
        assert stats.rounds > 1 and int(stats.residual) > 0


def test_auto_resolves_to_columns_at_65_weeks(p1):
    """The one-word projection holds 64 weeks: at 65, "auto" takes the
    columns exchange end to end (17-byte slots), as JAX does."""
    log, want = p1
    assert resolve_exchange_impl("auto", KW["num_sites"], 65) == "columns"
    assert resolve_exchange_impl("auto", KW["num_sites"], 64) == "counting"
    for stat in STATISTICS:
        got, stats = run(log, KW["num_sites"], nodes=1, backend="mapreduce",
                         statistic=stat, num_weeks=65,
                         plan=_port_plan("auto", 0.5, "kernel"),
                         device="cpu", return_shuffle_stats=True)
        assert got.rho.shape[-1] == 65 or stat == "A"
        _assert_result(got, want["auto65"], f"auto65/{stat}", f"{stat}/")
        _assert_stats(stats, want["auto65"], "auto65")
    assert int(stats.bytes_exchanged) == stats.rounds * stats.capacity * 17


# ---------------------------------------------------------------- P = 4
@pytest.fixture(scope="module")
def p4(tmp_path_factory):
    """Run the JAX side once: the port's CPU-generated log goes in, the
    JAX logs and all P = 4 results come out."""
    tmp = tmp_path_factory.mktemp("jax_backends_p4")
    seed = make_seed(GEN_SEED, TCFG, N, device="cpu")
    gen = generate_shards_device(seed, TCFG, P4, N_NODE, device="cpu")
    np.savez(tmp / "in.npz",
             **{c: getattr(gen, c).reshape(-1).numpy() for c in COLS})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE.parent),
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_backends.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        out = dict(f)
    return seed, out


@pytest.mark.parametrize("histogram_impl", tuple(IMPLS))
@pytest.mark.parametrize("case,log_name", P4_CASES,
                         ids=[c[0][0] for c in P4_CASES])
def test_p4_matches_jax(p4, case, log_name, histogram_impl):
    _, out = p4
    name, backend, impl, cf = case
    log = _torch_log(out, f"log/{log_name}/")
    stats = _check_case(log, out, f"{name}/{IMPLS[histogram_impl]}/",
                        backend, impl, cf, histogram_impl, P4, name,
                        num_sites=KW["num_sites"])
    if backend == "mapreduce":
        assert int(stats.sent) == int(log.valid.sum())
        assert stats.rounds > 1 or cf > 1
    if log_name == "one_site":
        assert stats.rounds == N_NODE // stats.capacity == 8


@pytest.mark.parametrize("case,backend,impl,cf", CASES,
                         ids=[c[0] for c in CASES])
def test_p4_generated_engine_matches_jax_on_its_log(p4, case, backend, impl,
                                                    cf):
    """The port generates on the CPU; JAX ran each backend one-shot on
    that log at P = 4; the port's fused generated driver must agree."""
    seed, out = p4
    _check_case(seed, out, f"generated/{case}/", backend, impl, cf,
                "kernel", P4, f"generated/{case}", engine="generated",
                cfg=TCFG, records_per_shard=N_NODE)


@pytest.mark.parametrize("case,backend,impl,cf", CASES,
                         ids=[c[0] for c in CASES])
def test_p4_partitioned_matches_jax(p4, case, backend, impl, cf):
    """The result stays split by contiguous site block: ``[P, 552/P,
    W]``, whose blocks joined in node order equal JAX's
    ``malstone_run_partitioned``, the padded sites included."""
    _, out = p4
    log = _torch_log(out, "log/padded/")
    _check_case(log, out, f"partitioned/{case}/", backend, impl, cf,
                "kernel", P4, f"partitioned/{case}",
                num_sites=KW["num_sites"], partitioned=True)
    got = run(log, KW["num_sites"], nodes=P4, backend=backend,
              partitioned=True, device="cpu")
    assert got.rho.shape == (P4, 552 // P4, 52)
    start, block = owned_site_range(P4 - 1, P4, 552)
    np.testing.assert_array_equal(
        got.total[-1].numpy(), out[f"partitioned/{case}/B/total"][start:])
    assert start + block == 552
    with pytest.raises(ValueError, match="partitioned"):
        run(log, KW["num_sites"], nodes=P4, backend=backend,
            partitioned=True, engine="generated", device="cpu")


# -------------------------------------------------------------- K4, plain
def _k4_columns(seed, rows, n, num_sites, num_weeks):
    """Int32 columns with invalid rows, sites below 0 and at num_sites or
    above, weeks out of range, and marks in {0, 1}."""
    rng = np.random.default_rng(seed)
    site = rng.integers(-3, num_sites + 3, size=(rows, n), dtype=np.int32)
    week = rng.integers(-2, num_weeks + 2, size=(rows, n), dtype=np.int32)
    mark = rng.integers(0, 2, size=(rows, n), dtype=np.int32)
    valid = rng.random((rows, n)) < 0.8
    return site, week, mark, valid


K4_CASES = {
    "edges": dict(rows=3, n=3000, num_sites=300, num_weeks=52),
    "one_site": dict(rows=2, n=2048, num_sites=40, num_weeks=52),
    "ragged_n": dict(rows=2, n=1000 + 37, num_sites=257, num_weeks=7),
    "one_record": dict(rows=1, n=1, num_sites=5, num_weeks=52),
    "wide_weeks": dict(rows=2, n=1500, num_sites=30, num_weeks=65),
}


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_plain_matches_pallas_kernel(case):
    """K4's wrapper on CPU tensors (its plain version), one row per node,
    against JAX's Pallas ``segment_hist`` in interpret mode on each row."""
    kw = K4_CASES[case]
    site, week, mark, valid = _k4_columns(list(K4_CASES).index(case),
                                          kw["rows"], kw["n"],
                                          kw["num_sites"], kw["num_weeks"])
    if case == "one_site":
        site[:] = kw["num_sites"] - 1
    if case == "one_record":
        site[:], week[:], mark[:], valid[:] = 2, 3, 1, True
    got = segment_hist(*(torch.from_numpy(x) for x in (site, week, mark,
                                                        valid)),
                       num_sites=kw["num_sites"], num_weeks=kw["num_weeks"])
    assert got.shape == (kw["rows"], kw["num_sites"], kw["num_weeks"], 2)
    for r in range(kw["rows"]):
        want = jax_segment_hist(
            jnp.asarray(site[r]), jnp.asarray(week[r]), jnp.asarray(mark[r]),
            jnp.asarray(valid[r]), num_sites=kw["num_sites"],
            num_weeks=kw["num_weeks"], interpret=True)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want),
                                      err_msg=f"{case} row {r}")
    assert got.sum() > 0


@pytest.mark.parametrize("site_offset", [0, 100, -7])
def test_k4_eventlog_site_offset_matches_pallas(site_offset):
    """``segment_hist_eventlog`` rebases sites by ``site_offset`` and
    buckets weeks from timestamps, as JAX's does."""
    rng = np.random.default_rng(site_offset + 50)
    n, num_sites = 1200, 90
    site = rng.integers(site_offset - 5, site_offset + num_sites + 5,
                        size=n).astype(np.int32)
    ts = rng.integers(-604_800, 60 * 604_800, size=n).astype(np.int32)
    mark = rng.integers(0, 2, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    got = segment_hist_eventlog(
        EventLog(torch.from_numpy(site[None]), torch.zeros(1, n, dtype=torch.int32),
                 torch.from_numpy(ts[None]), torch.from_numpy(mark[None]),
                 valid=torch.from_numpy(valid[None])),
        num_sites, 52, site_offset=site_offset)
    want = jax_segment_hist_eventlog(
        JaxLog(jnp.asarray(site), jnp.zeros(n, jnp.int32), jnp.asarray(ts),
               jnp.asarray(mark), valid=jnp.asarray(valid)),
        num_sites, 52, site_offset=site_offset, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_k4_counts_positive_marks_where_pallas_adds_the_value():
    """The mark quirk: JAX's Pallas ``_kernel`` adds the raw mark value,
    its ``segment_hist_ref`` and ``site_week_histogram`` count ``mark >
    0``. K4 and its plain version count ``mark > 0``; the two agree on
    marks in {0, 1}, the only ones MalGen makes."""
    site, week, _, valid = _k4_columns(3, 1, 2000, 64, 52)
    mark = np.random.default_rng(4).choice(
        np.array([-1, 0, 1, 2], np.int32), size=site.shape)
    got = segment_hist(*(torch.from_numpy(x) for x in (site, week, mark,
                                                        valid)),
                       num_sites=64, num_weeks=52)[0].numpy()
    args = [jnp.asarray(x[0]) for x in (site, week, mark, valid)]
    np.testing.assert_array_equal(got, np.asarray(jax_hist_ref(
        *args, num_sites=64, num_weeks=52)))
    pallas = np.asarray(jax_segment_hist(*args, num_sites=64, num_weeks=52,
                                         interpret=True))
    np.testing.assert_array_equal(got[..., 0], pallas[..., 0])
    ok = (valid[0] & (site[0] >= 0) & (site[0] < 64) & (week[0] >= 0)
          & (week[0] < 52))
    assert pallas[..., 1].sum() == mark[0][ok].sum()
    assert got[..., 1].sum() == (mark[0][ok] > 0).sum()
    assert pallas[..., 1].sum() != got[..., 1].sum()


def test_k4_wrapper_validates_inputs_and_never_launches_on_cpu():
    col = torch.zeros(2, 8, dtype=torch.int32)
    ok = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="int32"):
        segment_hist(col.long(), col, col, ok, num_sites=4)
    with pytest.raises(ValueError, match=r"\[P, n\]"):
        segment_hist(col, col[:1], col, ok, num_sites=4)
    with pytest.raises(ValueError, match="contiguous"):
        segment_hist(col.t().contiguous().t(), col, col, ok, num_sites=4)
    with pytest.raises(ValueError, match="num_sites"):
        segment_hist(col, col, col, ok, num_sites=0)
    with pytest.raises(ValueError, match="bool"):
        segment_hist(col, col, col, ok.int(), num_sites=4)
    reset_launch_counts()
    hist = segment_hist(col, col, col, ok, num_sites=4)
    assert int(hist[:, 0, 0, 0].sum()) == 16
    assert set(launch_counts().values()) == {0}


# ------------------------------------------------- collectives, launcher
def test_psum_scatter_and_all_gather_keep_contiguous_blocks():
    rng = np.random.default_rng(8)
    x = rng.integers(-2**31, 2**31, size=(4, 12, 3), dtype=np.int64)
    got = nodes.psum_scatter(torch.from_numpy(x.astype(np.int32)))
    want = x.sum(0).astype(np.int32).reshape(4, 3, 3)   # wraps as int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nodes.all_gather(got).numpy(),
                                  want.reshape(12, 3))
    with pytest.raises(ValueError, match="split"):
        nodes.psum_scatter(torch.zeros(4, 10, dtype=torch.int32))


@pytest.mark.parametrize("flags", [
    ("--backend", "streams"), ("--backend", "sphere"),
    ("--backend", "mapreduce_combiner"),
    ("--backend", "mapreduce", "--exchange-impl", "columns")])
def test_launcher_runs_every_backend_on_the_cpu(flags, capsys):
    launcher.main(["--device", "cpu", "--nodes", "2", "--records-per-node",
                   "2048", "--sites", "301", "--entities", "2048", "--runs",
                   "1", "--gen-device", "--capacity-factor", "0.5",
                   *flags])
    text = capsys.readouterr().out
    assert f"backend: {flags[1]}" in text
    assert f"[{flags[1]}, gen-device]" in text and "rho (301, 52)" in text
    assert ("impl=columns" in text and "overflow=0" in text) == (
        "columns" in flags)
