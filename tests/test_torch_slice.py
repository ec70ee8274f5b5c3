"""The port's MapReduce slice against the JAX package, end to end.

Equality is exact: integer histograms, the bits of ``rho`` for A, B and
B-fixed (one IEEE divide), and all six ``ShuffleStats`` fields.

- P = 1 runs in this process against a 1-device JAX mesh.
- P = 4 needs 4 JAX host devices, which a process fixes when JAX first
  starts, so the JAX side runs once per module in a subprocess: this file
  run as a script (``python tests/test_torch_slice.py IN.npz OUT.npz``)
  forces 4 devices, computes every P = 4 case and exchanges npz files
  with the tests.
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

from repro.common.types import ExchangePlan as JaxPlan
from repro.common.types import EventLog as JaxLog
from repro.core import malstone_run as jax_malstone_run
from repro.core import pad_log_to as jax_pad_log_to
from repro.core import spm as jax_spm
from repro.core.backends import ShuffleExhaustedError as JaxExhausted
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import generate_full_log, generate_sharded_log

HERE = pathlib.Path(__file__).resolve().parent
KW = dict(num_sites=257, num_entities=700, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
N, P4 = 2048, 4
COLS = ("site_id", "entity_id", "timestamp", "mark")
STATS = ("sent", "overflow", "capacity", "rounds", "residual",
         "bytes_exchanged")
STATISTICS = ("A", "B", "B-fixed")
# (case, JAX log name, capacity factor); the round-cap case is separate
P4_CASES = (("powerlaw_cf0.5", "powerlaw", 0.5),
            ("powerlaw_cf2", "powerlaw", 2.0),
            ("one_site", "one_site", 0.5),
            ("padded", "padded", 0.5),
            ("generated", "port_generated", 1.0))


# ------------------------------------------------------------ JAX oracle
def _jax_results(log, plan, mesh, prefix, out):
    """One JAX run (statistic B) and the A / B-fixed finalizers of the
    same histogram, stored under ``prefix``."""
    res, stats = jax_malstone_run(log, KW["num_sites"], mesh=mesh,
                                  backend="mapreduce", statistic="B",
                                  plan=plan, return_shuffle_stats=True)
    total = np.asarray(res.total)
    marked = np.asarray(res.marked)
    first = lambda c: np.concatenate([c[:, :1], np.diff(c, axis=1)], 1)
    hist = jnp.asarray(np.stack([first(total), first(marked)], -1))
    finals = {"A": jax_spm.malstone_a(hist), "B": res,
              "B-fixed": jax_spm.malstone_b_fixed_denominator(hist)}
    for stat, r in finals.items():
        for f in ("rho", "total", "marked"):
            out[f"{prefix}/{stat}/{f}"] = np.asarray(getattr(r, f))
    for f in STATS:
        out[f"{prefix}/stats/{f}"] = np.asarray(int(getattr(stats, f)))


def _oracle_main(in_path, out_path):
    """The P = 4 JAX side: makes the JAX logs, runs every case, writes
    logs and results to ``out_path``."""
    assert jax.device_count() == P4, jax.devices()
    mesh = jax.make_mesh((P4,), ("data",))
    cfg = JaxConfig(**KW)
    port = np.load(in_path)
    log, _ = generate_sharded_log(jax.random.key(21), cfg, P4, N // P4)
    odd = jax.tree.map(lambda x: x[:N - 100], log)
    logs = {
        "powerlaw": log,
        "one_site": log._replace(site_id=jnp.zeros_like(log.site_id)),
        "padded": jax_pad_log_to(odd._replace(event_seq=None,
                                              shard_hash=None), N),
        "port_generated": JaxLog(*[jnp.asarray(port[c]) for c in COLS]),
    }
    out = {}
    for name, lg in logs.items():
        for c in COLS:
            out[f"log/{name}/{c}"] = np.asarray(getattr(lg, c))
        out[f"log/{name}/valid"] = np.asarray(
            lg.valid if lg.valid is not None else np.ones(N, bool))
    for case, name, cf in P4_CASES:
        _jax_results(logs[name], JaxPlan(impl="counting", capacity_factor=cf),
                     mesh, case, out)
    try:
        jax_malstone_run(logs["one_site"], KW["num_sites"], mesh=mesh,
                         backend="mapreduce",
                         plan=JaxPlan(capacity_factor=0.5,
                                      max_shuffle_rounds=1))
        out["round_cap_raised"] = np.asarray(False)
    except JaxExhausted:
        out["round_cap_raised"] = np.asarray(True)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
    sys.exit(0)

import torch  # noqa: E402

from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.core import (  # noqa: E402
    malstone_run,
    malstone_run_generated,
    run,
)
from repro_torch.core.backends import (  # noqa: E402
    ShuffleExhaustedError,
    resolve_exchange_impl,
)
from repro_torch.core.plan import expected_shuffle_rounds  # noqa: E402
from repro_torch.malgen import (  # noqa: E402
    MalGenConfig,
    generate_shards_device,
    make_seed,
)

TCFG = MalGenConfig(**KW)
PORT_PLANS = [ExchangePlan(impl=i, capacity_factor=0.5, histogram_impl=h)
              for i in ("counting", "sort") for h in ("kernel", "segment_sum")]
GEN_SEED, GEN_RPS = 5, N // P4


def _assert_result(got, want, msg):
    """``want`` maps "rho"/"total"/"marked" to numpy; rho by its bits."""
    np.testing.assert_array_equal(got.total.numpy(), want["total"],
                                  err_msg=f"total {msg}")
    np.testing.assert_array_equal(got.marked.numpy(), want["marked"],
                                  err_msg=f"marked {msg}")
    np.testing.assert_array_equal(got.rho.numpy().view(np.int32),
                                  np.asarray(want["rho"]).view(np.int32),
                                  err_msg=f"rho bits {msg}")


def _assert_stats(got, want, msg):
    for f in STATS:
        assert int(getattr(got, f)) == int(want[f]), f"{f} ({msg})"


def _torch_log(arrays, prefix=""):
    return EventLog(*[torch.from_numpy(np.array(arrays[prefix + c]))
                      for c in COLS],
                    valid=torch.from_numpy(np.array(arrays[prefix + "valid"]))
                    if prefix + "valid" in arrays else None)


# ---------------------------------------------------------------- P = 1
@pytest.fixture(scope="module")
def p1():
    """A JAX log, an all-on-one-site twin, and the JAX results at P = 1
    (statistic x log) with its stats."""
    mesh = jax.make_mesh((1,), ("data",))
    log, _ = generate_full_log(jax.random.key(13), JaxConfig(**KW), N)
    logs = {"powerlaw": log,
            "one_site": log._replace(site_id=jnp.zeros_like(log.site_id))}
    want = {}
    for name, lg in logs.items():
        for stat in STATISTICS:
            res, stats = jax_malstone_run(
                lg, KW["num_sites"], mesh=mesh, backend="mapreduce",
                statistic=stat, plan=JaxPlan(capacity_factor=0.5),
                return_shuffle_stats=True)
            want[name, stat] = (
                {f: np.asarray(getattr(res, f)) for f in res._fields},
                {f: int(getattr(stats, f)) for f in STATS})
    port_logs = {name: EventLog(*[torch.from_numpy(np.array(getattr(lg, c)))
                                  for c in COLS])
                 for name, lg in logs.items()}
    return port_logs, want


@pytest.mark.parametrize("plan", PORT_PLANS,
                         ids=lambda p: f"{p.impl}-{p.histogram_impl}")
@pytest.mark.parametrize("log_name", ("powerlaw", "one_site"))
def test_p1_matches_jax(p1, plan, log_name):
    port_logs, want = p1
    for stat in STATISTICS:
        got, stats = malstone_run(port_logs[log_name], KW["num_sites"],
                                  nodes=1, statistic=stat, plan=plan,
                                  device="cpu", return_shuffle_stats=True)
        res_want, stats_want = want[log_name, stat]
        _assert_result(got, res_want, f"{log_name}/{stat}")
        _assert_stats(stats, stats_want, f"{log_name}/{stat}")
    if log_name == "one_site":
        assert stats.rounds == 2


# ---------------------------------------------------------------- P = 4
@pytest.fixture(scope="module")
def p4(tmp_path_factory):
    """Run the JAX side once: the port's CPU-generated log goes in, the
    JAX logs and all P = 4 results come out."""
    tmp = tmp_path_factory.mktemp("jax_p4")
    seed = make_seed(GEN_SEED, TCFG, N, device="cpu")
    gen = generate_shards_device(seed, TCFG, P4, GEN_RPS, device="cpu")
    np.savez(tmp / "in.npz",
             **{c: getattr(gen, c).reshape(-1).numpy() for c in COLS})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE.parent),
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_slice.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        out = dict(f)
    return seed, out


def _case(out, case, stat):
    return {f: out[f"{case}/{stat}/{f}"] for f in ("rho", "total", "marked")}


@pytest.mark.parametrize("histogram_impl", ("kernel", "segment_sum"))
@pytest.mark.parametrize("case,log_name,cf", P4_CASES[:4])
def test_p4_matches_jax(p4, case, log_name, cf, histogram_impl):
    _, out = p4
    log = _torch_log(out, f"log/{log_name}/")
    plan = ExchangePlan(impl="counting", capacity_factor=cf,
                        histogram_impl=histogram_impl)
    for stat in STATISTICS:
        got, stats = malstone_run(log, KW["num_sites"], nodes=P4,
                                  statistic=stat, plan=plan, device="cpu",
                                  return_shuffle_stats=True)
        _assert_result(got, _case(out, case, stat), f"{case}/{stat}")
        _assert_stats(stats, {f: out[f"{case}/stats/{f}"] for f in STATS},
                      case)
    if log_name == "one_site":
        assert stats.rounds > 1
    if log_name == "padded":
        assert int(stats.sent) == N - 100


def test_p4_round_cap_raises_in_both(p4):
    _, out = p4
    assert bool(out["round_cap_raised"])
    log = _torch_log(out, "log/one_site/")
    with pytest.raises(ShuffleExhaustedError, match="undelivered"):
        malstone_run(log, KW["num_sites"], nodes=P4, device="cpu",
                     plan=ExchangePlan(capacity_factor=0.5,
                                       max_shuffle_rounds=1))


def test_p4_generated_engine_matches_jax_on_its_log(p4):
    """The port generates on the CPU; JAX ran its one-shot mapreduce on
    that log at P = 4; the port's fused generated driver must agree."""
    seed, out = p4
    case = "generated"
    for stat in STATISTICS:
        got, stats = run(seed, engine="generated", nodes=P4, cfg=TCFG,
                         records_per_shard=GEN_RPS, statistic=stat,
                         plan=ExchangePlan(capacity_factor=1.0,
                                           histogram_impl="kernel"),
                         device="cpu", return_shuffle_stats=True)
        _assert_result(got, _case(out, case, stat), f"{case}/{stat}")
        _assert_stats(stats, {f: out[f"{case}/stats/{f}"] for f in STATS},
                      case)
        got2 = malstone_run_generated(seed, TCFG, nodes=P4,
                                      records_per_shard=GEN_RPS,
                                      statistic=stat, device="cpu")
        _assert_result(got2, _case(out, case, stat), f"{case}/{stat}")


def test_expected_shuffle_rounds_bounds_the_loop(p4):
    _, out = p4
    log = _torch_log(out, "log/one_site/")
    plan = ExchangePlan(capacity_factor=0.5)
    _, stats = malstone_run(log, KW["num_sites"], nodes=P4, device="cpu",
                            plan=plan, return_shuffle_stats=True)
    assert stats.rounds == expected_shuffle_rounds(plan, N // P4, P4)


def test_plan_and_entry_point_contracts():
    assert ExchangePlan(impl="columns").impl == "columns"
    with pytest.raises(ValueError):
        ExchangePlan(impl="packed")
    with pytest.raises(ValueError):
        ExchangePlan(histogram_impl="pallas")
    log = EventLog(*[torch.zeros(8, dtype=torch.int32) for _ in COLS])
    with pytest.raises(ValueError, match="unknown backend"):
        malstone_run(log, 4, nodes=2, backend="hadoop", device="cpu")
    with pytest.raises(ValueError, match="needs a MalGen SeedInfo"):
        run(log, 4, nodes=2, engine="resumable", device="cpu")
    assert resolve_exchange_impl("auto", 1 << 25, 52) == "columns"
    with pytest.raises(ValueError, match="one-word projection"):
        malstone_run(log, 1 << 25, nodes=2, device="cpu",
                     plan=ExchangePlan(impl="counting"))
    with pytest.raises(ValueError, match="divides"):
        malstone_run(log, 4, nodes=3, device="cpu")
