"""The port's streaming engine, its window algebra and its chunk-keyed
MalGen against the JAX package, exactly.

Equality is exact: integer histograms, the bits of ``rho`` for A, B and
B-fixed, every ``ShuffleStats`` field, every record column; the float32
seed tables hold to ``rtol=1e-6`` (as in ``tests/test_torch_malgen.py``).
The port draws its random numbers from its own generators, so the
generation tests hand it the numbers JAX drew from ``chunk_keys``.

- P = 1 runs in this process against a 1-device JAX mesh.
- P = 4 needs 4 JAX host devices, so the JAX side runs once per module in
  a subprocess: this file run as a script (``python
  tests/test_torch_streaming.py OUT.npz``) forces 4 devices and computes
  every P = 4 case.
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
from repro.common.types import WindowSpec as JaxWindow
from repro.core import malstone_run_streaming as jax_run_streaming
from repro.core import spm as jax_spm
from repro.core import windows as jax_windows
from repro.core.backends import ShuffleStats as JaxStats
from repro.core.streaming import merge_stats as jax_merge_stats
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import generate_chunk as jax_generate_chunk
from repro.malgen import generate_chunked_log as jax_chunked_log
from repro.malgen import make_seed_streaming as jax_seed_streaming
from repro.malgen.generator import chunk_shard_hash as jax_chunk_hash
from repro.malgen.seeding import chunk_keys

HERE = pathlib.Path(__file__).resolve().parent
KW = dict(num_sites=301, num_entities=1000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
JCFG = JaxConfig(**KW)
KEY, NUM_CHUNKS, CHUNK = 7, 8, 512
N_LOG = NUM_CHUNKS * CHUNK - 300            # an uneven last chunk
STREAM_CHUNK = 256
P4 = 4
COLS = ("site_id", "entity_id", "timestamp", "mark")
STATS = ("sent", "overflow", "capacity", "rounds", "residual",
         "bytes_exchanged")
STATISTICS = ("A", "B", "B-fixed")
# (case, backend, exchange impl, capacity factor)
CASES = (("streams", "streams", "auto", 2.0),
         ("sphere", "sphere", "auto", 2.0),
         ("combiner", "mapreduce_combiner", "auto", 2.0),
         ("counting", "mapreduce", "counting", 0.5),
         ("columns", "mapreduce", "columns", 0.5))


def _jax_log():
    seed = jax_seed_streaming(jax.random.key(KEY), JCFG, NUM_CHUNKS, CHUNK)
    log = jax_chunked_log(seed, JCFG, NUM_CHUNKS, CHUNK)
    return seed, jax.tree.map(lambda x: x[:N_LOG], log)


def _jax_results(log, backend, impl, cf, mesh):
    """One JAX streaming run (statistic B) and the A / B-fixed finalizers
    of the same histogram, as a dict of numpy arrays."""
    res, stats = jax_run_streaming(
        log, KW["num_sites"], mesh=mesh, backend=backend,
        chunk_records=STREAM_CHUNK, statistic="B",
        plan=JaxPlan(impl=impl, capacity_factor=cf),
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


def _oracle_main(out_path):
    """The P = 4 JAX side: every case over the uneven log."""
    assert jax.device_count() == P4, jax.devices()
    mesh = jax.make_mesh((P4,), ("data",))
    _, log = _jax_log()
    out = {}
    for case, backend, impl, cf in CASES:
        out.update({f"{case}/{k}": v for k, v in
                    _jax_results(log, backend, impl, cf, mesh).items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    _oracle_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

from repro_torch.common.types import EventLog, ExchangePlan  # noqa: E402
from repro_torch.common.types import WindowSpec  # noqa: E402
from repro_torch.core import (  # noqa: E402
    malstone_run,
    malstone_run_generated_streaming,
    malstone_run_streaming,
    run,
)
from repro_torch.core import windows  # noqa: E402
from repro_torch.core.backends import ShuffleStats  # noqa: E402
from repro_torch.core.streaming import (  # noqa: E402
    carry_zeros_host,
    fold_chunk,
    merge_stats,
    snapshot,
    state_init,
)
from repro_torch.malgen import (  # noqa: E402
    ChunkMarkDraws,
    EventDraws,
    MalGenConfig,
    SiteDraws,
    chunk_marked_records,
    chunk_shard_hash,
    generate_chunk,
    generate_chunked_log,
    generate_chunks,
    generate_shards_device,
    make_seed,
    make_seed_streaming,
    seed_from_numpy,
)

TCFG = MalGenConfig(**KW)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_log(jlog):
    return EventLog(*[_t(getattr(jlog, c)) for c in COLS])


def _assert_result(got, want, msg):
    """``want`` maps "rho"/"total"/"marked" to numpy; rho by its bits."""
    np.testing.assert_array_equal(got.total.numpy(), want["total"],
                                  err_msg=f"total {msg}")
    np.testing.assert_array_equal(got.marked.numpy(), want["marked"],
                                  err_msg=f"marked {msg}")
    np.testing.assert_array_equal(got.rho.numpy().view(np.int32),
                                  np.asarray(want["rho"]).view(np.int32),
                                  err_msg=f"rho bits {msg}")


def _assert_same(a, b, msg):
    """Two port results, rho by its bits."""
    for f in ("total", "marked"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{f} {msg}"
    assert torch.equal(a.rho.view(torch.int32), b.rho.view(torch.int32)), msg


# --------------------------------------------------------------- windows
WINDOWS = [JaxWindow(0, 31_536_000, 0, 31_536_000),
           JaxWindow(0, 31_536_000, 604_800 * 26, 31_536_000),
           JaxWindow(0, 31_536_000, 0, 604_800),
           JaxWindow(604_800, 604_800 * 3, 0, 604_800 * 10 + 5),
           JaxWindow(0, 31_536_000, 604_800 * 51 + 1, 31_536_000),
           JaxWindow(0, 31_536_000, 31_536_000 - 10, 31_536_000),
           JaxWindow(0, 31_536_000, 100, 100),
           JaxWindow(0, 31_536_000, -5, 3)]


@pytest.mark.parametrize("num_weeks", (52, 13, 65))
def test_week_masks_match_jax(num_weeks):
    for w in WINDOWS:
        want = np.asarray(jax_windows.week_mask_for_window(w, num_weeks))
        got = windows.week_mask_for_window(WindowSpec(*w), num_weeks)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(w))
    assert [tuple(w) for w in windows.growing_monitor_windows(num_weeks)] \
        == [tuple(w) for w in jax_windows.growing_monitor_windows(num_weeks)]
    ts = np.array([-7, 0, 604_799, 604_800, 31_535_999, 40_000_000],
                  np.int32)
    np.testing.assert_array_equal(
        windows.week_of(_t(ts), num_weeks).numpy(),
        np.asarray(jax_windows.week_of(jnp.asarray(ts), num_weeks)))
    np.testing.assert_array_equal(
        windows.in_window(_t(ts), 0, 604_800).numpy(),
        np.asarray(jax_windows.in_window(jnp.asarray(ts), 0, 604_800)))
    assert tuple(WindowSpec.full_year()) == tuple(JaxWindow.full_year())


# ------------------------------------------------------ chunk-keyed MalGen
def test_chunk_shard_hash_bits_match_jax():
    ids = [0, 1, 2, 7, 1000, 65_535, 2**31 - 2, 2**31 - 1]
    want = np.array([int(np.asarray(jax_chunk_hash(jnp.int32(i))))
                     for i in ids], np.uint32)
    got = chunk_shard_hash(torch.tensor(ids))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert [int(chunk_shard_hash(i)) for i in ids] \
        == got.tolist()
    assert int(chunk_shard_hash(0)) != 0, "chunk 0 collides with padding"


@pytest.fixture(scope="module")
def jax_seed():
    return jax_seed_streaming(jax.random.key(KEY), JCFG, NUM_CHUNKS, CHUNK)


def _jax_chunk_draws(seed, chunk_id, records=CHUNK):
    """generator.py:generate_chunk's keys and draws of one chunk of
    ``records`` records."""
    k_ms, k_me, k_mt, k_b, k_us, k_ue, k_ut = chunk_keys(seed.key, chunk_id)
    nm = chunk_marked_records(TCFG, records)

    def draws(k_s, k_e, k_t, n):
        return EventDraws(
            u_site=_t(jax.random.uniform(k_s, (n,), dtype=jnp.float32)),
            entity=_t(jax.random.randint(k_e, (n,), 0, JCFG.num_entities,
                                         dtype=jnp.int32)),
            timestamp=_t(jax.random.randint(k_t, (n,), 0, JCFG.span_seconds,
                                            dtype=jnp.int32)))

    marked = draws(k_ms, k_me, k_mt, nm)
    bern = _t(jax.random.bernoulli(k_b, JCFG.p_mark, (nm,)))
    return marked, bern, draws(k_us, k_ue, k_ut, records - nm)


def _seed_arrays(seed):
    return {f: np.asarray(getattr(seed, f))
            for f in ("marked_mask", "entity_mark_time", "site_weights",
                      "marked_cdf", "unmarked_cdf", "num_marked_events")}


def test_make_seed_streaming_matches_jax_given_its_draws(jax_seed):
    k_perm, k_marked, _ = jax.random.split(jax.random.key(KEY), 3)
    site_draws = SiteDraws(
        permutation=_t(jax.random.permutation(k_perm, JCFG.num_sites)),
        marked_ids=_t(jax.random.choice(k_marked, JCFG.num_sites,
                                        shape=(JCFG.num_marked_sites,),
                                        replace=False)))
    chunk_draws = []
    for c in range(NUM_CHUNKS):
        marked, bern, _ = _jax_chunk_draws(jax_seed, c)
        chunk_draws.append(ChunkMarkDraws(marked.entity, marked.timestamp,
                                          bern))
    seed = make_seed_streaming(KEY, TCFG, NUM_CHUNKS, CHUNK, device="cpu",
                               site_draws=site_draws, chunk_draws=chunk_draws)
    assert seed.num_marked_events == jax_seed.num_marked_events
    np.testing.assert_array_equal(seed.marked_mask.numpy(),
                                  np.asarray(jax_seed.marked_mask))
    np.testing.assert_array_equal(seed.entity_mark_time.numpy(),
                                  np.asarray(jax_seed.entity_mark_time))
    for f in ("site_weights", "marked_cdf", "unmarked_cdf"):
        np.testing.assert_allclose(getattr(seed, f).numpy(),
                                   np.asarray(getattr(jax_seed, f)),
                                   rtol=1e-6, err_msg=f)
    assert (seed.entity_mark_time < 2**31 - 1).any()
    with pytest.raises(ValueError, match="chunk draws"):
        make_seed_streaming(KEY, TCFG, NUM_CHUNKS + 1, CHUNK, device="cpu",
                            chunk_draws=chunk_draws)


@pytest.mark.parametrize("chunk_id", (0, 3, 7))
def test_generate_chunk_matches_jax_given_its_draws(jax_seed, chunk_id):
    seed = seed_from_numpy(_seed_arrays(jax_seed), TCFG, KEY, device="cpu")
    marked, _, unmarked = _jax_chunk_draws(jax_seed, chunk_id)
    got = generate_chunk(seed, TCFG, chunk_id, CHUNK, marked=marked,
                         unmarked=unmarked)
    want = jax_generate_chunk(jax_seed, JCFG, chunk_id, CHUNK)
    for c in COLS:
        np.testing.assert_array_equal(getattr(got, c).numpy(),
                                      np.asarray(getattr(want, c)),
                                      err_msg=c)
    for c in ("event_seq", "shard_hash"):
        np.testing.assert_array_equal(getattr(got, c).numpy().view(np.uint32),
                                      np.asarray(getattr(want, c)),
                                      err_msg=c)
    assert got.mark.sum() > 0


def test_port_chunks_are_a_function_of_the_chunk_id():
    """Without draws handed in, the port's own generators: one chunk id
    gives one chunk, whichever way it is made; the streaming seed's marks
    correspond to the chunks' marked rows."""
    seed = make_seed_streaming(3, TCFG, 6, 400, device="cpu")
    flat = generate_chunked_log(seed, TCFG, 6, 400)
    step = generate_chunks(seed, TCFG, [4, 1], 400)
    for c in COLS + ("event_seq", "shard_hash"):
        col = getattr(flat, c).reshape(6, 400)
        assert torch.equal(getattr(step, c), col[[4, 1]]), c
        assert torch.equal(getattr(generate_chunk(seed, TCFG, 2, 400), c),
                           col[2]), c
    assert not torch.equal(step.site_id[0], step.site_id[1])
    # a marked visit that marks the entity is a mark from then on
    nm = chunk_marked_records(TCFG, 400)
    visits = flat.map(lambda c: c.reshape(6, 400)[:, :nm].reshape(-1))
    assert (seed.entity_mark_time[visits.entity_id.long()]
            <= visits.timestamp + TCFG.mark_delay).any()
    # the one-shot seed of the same rng_seed has the same site tables
    one = make_seed(3, TCFG, 2400, device="cpu")
    for f in ("marked_mask", "site_weights", "marked_cdf", "unmarked_cdf"):
        assert torch.equal(getattr(one, f), getattr(seed, f)), f


def test_merge_stats_matches_jax_with_int32_wrap():
    """Counters add with int32 wrap, rounds keeps the max, capacity is the
    chunk's: per node, as the JAX per-device merge."""
    acc_vals = dict(sent=[5, 2**31 - 10], overflow=[0, 1], capacity=[0, 64],
                    rounds=[1, 3], residual=[7, 2**31 - 1],
                    bytes_exchanged=[2**31 - 100, 2**30])
    chunk = ShuffleStats(
        sent=torch.tensor([3, 20], dtype=torch.int32),
        overflow=torch.tensor([0, 0], dtype=torch.int32), capacity=64,
        rounds=2, residual=torch.tensor([1, 5], dtype=torch.int32),
        bytes_exchanged=torch.tensor([400, 2**31 - 1], dtype=torch.int32))
    acc = ShuffleStats(*(torch.tensor(acc_vals[f], dtype=torch.int32)
                         for f in STATS))
    got = merge_stats(acc, chunk)
    for d in range(2):
        want = jax_merge_stats(
            JaxStats(*(jnp.int32(acc_vals[f][d]) for f in STATS)),
            JaxStats(*(jnp.int32(chunk.capacity) if f == "capacity" else
                       jnp.int32(chunk.rounds) if f == "rounds" else
                       jnp.int32(int(getattr(chunk, f)[d])) for f in STATS)))
        for f in STATS:
            assert int(getattr(got, f)[d]) == int(getattr(want, f)), (f, d)
    assert int(got.bytes_exchanged[0]) < 0 and int(got.sent[1]) < 0


# ------------------------------------------------- the streaming engine
@pytest.fixture(scope="module")
def p1():
    """The uneven JAX log and every case's JAX results at P = 1."""
    mesh = jax.make_mesh((1,), ("data",))
    _, log = _jax_log()
    want = {case: _jax_results(log, backend, impl, cf, mesh)
            for case, backend, impl, cf in CASES}
    return _port_log(log), want


@pytest.fixture(scope="module")
def p4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_streaming_p4")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE.parent),
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_streaming.py"),
         str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        out = dict(f)
    _, log = _jax_log()
    return _port_log(log), out


def _check_case(log, want, nodes, case, backend, impl, cf):
    plan = ExchangePlan(impl=impl, capacity_factor=cf)
    for stat in STATISTICS:
        got, stats = malstone_run_streaming(
            log, KW["num_sites"], nodes=nodes, backend=backend,
            chunk_records=STREAM_CHUNK, statistic=stat, plan=plan,
            device="cpu", return_shuffle_stats=True)
        _assert_result(got, {f: want[f"{stat}/{f}"]
                             for f in ("rho", "total", "marked")},
                       f"{case}/{stat} P={nodes}")
        if backend == "mapreduce":
            for f in STATS:
                assert int(getattr(stats, f)) == int(want[f"stats/{f}"]), \
                    f"{case} P={nodes}: ShuffleStats.{f}"
        else:
            assert stats is None
    return stats


@pytest.mark.parametrize("case,backend,impl,cf", CASES)
def test_log_mode_matches_jax_p1(p1, case, backend, impl, cf):
    log, want = p1
    stats = _check_case(log, want[case], 1, case, backend, impl, cf)
    if backend == "mapreduce":
        assert stats.rounds > 1, "want a chunk that needs several rounds"
        assert int(stats.sent) == N_LOG


@pytest.mark.parametrize("case,backend,impl,cf", CASES)
def test_log_mode_matches_jax_p4(p4, case, backend, impl, cf):
    log, out = p4
    want = {k.split("/", 1)[1]: v for k, v in out.items()
            if k.startswith(case + "/")}
    _check_case(log, want, P4, case, backend, impl, cf)


@pytest.mark.parametrize("nodes", (1, 4))
@pytest.mark.parametrize("backend", ("streams", "sphere", "mapreduce",
                                     "mapreduce_combiner"))
def test_seed_mode_equals_the_one_shot_run(nodes, backend):
    num_chunks = 2 * nodes
    seed = make_seed_streaming(5, TCFG, num_chunks, 500, device="cpu")
    oneshot = generate_chunked_log(seed, TCFG, num_chunks, 500)
    plan = ExchangePlan(impl="counting", capacity_factor=0.5)
    for stat in STATISTICS:
        want = malstone_run(oneshot, KW["num_sites"], nodes=nodes,
                            statistic=stat, plan=plan, device="cpu")
        got = run(seed, engine="streaming", nodes=nodes, cfg=TCFG,
                  num_chunks=num_chunks, chunk_records=500, backend=backend,
                  statistic=stat, plan=plan, device="cpu")
        _assert_same(got, want, f"{backend} {stat} P={nodes}")


def test_generated_streaming_equals_streaming_over_its_log():
    seed = make_seed(9, TCFG, 4 * 1024, device="cpu")
    log = generate_shards_device(seed, TCFG, 4, 1024, device="cpu").map(
        lambda c: c.reshape(-1))
    plan = ExchangePlan(capacity_factor=0.5)
    for backend in ("streams", "mapreduce"):
        want, ws = run(log, KW["num_sites"], engine="streaming", nodes=4,
                       chunk_records=256, backend=backend, plan=plan,
                       device="cpu", return_shuffle_stats=True)
        got, gs = run(seed, engine="generated_streaming", nodes=4, cfg=TCFG,
                      records_per_shard=1024, chunk_records=256,
                      backend=backend, plan=plan, device="cpu",
                      return_shuffle_stats=True)
        _assert_same(got, want, backend)
        got2 = malstone_run_generated_streaming(
            seed, TCFG, nodes=4, records_per_shard=1024, chunk_records=256,
            backend=backend, plan=plan, device="cpu")
        _assert_same(got2, want, backend)
        if backend == "mapreduce":
            assert [int(x) for x in gs] == [int(x) for x in ws]
        one = run(log, KW["num_sites"], nodes=4, backend=backend,
                  plan=plan, device="cpu")
        _assert_same(got, one, f"{backend} vs one-shot")


def test_fold_and_snapshot_leave_a_resident_state():
    """fold_chunk folds a [P, C] chunk; snapshot does not consume the
    state, which folds on to the one-shot result."""
    seed = make_seed_streaming(4, TCFG, 4, 256, device="cpu")
    state = state_init("mapreduce", 2, 302, 52, "cpu")
    plan = ExchangePlan(capacity_factor=0.5)
    for step in range(2):
        chunk = generate_chunks(seed, TCFG, [step, 2 + step], 256)
        state = fold_chunk(state, chunk, backend="mapreduce", s_pad=302,
                           plan=plan)
        hist, stats = snapshot(state, backend="mapreduce", s_pad=302)
    assert state.chunks_folded == 2
    want, ws = run(seed, engine="streaming", nodes=2, cfg=TCFG, num_chunks=4,
                   chunk_records=256, statistic="A", plan=plan,
                   device="cpu", return_shuffle_stats=True)
    assert torch.equal(hist[:301, :, 0].sum(1, dtype=torch.int32),
                       want.total)
    assert [int(x) for x in stats] == [int(x) for x in ws]
    zero = carry_zeros_host("mapreduce", 2, 302, 52)
    assert zero[0].shape == (2, 151, 52, 2) and zero[1].sent.shape == (2,)
    assert carry_zeros_host("streams", 2, 302, 52).shape == (2, 302, 52, 2)


def test_streaming_contracts():
    seed = make_seed_streaming(1, TCFG, 4, 64, device="cpu")
    log = generate_chunked_log(seed, TCFG, 4, 64)
    with pytest.raises(ValueError, match="seed-mode streaming"):
        malstone_run_streaming(log, 301, nodes=2, chunk_records=64,
                               overlap=True, device="cpu")
    with pytest.raises(ValueError, match="num_chunks"):
        malstone_run_streaming(seed, 301, nodes=3, cfg=TCFG, num_chunks=4,
                               chunk_records=64, overlap=False,
                               device="cpu")
    with pytest.raises(ValueError, match="num_chunks"):
        malstone_run_streaming(seed, 301, nodes=3, cfg=TCFG, num_chunks=4,
                               chunk_records=64, device="cpu")
    with pytest.raises(ValueError, match="cfg= and num_chunks="):
        malstone_run_streaming(seed, 301, nodes=2, chunk_records=64,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        malstone_run_streaming(log, 301, nodes=2, backend="hadoop",
                               device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        malstone_run_generated_streaming(
            make_seed(1, TCFG, 256, device="cpu"), TCFG, nodes=2,
            records_per_shard=128, chunk_records=100, device="cpu")
    with pytest.raises(ValueError, match="SeedInfo"):
        run(log, 301, nodes=2, engine="generated_streaming", device="cpu")
    with pytest.raises(ValueError, match="needs a MalGen SeedInfo"):
        run(log, 301, nodes=2, engine="resumable", device="cpu")
    with pytest.raises(ValueError, match="segment_chunks"):
        run(seed, nodes=2, engine="resumable", cfg=TCFG, num_chunks=4,
            chunk_records=64, segment_chunks=3, device="cpu")
