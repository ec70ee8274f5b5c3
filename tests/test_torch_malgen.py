"""The port's record contracts and MalGen against the JAX package.

The port draws its random numbers from ``torch.Generator``s, so the same
seed gives other records than ``jax.random``. These tests hand the port the
numbers JAX drew (from the same ``split``/``fold_in`` keys as
``repro/malgen/seeding.py`` and ``generator.py``) and the JAX seed tables,
and then require equality: exact for every integer column, ``rtol=1e-6``
for the float32 seed tables (XLA and torch order the pow/sum/cumsum
reductions differently; the same drift is why the JAX package stores its
CDFs at seed time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import generate_shard as jax_generate_shard
from repro.malgen import make_seed as jax_make_seed
from repro.malgen import powerlaw as jax_powerlaw
from repro_torch.common import types as ttypes
from repro_torch.malgen import (
    EventDraws,
    MalGenConfig,
    SiteDraws,
    generate_shard,
    generate_shards_device,
    make_seed,
    seed_from_numpy,
)
from repro_torch.malgen import powerlaw

KW = dict(num_sites=301, num_entities=1000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
JCFG, TCFG = JaxConfig(**KW), MalGenConfig(**KW)
P, RPS, KEY = 4, 512, 11


@pytest.fixture(scope="module")
def jax_seed():
    seed = jax_make_seed(jax.random.key(KEY), JCFG, P * RPS)
    assert seed.num_marked_events % P != 0, "want a ragged layout"
    return seed


def _seed_arrays(seed):
    return {f: np.asarray(getattr(seed, f))
            for f in ("marked_mask", "entity_mark_time", "site_weights",
                      "marked_cdf", "unmarked_cdf", "num_marked_events")}


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_event_draws(k_site, k_ent, k_ts, n):
    return EventDraws(
        u_site=_t(jax.random.uniform(k_site, (n,), dtype=jnp.float32)),
        entity=_t(jax.random.randint(k_ent, (n,), 0, JCFG.num_entities,
                                     dtype=jnp.int32)),
        timestamp=_t(jax.random.randint(k_ts, (n,), 0, JCFG.span_seconds,
                                        dtype=jnp.int32)))


def _jax_marked_draws(seed):
    """seeding.py:126-138: the marked stream's keys and draws."""
    k_events = jax.random.split(seed.key, 3)[2]
    k_site, k_ent, k_ts, k_bern = jax.random.split(k_events, 4)
    n = seed.num_marked_events
    bern = _t(jax.random.bernoulli(k_bern, JCFG.p_mark, (n,)))
    return _jax_event_draws(k_site, k_ent, k_ts, n), bern


def _jax_unmarked_draws(seed, shard):
    """generator.py:64-70: the shard's own keys and exact-count draws."""
    n = RPS - len(range(shard, seed.num_marked_events, P))
    k_site, k_ent, k_ts = jax.random.split(
        jax.random.fold_in(seed.key, shard), 3)
    return _jax_event_draws(k_site, k_ent, k_ts, n)


def test_pack_unpack_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    n = 4096
    site = rng.integers(0, 1 << 24, n).astype(np.int32)
    site[:3] = [0, (1 << 23), (1 << 24) - 1]
    week = rng.integers(0, 64, n).astype(np.int32)
    mark = rng.integers(0, 2, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    want = np.asarray(jtypes.pack_site_week_mark(
        jnp.asarray(site), jnp.asarray(week), jnp.asarray(mark),
        jnp.asarray(valid)))
    got = ttypes.pack_site_week_mark(_t(site), _t(week), _t(mark), _t(valid))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for a, b in zip(ttypes.unpack_site_week_mark(got),
                    jtypes.unpack_site_week_mark(jnp.asarray(want))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s, w, m, v = ttypes.unpack_site_week_mark(got)
    np.testing.assert_array_equal(s.numpy()[valid], site[valid])
    assert s.numpy()[2] == (1 << 24) - 1


def test_power_law_tables_match_jax():
    rng = np.random.default_rng(1)
    perm = rng.permutation(JCFG.num_sites).astype(np.int32)
    mask = rng.random(JCFG.num_sites) < 0.2
    want_w = np.asarray(jax_powerlaw.power_law_weights(
        JCFG.num_sites, JCFG.alpha, permutation=jnp.asarray(perm)))
    got_w = powerlaw.power_law_weights(TCFG.num_sites, TCFG.alpha,
                                       permutation=_t(perm).long())
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-6)
    for m in (mask, ~mask):
        want = np.asarray(jax_powerlaw.masked_site_cdf(jnp.asarray(want_w),
                                                       jnp.asarray(m)))
        got = powerlaw.masked_site_cdf(_t(want_w), _t(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_sample_sites_exact_given_u_and_cdf(jax_seed):
    key = jax.random.key(5)
    n = 20_000
    u = jax.random.uniform(key, (n,), dtype=jnp.float32)
    for cdf in (jax_seed.marked_cdf, jax_seed.unmarked_cdf):
        want = np.asarray(jax_powerlaw.sample_sites(key, cdf, n))
        got = powerlaw.sample_sites(_t(cdf), _t(u))
        np.testing.assert_array_equal(got.numpy(), want)
    # the clamp: u at the top of the table still lands on a site
    edge = powerlaw.sample_sites(_t(jax_seed.marked_cdf),
                                 torch.tensor([0.0, 1.0]))
    assert edge.max().item() <= JCFG.num_sites - 1


def test_seed_tables_match_jax_given_its_draws(jax_seed):
    k_perm, k_marked, _ = jax.random.split(jax.random.key(KEY), 3)
    site_draws = SiteDraws(
        permutation=_t(jax.random.permutation(k_perm, JCFG.num_sites)),
        marked_ids=_t(jax.random.choice(k_marked, JCFG.num_sites,
                                        shape=(JCFG.num_marked_sites,),
                                        replace=False)))
    marked, bern = _jax_marked_draws(jax_seed)
    seed = make_seed(KEY, TCFG, P * RPS, device="cpu",
                     site_draws=site_draws, marked_draws=marked,
                     bernoulli=bern)
    assert seed.num_marked_events == jax_seed.num_marked_events
    np.testing.assert_array_equal(seed.marked_mask.numpy(),
                                  np.asarray(jax_seed.marked_mask))
    np.testing.assert_array_equal(seed.entity_mark_time.numpy(),
                                  np.asarray(jax_seed.entity_mark_time))
    for f in ("site_weights", "marked_cdf", "unmarked_cdf"):
        np.testing.assert_allclose(getattr(seed, f).numpy(),
                                   np.asarray(getattr(jax_seed, f)),
                                   rtol=1e-6, err_msg=f)
    assert (seed.entity_mark_time < ttypes.NEVER_MARKED).any()


def test_generate_shards_device_matches_jax_every_shard(jax_seed):
    seed = seed_from_numpy(_seed_arrays(jax_seed), TCFG, KEY, device="cpu")
    marked, _ = _jax_marked_draws(jax_seed)
    log = generate_shards_device(
        seed, TCFG, P, RPS, device="cpu", marked_draws=marked,
        unmarked_draws=[_jax_unmarked_draws(jax_seed, s) for s in range(P)])
    assert log.site_id.shape == (P, RPS)
    for s in range(P):
        want = jax_generate_shard(jax_seed, JCFG, s, P, RPS)
        for name in ("site_id", "entity_id", "timestamp", "mark"):
            np.testing.assert_array_equal(
                getattr(log, name)[s].numpy(),
                np.asarray(getattr(want, name)), err_msg=f"{name} shard {s}")
        for name in ("event_seq", "shard_hash"):
            np.testing.assert_array_equal(
                getattr(log, name)[s].numpy().view(np.uint32),
                np.asarray(getattr(want, name)), err_msg=f"{name} shard {s}")
    assert log.mark.sum() > 0


def test_port_generators_are_deterministic_per_shard():
    """Without draws handed in, the port's own generators: the fused
    [P, rps] generation equals generate_shard per shard, run to run."""
    seed = make_seed(3, TCFG, P * RPS, device="cpu")
    a = generate_shards_device(seed, TCFG, P, RPS, device="cpu")
    b = generate_shards_device(seed, TCFG, P, RPS, device="cpu")
    for s in range(P):
        one = generate_shard(seed, TCFG, s, P, RPS)
        for x, y, z in zip(a, b, one):
            if x is not None:
                torch.testing.assert_close(x[s], y[s], rtol=0, atol=0)
                torch.testing.assert_close(x[s], z, rtol=0, atol=0)
    assert not torch.equal(a.site_id[0], a.site_id[1])


def test_oversized_marked_stream_raises():
    seed = make_seed(3, TCFG, 4 * P * RPS, device="cpu")
    with pytest.raises(ValueError, match="marked"):
        generate_shards_device(seed, TCFG, P, RPS // 8, device="cpu")
