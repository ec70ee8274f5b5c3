"""The port's token pipeline against the JAX package.

The three data tests of ``tests/test_runtime.py`` run on the port. The
malgen source's tokens then equal JAX's exactly when the port is handed
JAX's seed tables, its global marked stream and the virtual shard's
unmarked draws (the keys of ``repro/malgen/generator.py:64-70``): the
records, their 100-byte encoding and the bytes modulo the vocabulary are
all integer work. The synthetic source draws from ``torch.Generator``s, so
its tokens are the port's own; its contract (a pure function of seed,
step and shard) is tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.malgen import MalGenConfig as JaxMalGenConfig
from repro.malgen.seeding import marked_event_stream as jax_marked_stream
from repro_torch.data import DataConfig, TokenPipeline, malgen_token_stream
from repro_torch.malgen import EventDraws, MalGenConfig, seed_from_numpy
from repro_torch.malgen.seeding import marked_event_stream

MG_KW = dict(num_sites=100, num_entities=1000)


def test_data_pipeline_deterministic():
    cfg = DataConfig(global_batch=8, seq_len=32, seed=11)
    a = TokenPipeline(cfg, device="cpu").batch_at(5)
    b = TokenPipeline(cfg, device="cpu").batch_at(5)
    torch.testing.assert_close(a["tokens"], b["tokens"], rtol=0, atol=0)
    c = TokenPipeline(cfg, device="cpu").batch_at(6)
    assert not torch.equal(a["tokens"], c["tokens"])


def test_data_pipeline_shards_partition_batch():
    cfg = DataConfig(global_batch=8, seq_len=32, seed=11)
    half0 = TokenPipeline(cfg, shard=0, num_shards=2, device="cpu")
    half1 = TokenPipeline(cfg, shard=1, num_shards=2, device="cpu")
    assert half0.batch_at(0)["tokens"].shape == (4, 32)
    assert half0.batch_at(0)["tokens"].dtype == torch.int32
    # shards differ from each other
    assert not torch.equal(half0.batch_at(0)["tokens"],
                           half1.batch_at(0)["tokens"])


def test_malgen_source_produces_valid_tokens():
    cfg = DataConfig(source="malgen", global_batch=2, seq_len=64,
                     vocab_size=256, malgen=MalGenConfig(**MG_KW))
    b = TokenPipeline(cfg, device="cpu").batch_at(0)
    toks = b["tokens"]
    assert toks.shape == (2, 64)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    # next-token alignment
    torch.testing.assert_close(b["labels"][:, :-1], b["tokens"][:, 1:],
                               rtol=0, atol=0)


def test_synthetic_shard_stream_does_not_depend_on_shard_count():
    """A shard's tokens are a function of (seed, step, shard), as JAX's
    ``fold_in(fold_in(key, step), shard)``: shard 1 of 2 at a global batch
    of 8 equals shard 1 of 4 at 16 (both 4 rows)."""
    a = TokenPipeline(DataConfig(global_batch=8, seq_len=16, seed=2),
                      shard=1, num_shards=2, device="cpu")
    b = TokenPipeline(DataConfig(global_batch=16, seq_len=16, seed=2),
                      shard=1, num_shards=4, device="cpu")
    for step in (0, 3):
        torch.testing.assert_close(a.tokens_at(step), b.tokens_at(step),
                                   rtol=0, atol=0)
    assert not torch.equal(a.tokens_at(0), a.tokens_at(1))
    for x in (a.tokens_at(0), b.tokens_at(2)):
        assert x.shape == (4, 17) and int(x.max()) < 256


@pytest.mark.parametrize("num_shards", [2, 3])
def test_shard_count_must_divide_the_global_batch(num_shards):
    cfg = DataConfig(global_batch=num_shards * 2 + 1, seq_len=8)
    with pytest.raises(ValueError, match="does not split"):
        TokenPipeline(cfg, num_shards=num_shards, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        malgen_token_stream(cfg, 1, num_shards=num_shards, device="cpu")


def test_unknown_source_and_shard_out_of_range_raise():
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(source="books"), device="cpu")
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(), shard=2, num_shards=2, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_unmarked_draws(jseed, jmg, shard_id, n):
    """generator.py:64-70 at the virtual shard: its keys and draws."""
    k_site, k_ent, k_ts = jax.random.split(
        jax.random.fold_in(jseed.key, shard_id), 3)
    return EventDraws(
        u_site=_t(jax.random.uniform(k_site, (n,), dtype=jnp.float32)),
        entity=_t(jax.random.randint(k_ent, (n,), 0, jmg.num_entities,
                                     dtype=jnp.int32)),
        timestamp=_t(jax.random.randint(k_ts, (n,), 0, jmg.span_seconds,
                                        dtype=jnp.int32)))


@pytest.fixture(scope="module")
def jax_malgen():
    """JAX's pipeline and seed at the JAX test's MalGenConfig, and the
    port's pipeline on JAX's seed tables and marked stream."""
    jmg = JaxMalGenConfig(**MG_KW)
    out = {}
    for vocab in (256, 91):
        kw = dict(source="malgen", global_batch=4, seq_len=150,
                  vocab_size=vocab, seed=5)
        jcfg = JaxDataConfig(malgen=jmg, **kw)
        out[vocab] = jcfg, DataConfig(malgen=MalGenConfig(**MG_KW), **kw)
    jseed = JaxTokenPipeline(out[256][0])._malgen_seed
    arrays = {f: np.asarray(getattr(jseed, f))
              for f in ("marked_mask", "entity_mark_time", "site_weights",
                        "marked_cdf", "unmarked_cdf", "num_marked_events")}
    seed = seed_from_numpy(arrays, MalGenConfig(**MG_KW), 5, device="cpu")
    marked = tuple(_t(x) for x in jax_marked_stream(jseed, jmg))
    return jmg, jseed, seed, marked, out


@pytest.mark.parametrize("vocab", [256, 91])
@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_malgen_tokens_equal_jax_given_its_draws(jax_malgen, vocab, step,
                                                 num_shards):
    jmg, jseed, seed, marked, cfgs = jax_malgen
    jcfg, tcfg = cfgs[vocab]
    shard = num_shards - 1
    want = JaxTokenPipeline(jcfg, shard, num_shards).batch_at(step)
    pipe = TokenPipeline(tcfg, shard, num_shards, device="cpu", seed=seed,
                         marked=marked)
    need = pipe.local_batch * (tcfg.seq_len + 1)
    n_rec = (need + 99) // 100 + 1
    shard_id = (step * num_shards + shard) % 65536
    n_unmarked = n_rec - len(range(shard_id, seed.num_marked_events, 65536))
    draws = _jax_unmarked_draws(jseed, jmg, shard_id, n_unmarked)
    toks = pipe.tokens_at(step, unmarked=draws)
    assert toks.dtype == torch.int32
    assert toks.shape == (pipe.local_batch, tcfg.seq_len + 1)
    np.testing.assert_array_equal(toks[:, :-1].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(toks[:, 1:].numpy(),
                                  np.asarray(want["labels"]))
    # the port's own draws have the same shape and the same layout
    own = pipe.malgen_draws(step)
    assert own.u_site.shape == draws.u_site.shape
    got = pipe.batch_at(step)["tokens"]
    assert got.shape == toks[:, :-1].shape and int(got.max()) < vocab


def test_malgen_marked_stream_made_once():
    """The constructor keeps the marked stream it derived the mark table
    from; a batch slices it instead of sampling it again."""
    cfg = DataConfig(source="malgen", global_batch=2, seq_len=32,
                     malgen=MalGenConfig(**MG_KW), seed=9)
    pipe = TokenPipeline(cfg, device="cpu")
    for a, b in zip(pipe.marked,
                    marked_event_stream(pipe.malgen_seed, cfg.malgen)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    batches = malgen_token_stream(cfg, 3, device="cpu")
    for i, b in enumerate(batches):
        torch.testing.assert_close(b["tokens"], pipe.batch_at(i)["tokens"],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="malgen"):
        TokenPipeline(DataConfig(), device="cpu").tokens_at(
            0, unmarked=pipe.malgen_draws(0))
