"""The port's serving path (fused prefill, decode steps) against the JAX
package's, on the CPU.

JAX's f32 smoke configs (``tests/test_models.py:19-25``: the MoE at
capacity factor 8.0), JAX's ``init_params`` leaves carried across by path
name and the same numpy-seeded tokens go through ``decoding.prefill`` and
two ``decode_step``s of both packages. Bars: logits and every float cache
leaf within rtol = atol = 2e-3, 2e-2 for the MoE after the router's
expert choices are compared exactly (JAX's decode bars,
``tests/test_models.py:55-60``); the integer leaves (``length``, ``pos``)
and the leaf names, in JAX's order, exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decoding as jax_D
from test_torch_models import (ARCHS, LOGIT_TOL, MOE_TOL, _close, f32,
                               jax_params, make_batch, port_cfg,
                               recorded_routes, to_jax, to_torch)

from repro_torch.common.tree import tree_flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

PROMPT = 20
REPLAY_ARCHS = ["llama3_8b", "gemma2_2b", "recurrentgemma_2b", "rwkv6_7b",
                "whisper_small"]


def _max_len(cfg, prompt=PROMPT):
    return prompt + 16 + (cfg.num_patches if cfg.family == "vlm" else 0)


def _tol(cfg):
    return MOE_TOL if cfg.family == "moe" else LOGIT_TOL


def _prompt(batch, s=PROMPT):
    return {k: (v[:, :s] if k in ("tokens", "labels") else v)
            for k, v in batch.items()}


def _leaves(cache):
    return [(name, np.asarray(x)) for name, x in jax_flatten(cache)]


def _same_cache(got, want, tol, what):
    """Leaf names in JAX's order; integer leaves exact, float ones within
    ``tol``. Returns the largest float difference."""
    got = tree_flatten_with_paths(got)
    assert [n for n, _ in got] == [n for n, _ in want], what
    err = 0.0
    for (name, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, (what, name)
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == torch.int32, (what, name)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            err = max(err, _close(g, w, tol))
    return err


@functools.lru_cache(maxsize=None)
def jax_serve_case(arch):
    """JAX's prefill of the first PROMPT tokens, then two decode steps
    (token PROMPT, then token 0 again, as ``tests/test_models.py`` feeds
    them): the last logits, the cache leaves after each, the decode
    logits and every MoE call's expert choices, in call order."""
    cfg = f32(jax_smoke_config(arch))
    p, flat = jax_params(cfg)
    batch = make_batch(cfg, s=PROMPT + 1)
    toks = batch["tokens"]
    with recorded_routes() as (routes, _):
        last, cache, enc_out = jax_D.prefill(p, cfg, to_jax(_prompt(batch)),
                                             _max_len(cfg))
        jax.effects_barrier()
        out = dict(flat=flat, batch=batch, last=np.asarray(last),
                   cache=_leaves(cache), prefill_routes=len(routes))
        logits = []
        for tok in (toks[:, PROMPT:], toks[:, :1]):
            lg, cache = jax_D.decode_step(p, cfg, jnp.asarray(tok), cache,
                                          enc_out=enc_out)
            logits.append(np.asarray(lg))
        jax.effects_barrier()
    out.update(decode=logits, decode_cache=_leaves(cache),
               routes=list(routes))
    return out


def _port(arch):
    case = jax_serve_case(arch)
    cfg = port_cfg(arch)
    return case, cfg, params_from_numpy(case["flat"], cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_prefill_matches_jax(arch):
    """The last logits and every cache leaf of JAX's ``prefill``."""
    case, cfg, p = _port(arch)
    with recorded_routes() as (_, routes):
        last, cache, enc_out = D.prefill(
            p, cfg, to_torch(_prompt(case["batch"])), _max_len(cfg))
    assert len(routes) == case["prefill_routes"]
    for got, want in zip(routes, case["routes"]):
        np.testing.assert_array_equal(got, want)
    assert last.shape == (2, 1, cfg.padded_vocab)
    _close(last, case["last"], _tol(cfg))
    _same_cache(cache, case["cache"], _tol(cfg), f"{arch} prefill")
    assert (enc_out is not None) == cfg.is_encoder_decoder


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_and_teacher_forcing(arch):
    """Two decode steps after the fused prefill: logits and cache against
    JAX's ``decode_step``, and logits against the port's own forward over
    the whole sequence (teacher forcing)."""
    case, cfg, p = _port(arch)
    batch = to_torch(case["batch"])
    toks = batch["tokens"]
    tol = _tol(cfg)
    _, cache, enc_out = D.prefill(p, cfg, _prompt(batch), _max_len(cfg))
    got = []
    with recorded_routes() as (_, routes):
        for tok in (toks[:, PROMPT:], toks[:, :1]):
            lg, cache = D.decode_step(p, cfg, tok, cache, enc_out=enc_out)
            got.append(lg)
    want_routes = case["routes"][case["prefill_routes"]:]
    assert len(routes) == len(want_routes) == (
        2 * cfg.num_layers if cfg.family == "moe" else 0)
    for g, w in zip(routes, want_routes):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, case["decode"]):
        assert g.shape == (2, 1, cfg.padded_vocab)
        _close(g, w, tol)
    _same_cache(cache, case["decode_cache"], tol, f"{arch} decode")
    full = T.forward(p, cfg, batch)
    seq2 = torch.cat([toks, toks[:, :1]], dim=1)
    full2 = T.forward(p, cfg, {**batch, "tokens": seq2, "labels": seq2})
    _close(got[0][:, 0], full[:, PROMPT].numpy(), tol)
    _close(got[1][:, 0], full2[:, PROMPT + 1].numpy(), tol)


@pytest.mark.parametrize("arch", REPLAY_ARCHS)
def test_fused_prefill_matches_replay_oracle(arch):
    """``prefill`` against ``prefill_reference`` (the forward, then each
    layer replayed, the recurrent states token by token)."""
    case, cfg, p = _port(arch)
    pre = to_torch(_prompt(case["batch"]))
    lf, cf, ef = D.prefill(p, cfg, pre, _max_len(cfg))
    lr, cr, er = D.prefill_reference(p, cfg, pre, _max_len(cfg))
    _close(lf, lr.numpy(), LOGIT_TOL)
    want = [(n, x.numpy()) for n, x in tree_flatten_with_paths(cr)]
    _same_cache(cf, want, LOGIT_TOL, f"{arch} replay")
    if cfg.is_encoder_decoder:
        _close(ef, er.numpy(), LOGIT_TOL)


@pytest.mark.parametrize("arch", ["gemma2_2b", "recurrentgemma_2b"])
def test_ring_wraps_at_the_smoke_window(arch):
    """The smoke window of 16 against a prompt of 20: the ring holds
    positions 4..19, position p at slot p % 16, and each decode step
    overwrites the oldest slot; ``length`` counts every token."""
    case, cfg, p = _port(arch)
    assert cfg.local_window == 16
    batch = to_torch(case["batch"])
    _, cache, _ = D.prefill(p, cfg, _prompt(batch), _max_len(cfg))
    rings = [lc["kind_local"] for lc in cache if "kind_local" in lc]
    assert rings
    for length in (PROMPT, PROMPT + 1, PROMPT + 2):
        for ring in rings:
            want = np.full(ring.pos.shape, -1, np.int32)
            for q in range(max(0, length - 16), length):
                want[..., q % 16] = q
            np.testing.assert_array_equal(ring.pos.numpy(), want)
            assert (ring.length.numpy() == length).all()
        if length < PROMPT + 2:
            _, cache = D.decode_step(p, cfg, batch["tokens"][:, :1], cache)


def test_check_room_refuses_a_full_cache():
    cfg = port_cfg("internvl2_1b")
    p, _ = T.init_params(cfg, device="cpu")
    batch = to_torch(_prompt(make_batch(cfg, s=PROMPT)))
    room = PROMPT + cfg.num_patches
    with pytest.raises(ValueError, match=f"max_len={room} leaves no room"):
        D.prefill(p, cfg, batch, room)
    with pytest.raises(ValueError, match="incl. any patch/frame prefix"):
        D.prefill_reference(p, cfg, batch, room)
    last, _, _ = D.prefill(p, cfg, batch, room + 1)
    assert last.shape == (2, 1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    """``init_cache`` of the bf16 smoke configs: JAX's leaf names, shapes,
    dtypes and values (zeros, ``pos`` -1), on ``meta`` the same
    structure with no memory."""
    want = [(n, np.asarray(x)) for n, x in jax_flatten(
        jax_D.init_cache(jax_smoke_config(arch), 2, 40))]
    got = tree_flatten_with_paths(D.init_cache(get_smoke_config(arch), 2, 40,
                                               device="cpu"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert str(g.dtype).split(".")[1] == w.dtype.name, name
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      w.astype(np.float32), err_msg=name)
    meta = tree_flatten_with_paths(D.init_cache(get_smoke_config(arch), 2,
                                                40, device="meta"))
    assert [(n, tuple(x.shape), x.dtype) for n, x in meta] == [
        (n, tuple(x.shape), x.dtype) for n, x in got]
    assert all(x.is_meta for _, x in meta)


def test_decode_step_writes_into_the_cache_it_is_given():
    """A decode step updates the caller's buffers (stacked leaves
    included) and returns the same tensors: no copy of the cache."""
    cfg = dataclasses.replace(port_cfg("llama3_8b"), num_layers=4)
    assert cfg.uniform_period < cfg.num_layers       # a stacked layout
    p, _ = T.init_params(cfg, device="cpu")
    batch = to_torch(_prompt(make_batch(cfg, s=PROMPT)))
    _, cache, _ = D.prefill(p, cfg, batch, _max_len(cfg))
    before = [(x, x.data_ptr(), x.clone())
              for _, x in tree_flatten_with_paths(cache)]
    _, out = D.decode_step(p, cfg, batch["tokens"][:, :1], cache)
    after = tree_flatten_with_paths(out)
    assert all(x is y and x.data_ptr() == ptr
               for (x, ptr, _), (_, y) in zip(before, after))
    k, ptr, k0 = before[0]
    assert not torch.equal(k, k0)                       # written in place
    assert torch.equal(k[:, :, :PROMPT], k0[:, :, :PROMPT])
    length = dict(tree_flatten_with_paths(out))["0/kind_attn/length"]
    assert length.tolist() == [PROMPT + 1] * 4
