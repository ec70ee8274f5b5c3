"""The port's recurrent mixers (RG-LRU, RWKV-6) against the JAX package's,
on the CPU.

The same inputs, made from a seed with numpy, and JAX's init leaves (the
zero- and one-initialised ones replaced by seeded draws, so that every
parameter matters) go through both. Bars: the associative scan bit-equal
to ``jax.lax.associative_scan``; each mixer function, and the state it
returns, within rtol = atol = 2e-4 (JAX's flash-against-naive bar,
``tests/test_models.py:152``); a block on S tokens followed by one decode
step against the block on S + 1 tokens within 2e-3 (JAX's decode bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv

from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W

FN_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=2e-3, atol=2e-3)
D, WIDTH, HS = 64, 48, 8


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def _params(jax_tree, seed):
    """``(jax params, port params)`` from one tree of JAX leaves, f32; the
    leaves JAX initialises to constants (biases, mixes, norms, the conv)
    replaced by seeded draws in both."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out_j, out_t = {}, {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out_j[k], out_t[k] = walk(v)
                continue
            arr = np.asarray(v, np.float32)
            if k.startswith(("maa_", "ln_x_", "conv_")) or k == "b":
                arr = arr + 0.3 * rng.standard_normal(arr.shape).astype(
                    np.float32)
            out_j[k], out_t[k] = jnp.asarray(arr), _t(arr)
        return out_j, out_t

    return walk(jax_tree)


def _x(seed, b, s, d=D, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


@pytest.fixture
def flush_denormals():
    """XLA's CPU flushes subnormal floats to zero; torch's CPU keeps them
    unless asked. A long product of decays underflows, so the scan is
    compared with both flushing."""
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


# ------------------------------------------------------------- RG-LRU

@pytest.mark.parametrize("s", [1, 2, 7, 20, 513])
def test_associative_scan_bit_equals_jax(s, flush_denormals):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 64)).astype(np.float32)
    b = rng.standard_normal((2, s, 64)).astype(np.float32)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                              jnp.asarray(b)), axis=1)
    got = R.associative_scan(R._linear_combine, (_t(a), _t(b)), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_associative_scan_along_another_dim_is_a_prefix_product():
    """Along dim 0 of a 3-d tensor, under a combine of its own: the running
    products, exactly for these powers of two."""
    x = torch.full((9, 2, 3), 2.0)
    (got,) = R.associative_scan(lambda e1, e2: (e1[0] * e2[0],), (x,), 0)
    want = 2.0 ** torch.arange(1, 10, dtype=torch.float32)
    assert torch.equal(got, want[:, None, None].expand(9, 2, 3))


def _rglru(seed=0):
    p, _ = jax_rglru.rglru_init(jax.random.key(seed), D, WIDTH, 4,
                                jnp.float32)
    return _params(p, seed)


@pytest.mark.parametrize("s", [2, 20])
def test_rglru_block_and_state_match_jax(s):
    """S = 2 is shorter than the conv's 3 trailing inputs: the returned
    conv tail is padded with zeros in front."""
    jp, tp = _rglru()
    x = _x(s, 2, s)
    want, wstate = jax_rglru.rglru_block(jp, jnp.asarray(x),
                                         return_state=True)
    got, state = R.rglru_block(tp, _t(x), return_state=True)
    _close(got, want, FN_TOL)
    _close(state.h, wstate.h, FN_TOL)
    _close(state.conv, wstate.conv, FN_TOL)
    assert state.h.dtype == torch.float32
    _close(R.rglru_block(tp, _t(x)), want, FN_TOL)


def test_rglru_decode_step_matches_jax():
    jp, tp = _rglru(1)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, WIDTH)).astype(np.float32)
    conv = rng.standard_normal((2, 3, WIDTH)).astype(np.float32)
    x = _x(5, 2, 1)
    want, ws = jax_rglru.rglru_decode_step(
        jp, jnp.asarray(x), jax_rglru.RGLRUState(jnp.asarray(h),
                                                 jnp.asarray(conv)))
    got, gs = R.rglru_decode_step(tp, _t(x), R.RGLRUState(_t(h), _t(conv)))
    _close(got, want, FN_TOL)
    _close(gs.h, ws.h, FN_TOL)
    _close(gs.conv, ws.conv, FN_TOL)


@pytest.mark.parametrize("s", [2, 19])
def test_rglru_block_then_step_equals_block(s):
    _, tp = _rglru(2)
    x = _t(_x(6, 2, s + 1))
    full = R.rglru_block(tp, x)
    _, state = R.rglru_block(tp, x[:, :s], return_state=True)
    step, _ = R.rglru_decode_step(tp, x[:, s:], state)
    _close(step, full[:, s:].numpy(), STEP_TOL)


def test_rglru_softplus_is_jaxs_above_torchs_threshold():
    """torch's ``softplus`` is the identity above 20; JAX's
    ``logaddexp(x, 0)`` is not."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.9, 20.1, 25.0], np.float32)
    np.testing.assert_array_equal(R._softplus(_t(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


# ------------------------------------------------------------- RWKV-6

def _rwkv(seed=0):
    p, _ = jax_rwkv.rwkv6_init(jax.random.key(seed), D, HS, jnp.float32)
    return _params(p, seed)


def _cmix(seed=0):
    p, _ = jax_rwkv.rwkv6_cmix_init(jax.random.key(seed), D, 128,
                                    jnp.float32)
    return _params(p, seed)


def test_rwkv6_time_mix_and_state_match_jax():
    jp, tp = _rwkv()
    x = _x(7, 2, 20)
    want, (ws, wshift) = jax_rwkv.rwkv6_time_mix(jp, jnp.asarray(x), HS,
                                                 return_state=True)
    got, (gs, gshift) = W.rwkv6_time_mix(tp, _t(x), HS, return_state=True)
    _close(got, want, FN_TOL)
    assert gs.shape == (2, D // HS, HS, HS) and gs.dtype == torch.float32
    _close(gs, ws, FN_TOL)
    _close(gshift, wshift, FN_TOL)
    _close(W.rwkv6_time_mix(tp, _t(x), HS), want, FN_TOL)


def test_rwkv6_time_mix_step_matches_jax():
    jp, tp = _rwkv(1)
    rng = np.random.default_rng(8)
    s = (0.3 * rng.standard_normal((2, D // HS, HS, HS))).astype(np.float32)
    shift = rng.standard_normal((2, D)).astype(np.float32)
    x = _x(9, 2, 1)
    want, ws, wshift = jax_rwkv.rwkv6_time_mix_step(
        jp, jnp.asarray(x), jnp.asarray(s), jnp.asarray(shift), HS)
    got, gs, gshift = W.rwkv6_time_mix_step(tp, _t(x), _t(s), _t(shift), HS)
    _close(got, want, FN_TOL)
    _close(gs, ws, FN_TOL)
    _close(gshift, wshift, FN_TOL)


@pytest.mark.parametrize("with_shift", [False, True])
def test_rwkv6_cmix_matches_jax(with_shift):
    jp, tp = _cmix(2)
    x = _x(10, 2, 1 if with_shift else 20)
    shift = np.random.default_rng(11).standard_normal((2, D)).astype(
        np.float32)
    want, wlast = jax_rwkv.rwkv6_cmix(
        jp, jnp.asarray(x), jnp.asarray(shift) if with_shift else None)
    got, glast = W.rwkv6_cmix(tp, _t(x), _t(shift) if with_shift else None)
    _close(got, want, FN_TOL)
    _close(glast, wlast, FN_TOL)


@pytest.mark.parametrize("s", [1, 19])
def test_rwkv6_block_then_step_equals_block(s):
    _, tp = _rwkv(3)
    _, cp = _cmix(3)
    x = _t(_x(12, 2, s + 1))
    full = W.rwkv6_time_mix(tp, x, HS)
    _, (state, shift) = W.rwkv6_time_mix(tp, x[:, :s], HS,
                                         return_state=True)
    step, _, new_shift = W.rwkv6_time_mix_step(tp, x[:, s:], state, shift,
                                               HS)
    _close(step, full[:, s:].numpy(), STEP_TOL)
    assert torch.equal(new_shift, x[:, s])
    cfull, _ = W.rwkv6_cmix(cp, x)
    _, last = W.rwkv6_cmix(cp, x[:, :s])
    cstep, _ = W.rwkv6_cmix(cp, x[:, s:], shift=last)
    _close(cstep, cfull[:, s:].numpy(), STEP_TOL)


def test_group_norm_uses_the_population_variance():
    """Heads of 4: the unbiased variance is 4/3 of the population one, far
    beyond the bar, so only JAX's ``jnp.var`` passes."""
    jp, tp = _rwkv(4)
    y = _x(13, 2, 5, scale=3.0)
    want = jax_rwkv._group_norm(jp, jnp.asarray(y), D // 4, 4)
    got = W._group_norm(tp, _t(y), D // 4, 4)
    _close(got, want, FN_TOL)
    yh = _t(y).reshape(2, 5, D // 4, 4)
    unbiased = ((yh - yh.mean(-1, keepdim=True))
                * torch.rsqrt(yh.var(-1, keepdim=True) + 1e-5)).reshape(
                    2, 5, D) * tp["ln_x_scale"] + tp["ln_x_bias"]
    assert float((unbiased - _t(want)).abs().max()) > 100 * FN_TOL["atol"]


def test_wkv_recurrence_is_jaxs_step_repeated():
    """The loop, its operands laid out once as batched rows, against JAX's
    step written with its einsums token by token (``rwkv6.py:132-138``)."""
    rng = np.random.default_rng(14)
    r, k, v = (_t(rng.standard_normal((2, 6, 3, 4))) for _ in range(3))
    w = _t(rng.uniform(0.1, 0.99, (2, 6, 3, 4)))
    u = _t(rng.standard_normal((3, 4)))
    ys, final = W.wkv_recurrence(r, k, v, w, u)
    state = torch.zeros((2, 3, 4, 4))
    for t in range(6):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        y = torch.einsum("bhi,bhij->bhj", r[:, t],
                         state + u[None, :, :, None] * kv)
        state = w[:, t][..., None] * state + kv
        _close(ys[:, t], y.numpy(), dict(rtol=1e-6, atol=1e-6))
    _close(final, state.numpy(), dict(rtol=1e-6, atol=1e-6))


# --------------------------------------------------------------- init

def test_param_rng_uniform_draws_f32_and_casts():
    g = torch.Generator().manual_seed(3)
    rng = L.ParamRng(g, "cpu")
    x = rng.uniform((1000,), 0.9, 0.999, torch.float32)
    assert x.dtype == torch.float32
    assert 0.9 <= float(x.min()) and float(x.max()) < 0.999
    g2 = torch.Generator().manual_seed(3)
    y = L.ParamRng(g2, "cpu").uniform((1000,), 0.9, 0.999, torch.bfloat16)
    assert torch.equal(y, x.to(torch.bfloat16))
    meta = L.ParamRng(None, "meta").uniform((7, 5), 0.0, 1.0,
                                            torch.bfloat16)
    assert meta.is_meta and meta.shape == (7, 5)
    assert meta.dtype == torch.bfloat16


def test_recurrent_init_follows_jax():
    """The port's own draws, JAX's constants and distributions: the conv
    passes the current token, Lambda puts a (at r = 1) in (0.9, 0.999),
    the decay base is -1, the group norm starts as the identity and the
    low-rank adapters are normals of std 1e-2, cast to bf16."""
    rng = L.ParamRng(torch.Generator().manual_seed(0), "cpu")
    p, a = R.rglru_init(rng, D, WIDTH, 4, torch.bfloat16)
    assert torch.equal(p["conv_w"][-1],
                       torch.ones(WIDTH, dtype=torch.bfloat16))
    assert not p["conv_w"][:-1].any() and not p["conv_b"].any()
    assert p["lam"].dtype == torch.float32
    a_at_1 = torch.exp(-R.RGLRU_C * R._softplus(p["lam"]))
    assert 0.9 - 1e-6 <= float(a_at_1.min())
    assert float(a_at_1.max()) <= 0.999 + 1e-6
    assert a["gate_a"] == {"w": ("ffn", "ffn2"), "b": ("ffn2",)}
    p, a = W.rwkv6_init(rng, D, HS, torch.bfloat16)
    assert torch.equal(p["decay_base"], torch.full((D,), -1.0))
    assert torch.equal(p["ln_x_scale"], torch.ones(D))
    assert not p["ln_x_bias"].any()
    assert p["tm_w2"].shape == (5, W.LORA_DIM, D)
    assert p["tm_w2"].dtype == torch.bfloat16
    assert abs(float(p["tm_w1"].float().std()) - 1e-2) < 1e-3
    assert a["bonus_u"] == ("heads", None)
    with pytest.raises(ValueError, match="head size"):
        W.rwkv6_init(rng, 60, 8)


@pytest.mark.parametrize("make", ["rglru", "rwkv6"])
def test_empty_states_match_jax(make):
    if make == "rglru":
        got = R.rglru_empty_state(2, WIDTH, 4, torch.bfloat16, device="cpu")
        want = jax_rglru.rglru_empty_state(2, WIDTH, 4, jnp.bfloat16)
    else:
        got = W.rwkv6_empty_state(2, D, HS, device="cpu")
        want = jax_rwkv.rwkv6_empty_state(2, D, HS)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.shape == w.shape and not g.any()
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
