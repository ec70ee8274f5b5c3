"""The port's tree utilities, schedules, AdamW and int8 compression against
the JAX package, on the same inputs made with numpy.

Integer results are exact: parameter counts and bytes, ``OptState.step``,
the NaN flags, and the int8 ``q`` and f32 ``scale`` bits. The float parts
differ from XLA's CPU by ulps (torch and XLA order f32 reductions
differently, and their ``pow`` and ``cos`` differ), so they are held to
bars: the global norm and the schedules ``rtol=1e-6``; AdamW's params and
f32 moments ``rtol=1e-5, atol=1e-6`` over 10 steps; bf16 moments within
one bf16 ulp.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtree
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro_torch.common import tree as ttree
from repro_torch.optim import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    ef_compress_update,
    linear_warmup_cosine,
)
from repro_torch.optim.compression import tree_ef_compress

class Pair(NamedTuple):
    w: object
    b: object


def _np_tree(seed):
    """A nested dict / NamedTuple / list tree of numpy leaves."""
    rng = np.random.default_rng(seed)
    return {
        "layer": Pair(w=rng.standard_normal((6, 5)).astype(np.float32),
                      b=rng.standard_normal(5).astype(np.float32)),
        "emb": rng.standard_normal((7, 3)).astype(np.float32),
        "count": np.arange(4, dtype=np.int32),
        "blocks": [rng.standard_normal((2, 2)).astype(np.float32),
                   rng.standard_normal(3).astype(np.float32)],
    }


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def _bf16(x):
    return x.astype(jnp.bfloat16), torch.from_numpy(np.array(x)).to(
        torch.bfloat16)


def _leaves_np(tree):
    """numpy leaves of a port tree in flattening order (bf16 as f32)."""
    return [x.to(torch.float32).numpy() if x.dtype == torch.bfloat16
            else x.numpy() for x in ttree.tree_leaves(tree)]


def test_tree_leaf_order_and_names_match_jax():
    tree = _np_tree(0)
    want = [(n, np.asarray(x)) for n, x in
            jtree.tree_flatten_with_paths(_to_jax(tree))]
    got = ttree.tree_flatten_with_paths(_to_torch(tree))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_tree_counts_and_bytes_match_jax():
    tree = _np_tree(1)
    jt, tt = _to_jax(tree), _to_torch(tree)
    jt["half"], tt["half"] = _bf16(np.ones((3, 4), np.float32))
    assert ttree.tree_count_params(tt) == jtree.tree_count_params(jt) == 79
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt) == 292
    assert ttree.tree_count_params({}) == jtree.tree_count_params({}) == 0


def test_tree_global_norm_matches_jax():
    for seed in range(3):
        tree = _np_tree(seed)
        tree["count"] = tree["count"].astype(np.float32)
        want = np.asarray(jtree.tree_global_norm(_to_jax(tree)))
        got = ttree.tree_global_norm(_to_torch(tree))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    empty = ttree.tree_global_norm({})
    assert empty.dtype == torch.float32 and float(empty) == 0.0


def test_tree_any_nan_matches_jax_and_ignores_integers():
    tree = _np_tree(2)
    jt, tt = _to_jax(tree), _to_torch(tree)
    assert not bool(ttree.tree_any_nan(tt))
    assert bool(ttree.tree_any_nan(tt)) == bool(jtree.tree_any_nan(jt))
    tree["blocks"][1][2] = np.nan
    assert bool(ttree.tree_any_nan(_to_torch(tree)))
    assert bool(jtree.tree_any_nan(_to_jax(tree)))
    ints = {"a": np.arange(3, dtype=np.int32)}
    assert not bool(ttree.tree_any_nan(_to_torch(ints)))
    assert not bool(jtree.tree_any_nan(_to_jax(ints)))
    assert ttree.tree_any_nan({}).dtype == torch.bool


def test_tree_map_zeros_add_scale_cast_match_jax():
    a, b = _np_tree(3), _np_tree(4)
    for t in (a, b):
        t["count"] = t["count"].astype(np.float32)
    ja, jb, ta, tb = _to_jax(a), _to_jax(b), _to_torch(a), _to_torch(b)
    pairs = [
        (jtree.tree_add(ja, jb), ttree.tree_add(ta, tb)),
        (jtree.tree_scale(ja, 0.37), ttree.tree_scale(ta, 0.37)),
        (jtree.tree_map(lambda x, y: x * y - x, ja, jb),
         ttree.tree_map(lambda x, y: x * y - x, ta, tb)),
    ]
    for want, got in pairs:
        for w, g in zip(jax.tree_util.tree_leaves(want), _leaves_np(got)):
            np.testing.assert_array_equal(g, np.asarray(w))
    zeros = ttree.tree_zeros_like(ta, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 and not x.any()
               for x in ttree.tree_leaves(zeros))
    assert [tuple(x.shape) for x in ttree.tree_leaves(zeros)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(ja)]
    cast = ttree.tree_cast(ta, torch.bfloat16)
    for w, g in zip(jax.tree_util.tree_leaves(
            jtree.tree_cast(ja, jnp.bfloat16)), _leaves_np(cast)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    with pytest.raises(ValueError):
        ttree.tree_map(torch.add, ta, {"x": ta["emb"]})


@pytest.mark.parametrize("total,final_frac", [(50, 0.1), (1, 0.0),
                                              (37, 0.25)])
def test_cosine_schedule_matches_jax(total, final_frac):
    steps = np.arange(total + 6, dtype=np.int32)
    want = np.asarray(jsched.cosine_schedule(jnp.asarray(steps), total,
                                             final_frac))
    got = cosine_schedule(torch.from_numpy(steps), total, final_frac)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 50), (0, 20), (7, 7)])
def test_linear_warmup_cosine_matches_jax(warmup, total):
    steps = np.arange(total + 6, dtype=np.int32)
    want = np.asarray(jsched.linear_warmup_cosine(jnp.asarray(steps), warmup,
                                                  total))
    got = linear_warmup_cosine(torch.from_numpy(steps), warmup, total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    one = linear_warmup_cosine(torch.tensor(3, dtype=torch.int32), warmup,
                               total)
    assert one.shape == () and float(one) == float(got[3])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 bits of mantissa)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _adamw_runs(cfg_kw, steps=10, seed=0, lr_scale=1.0):
    """10 AdamW steps on {matrix [64, 32], vector [32]} in both packages,
    the same numpy gradients each step."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((64, 32)).astype(np.float32),
              "b": rng.standard_normal(32).astype(np.float32)}
    grads = [{"w": (rng.standard_normal((64, 32)) * 0.5).astype(np.float32),
              "b": (rng.standard_normal(32) * 2.0).astype(np.float32)}
             for _ in range(steps)]
    jcfg = jadamw.AdamWConfig(**cfg_kw)
    tcfg = AdamWConfig(**cfg_kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    out = []
    for g in grads:
        jp, js, jm = jadamw.adamw_update(jp, _to_jax(g), js, jcfg, lr_scale)
        tp, ts, tm = adamw_update(tp, _to_torch(g), ts, tcfg, lr_scale)
        out.append((jp, js, jm, tp, ts, tm))
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_matches_jax_over_10_steps(moment_dtype, grad_clip):
    runs = _adamw_runs(dict(moment_dtype=moment_dtype, grad_clip=grad_clip))
    worst = {"params": 0.0, "moments": 0.0}
    for jp, js, jm, tp, ts, tm in runs:
        assert isinstance(ts, OptState)
        assert ts.step.dtype == torch.int32 and ts.step.shape == ()
        assert int(ts.step) == int(js.step)
        for want, got in zip(jax.tree_util.tree_leaves(jp),
                             ttree.tree_leaves(tp)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
            worst["params"] = max(worst["params"], float(np.max(np.abs(
                got.numpy() - np.asarray(want)))))
        for jm_, tm_ in ((js.mu, ts.mu), (js.nu, ts.nu)):
            for want, got in zip(jax.tree_util.tree_leaves(jm_),
                                 ttree.tree_leaves(tm_)):
                assert str(got.dtype) == f"torch.{moment_dtype}"
                w = np.asarray(want, np.float32)
                g = got.to(torch.float32).numpy()
                if moment_dtype == "float32":
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
                else:
                    assert np.all(np.abs(g - w) <= _bf16_ulp(w)), \
                        np.max(np.abs(g - w) / _bf16_ulp(w))
                worst["moments"] = max(worst["moments"],
                                       float(np.max(np.abs(g - w))))
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        assert tm["lr"].dtype == torch.float32
    print(f"max |port - JAX|: {worst}")


def test_adamw_schedule_scale_matches_jax():
    """``lr_scale`` given as a schedule's f32 tensor, as a train step
    would."""
    total = 10
    jcfg, tcfg = jadamw.AdamWConfig(), AdamWConfig()
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32)}
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for i in range(total):
        g = {"w": rng.standard_normal((8, 4)).astype(np.float32)}
        jscale = jsched.linear_warmup_cosine(js.step, 3, total)
        tscale = linear_warmup_cosine(ts.step, 3, total)
        jp, js, jm = jadamw.adamw_update(jp, _to_jax(g), js, jcfg, jscale)
        tp, ts, tm = adamw_update(tp, _to_torch(g), ts, tcfg, tscale)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-6)
    assert int(ts.step) == int(js.step) == total


def test_adamw_weight_decay_touches_only_matrices():
    """With zero gradients the moments stay 0 and the update is the decay
    alone: the matrix shrinks by lr * wd, the vector does not move."""
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((64, 32)).astype(np.float32),
              "b": rng.standard_normal(32).astype(np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    cfg = AdamWConfig(lr=0.01, weight_decay=0.5)
    tp = _to_torch(params)
    new, state, _ = adamw_update(tp, _to_torch(zeros), adamw_init(tp, cfg),
                                 cfg)
    np.testing.assert_array_equal(new["b"].numpy(), params["b"])
    np.testing.assert_allclose(new["w"].numpy(),
                               params["w"] - 0.01 * 0.5 * params["w"],
                               rtol=1e-6)
    jcfg = jadamw.AdamWConfig(lr=0.01, weight_decay=0.5)
    jnew, _, _ = jadamw.adamw_update(_to_jax(params), _to_jax(zeros),
                                     jadamw.adamw_init(_to_jax(params), jcfg),
                                     jcfg)
    for k in params:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-6)
    # the inputs are left alone (the update is functional)
    np.testing.assert_array_equal(tp["w"].numpy(), params["w"])
    assert int(state.step) == 1


def test_adamw_checkpoint_leaf_names_match_jax():
    """The optimizer state flattens to JAX's leaf names and dtypes, so a
    train state's checkpoint crosses between the packages."""
    params = {"w": np.ones((4, 2), np.float32), "b": np.ones(2, np.float32)}
    for md in ("float32", "bfloat16"):
        js = jadamw.adamw_init(_to_jax(params),
                               jadamw.AdamWConfig(moment_dtype=md))
        ts = adamw_init(_to_torch(params), AdamWConfig(moment_dtype=md))
        want = [(n, str(np.asarray(x).dtype)) for n, x in
                jtree.tree_flatten_with_paths(js)]
        got = [(n, str(x.dtype).replace("torch.", "")) for n, x in
               ttree.tree_flatten_with_paths(ts)]
        assert got == want
        assert [n for n, _ in got] == ["step", "mu/b", "mu/w", "nu/b",
                                       "nu/w"]


def test_adamw_refuses_an_unknown_moment_dtype():
    with pytest.raises(ValueError, match="moment_dtype"):
        adamw_init({"w": torch.ones(2)}, AdamWConfig(moment_dtype="fp8"))


# -- int8 error-feedback compression (tests/test_distributed.py's three,
# on numpy inputs, then bit-equality with JAX) ---------------------------

class TestCompression:
    def test_roundtrip_error_bounded(self):
        x = torch.from_numpy(
            np.random.default_rng(0).standard_normal(512).astype(
                np.float32) * 3)
        q, s = compress_int8(x)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        err = (decompress_int8(q, s) - x).abs()
        assert float(err.max()) <= float(s) / 2 + 1e-6

    def test_error_feedback_accumulates_to_zero_bias(self):
        """EF: the *sum* of compressed estimates tracks the sum of
        grads."""
        rng = np.random.default_rng(1)
        err = torch.zeros(256)
        total_est = torch.zeros(256)
        total_g = torch.zeros(256)
        for _ in range(50):
            g = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
            est, err = ef_compress_update(g, err)
            total_est += est
            total_g += g
        np.testing.assert_allclose((total_g - total_est).numpy(),
                                   err.numpy(), rtol=1e-4, atol=1e-4)

    def test_tree_compress_structure(self):
        grads = {"a": torch.ones((8, 8)), "b": torch.full((4,), 2.0)}
        errors = ttree.tree_map(torch.zeros_like, grads)
        est, new_err = tree_ef_compress(grads, errors)
        assert set(est) == {"a", "b"} and set(new_err) == {"a", "b"}
        np.testing.assert_allclose(est["a"].numpy(), 1.0, rtol=1e-2)


def _compression_inputs():
    rng = np.random.default_rng(11)
    xs = [(rng.standard_normal(4096) * s).astype(np.float32)
          for s in (1e-6, 0.37, 3.0, 1e4)]
    # values landing on x / scale = k + 0.5 (round half to even), zeros,
    # one value far above the rest, and a 2-D leaf
    half = np.float32(127.0) / np.arange(1, 128, dtype=np.float32)
    xs.append(np.concatenate([half * np.float32(0.5), [127.0, -127.0]])
              .astype(np.float32))
    xs.append(np.zeros(64, np.float32))
    spike = rng.standard_normal(1000).astype(np.float32)
    spike[17] = 1e6
    xs.append(spike)
    xs.append(rng.standard_normal((33, 17)).astype(np.float32))
    return xs


@pytest.mark.parametrize("i", range(8))
def test_compress_int8_bits_equal_jax(i):
    x = _compression_inputs()[i]
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().view(np.uint32) == np.asarray(js).view(np.uint32)
    np.testing.assert_array_equal(
        decompress_int8(tq, ts).numpy().view(np.uint32),
        np.asarray(jcomp.decompress_int8(jq, js)).view(np.uint32))


def test_error_feedback_bits_equal_jax_over_steps():
    rng = np.random.default_rng(3)
    shapes = {"a": (16, 8), "b": (5,)}
    jerr = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    terr = {k: torch.zeros(s) for k, s in shapes.items()}
    for _ in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jest, jerr = jcomp.tree_ef_compress(_to_jax(g), jerr)
        test, terr = tree_ef_compress(_to_torch(g), terr)
        for k in shapes:
            for a, b in ((test[k], jest[k]), (terr[k], jerr[k])):
                np.testing.assert_array_equal(
                    a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
