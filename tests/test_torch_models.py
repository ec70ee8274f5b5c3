"""The port's model forward against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, and JAX's ``init_params``
leaves carried across by path name (``models/convert.py``) go through
both. The bars are JAX's own (``tests/test_models.py``): logits of the f32
smoke configs within rtol = atol = 2e-3, MoE within 2e-2 after the
router's expert choices are compared exactly, flash attention within 2e-4
of a naive attention; integer results (shapes, leaf names, router choices,
dropped tokens) exact.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import mlp as jax_mlp
from repro.models import transformer as jax_T

from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, params_to_numpy

ARCHS = ["granite_moe_1b_a400m", "grok_1_314b", "recurrentgemma_2b",
         "internvl2_1b", "rwkv6_7b", "gemma2_2b", "granite_20b",
         "llama3_8b", "qwen1_5_4b", "whisper_small"]
CPU = torch.device("cpu")
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
MOE_TOL = dict(rtol=2e-2, atol=2e-2)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want, tol) -> float:
    """Assert closeness under ``tol``; return the largest |difference|."""
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, **tol)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def f32(cfg, moe_capacity_factor=8.0):
    """``tests/test_models.py``'s ``f32_cfg``, for either package's config."""
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg,
                                  moe_capacity_factor=moe_capacity_factor)
    return cfg


def make_batch(cfg, b=2, s=20, seed=3, dtype=np.float32):
    """Tokens, labels and the prefix inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["patches"] = (0.1 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(dtype)
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(dtype)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: _t(v) for k, v in batch.items()}


def jax_params(cfg, seed=0):
    p, _ = jax_T.init_params(jax.random.key(seed), cfg)
    return p, {name: np.asarray(x) for name, x in jax_flatten(p)}


@contextlib.contextmanager
def recorded_routes():
    """Record each MoE layer's expert choices in both packages' forward:
    JAX's through ``jax.debug.callback`` (the layers run inside
    ``lax.scan``), the port's directly. Yields ``(jax_list, port_list)``
    of ``[n, g, k]`` int arrays in call order."""
    jax_rec, port_rec = [], []
    real_jax, real_port = jax_mlp.moe_apply, M.moe_apply

    def jax_moe(p, x, *, num_experts, top_k, group_size=256, **kw):
        b, s, d = x.shape
        g = min(group_size, b * s)
        logits = jnp.einsum("ngd,de->nge",
                            x.reshape(-1, g, d).astype(jnp.float32),
                            p["router"])
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
        jax.debug.callback(lambda i: jax_rec.append(np.asarray(i)), idx)
        return real_jax(p, x, num_experts=num_experts, top_k=top_k,
                        group_size=group_size, **kw)

    def port_moe(p, x, *, num_experts, top_k, group_size=256, **kw):
        n, g = M.moe_groups(x.shape[0] * x.shape[1], group_size)
        _, _, idx = M.moe_route(p["router"], x.reshape(n, g, -1), top_k)
        port_rec.append(idx.numpy())
        return real_port(p, x, num_experts=num_experts, top_k=top_k,
                         group_size=group_size, **kw)

    jax_mlp.moe_apply, M.moe_apply = jax_moe, port_moe
    try:
        yield jax_rec, port_rec
    finally:
        jax_mlp.moe_apply, M.moe_apply = real_jax, real_port


@functools.lru_cache(maxsize=None)
def jax_case(arch, num_layers=None):
    """JAX's f32 smoke model on make_batch's inputs: flat params, batch,
    logits, loss, metrics and its MoE layers' expert choices."""
    cfg = f32(jax_smoke_config(arch))
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    p, flat = jax_params(cfg)
    batch = make_batch(cfg)
    with recorded_routes() as (routes, _):
        logits = np.asarray(jax_T.forward(p, cfg, to_jax(batch)))
        jax.effects_barrier()
    loss, metrics = jax_T.lm_loss(p, cfg, to_jax(batch))
    return dict(flat=flat, batch=batch, logits=logits, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                routes=list(routes))


def port_cfg(arch, num_layers=None):
    cfg = f32(get_smoke_config(arch))
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg


# --------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms_match_jax(kind, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 0.5
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "rms":
        want = jax_layers.rmsnorm({"scale": jnp.asarray(scale, jdt)},
                                  jnp.asarray(x, jdt), 1e-6)
        got = L.rmsnorm({"scale": _t(scale).to(tdt)}, _t(x).to(tdt), 1e-6)
    else:
        want = jax_layers.layernorm({"scale": jnp.asarray(scale, jdt),
                                     "bias": jnp.asarray(bias, jdt)},
                                    jnp.asarray(x, jdt), 1e-6)
        got = L.layernorm({"scale": _t(scale).to(tdt),
                           "bias": _t(bias).to(tdt)}, _t(x).to(tdt), 1e-6)
    assert got.dtype == tdt
    # f32: a few f32 ulps; bf16: one bf16 ulp of values up to ~10
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=8e-3, atol=8e-3)
    _close(got, np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    pos = np.array([[0, 1, 2, 100, 1000, 4095, 8191, 16384, 32768]] * 2,
                   np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_array_equal(
        L.rope_freqs(64, theta).numpy(),
        np.asarray(jax_layers.rope_freqs(64, theta)))
    # the angles are the same f32 products; sin and cos of angles up to
    # 32,768 rad may differ in their last f32 bits between the libraries
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_matches_jax(cap, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    table = rng.standard_normal((512, 64)).astype(np.float32) * 2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_layers.unembed({"table": jnp.asarray(table, jdt)},
                              jnp.asarray(x, jdt), cap)
    got = L.unembed({"table": _t(table).to(tdt)}, _t(x).to(tdt), cap)
    assert got.dtype == torch.float32
    # bf16 logits carry bf16 precision (the product runs in bf16): one
    # bf16 ulp
    tol = LOGIT_TOL if dtype == "float32" else dict(rtol=8e-3, atol=1e-3)
    _close(got, want, tol)


def test_dense_with_bias_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = jax_layers.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                            jnp.asarray(x))
    got = L.dense({"w": _t(w), "b": _t(b)}, _t(x))
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


# ------------------------------------------------------------ attention

def naive_attention(q, k, v, kind, window=0, cap=None, q_offset=0):
    """``tests/test_models.py``'s naive attention, in torch (f32)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) \
        * d ** -0.5
    if cap:
        s = torch.tanh(s / cap) * cap
    qpos = q_offset + torch.arange(sq)
    kpos = torch.arange(k.shape[1])
    m = torch.ones((sq, k.shape[1]), dtype=torch.bool)
    if kind == "causal":
        m = kpos[None] <= qpos[:, None]
    if kind == "local":
        m = (kpos[None] <= qpos[:, None]) & (kpos[None] > qpos[:, None]
                                             - window)
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, -1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


FLASH_CASES = [
    (128, 128, 8, 4, "causal", 0, None, 0),
    (100, 100, 8, 8, "causal", 0, 30.0, 0),
    (64, 64, 4, 1, "local", 16, None, 0),
    (128, 128, 8, 2, "bidir", 0, None, 0),
    (7, 135, 6, 2, "causal", 0, None, 128),
    (1, 1, 2, 1, "causal", 0, None, 0),
    # query rows 56..95 see no key of the leading kv chunk (0..47), and the
    # q_offset rows 144..159 none of chunks 0..1: m = -1e30 until the
    # first unmasked chunk
    (96, 96, 4, 2, "local", 8, None, 0),
    (16, 160, 4, 2, "local", 16, 50.0, 144),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax_and_naive(case):
    sq, sk, hq, hkv, kind, window, cap, qo = case
    rng = np.random.default_rng(sq + sk + hq)
    q = rng.standard_normal((2, sq, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
    kw = dict(kind=kind, window=window, attn_softcap=cap, q_offset=qo,
              q_chunk=32, kv_chunk=48)
    got = A.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    assert got.shape == (2, sq, hq, 16) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    tol = dict(rtol=2e-4, atol=2e-4)
    _close(got, want, tol)
    _close(got, naive_attention(_t(q), _t(k), _t(v), kind, window, cap, qo)
           .numpy(), tol)


def test_flash_attention_bf16_matches_jax():
    """At bf16: f32 scores, probabilities cast to bf16 before P·V, the
    output cast back to bf16."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 70, 4, 16)).astype(np.float32)
               for _ in range(3))
    kw = dict(kind="causal", attn_softcap=50.0, q_chunk=32, kv_chunk=48)
    got = A.flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                            **kw)
    want = jax_attn.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want, dict(rtol=2e-2, atol=2e-2))


def _cache_inputs(seed, b=2, smax=12, hkv=2, hq=4, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, hq, d)).astype(np.float32),
            rng.standard_normal((b, smax, hkv, d)).astype(np.float32),
            rng.standard_normal((b, smax, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("length", [1, 7, 12])
def test_decode_attention_matches_jax(length):
    q, k, v = _cache_inputs(length)
    want = jax_attn.decode_attention(
        jnp.asarray(q), jax_attn.KVCache(jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(length, jnp.int32)),
        attn_softcap=30.0)
    got = A.decode_attention(
        _t(q), A.KVCache(_t(k), _t(v), torch.tensor(length,
                                                    dtype=torch.int32)),
        attn_softcap=30.0)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("length", [3, 8, 21])
def test_ring_cache_and_decode_attention_ring_match_jax(length):
    """Write ``length`` tokens into a ring of 8 slots with both packages,
    then attend the last with a window of 5."""
    q, k, v = _cache_inputs(length, smax=length)
    jc = jax_attn.empty_ring_cache(2, 8, 2, 16, jnp.float32)
    tc = A.empty_ring_cache(2, 8, 2, 16, torch.float32, device="cpu")
    for i in range(length):
        jc = jax_attn.update_ring_cache(jc, jnp.asarray(k[:, i:i + 1]),
                                        jnp.asarray(v[:, i:i + 1]))
        tc = A.update_ring_cache(tc, _t(k[:, i:i + 1]), _t(v[:, i:i + 1]))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jax_attn.decode_attention_ring(jnp.asarray(q), jc, 5)
    got = A.decode_attention_ring(_t(q), tc, 5)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))


def test_full_cache_update_and_prefill_match_jax():
    _, k, v = _cache_inputs(9, smax=6)
    jc = jax_attn.empty_cache(2, 10, 2, 16, jnp.float32)
    tc = A.empty_cache(2, 10, 2, 16, torch.float32, device="cpu")
    jc = jax_attn.prefill_into_cache(jc, jnp.asarray(k[:, :4]),
                                     jnp.asarray(v[:, :4]), 4)
    tc = A.prefill_into_cache(tc, _t(k[:, :4]), _t(v[:, :4]), 4)
    for i in (4, 5):
        jc = jax_attn.update_cache(jc, jnp.asarray(k[:, i:i + 1]),
                                   jnp.asarray(v[:, i:i + 1]))
        tc = A.update_cache(tc, _t(k[:, i:i + 1]), _t(v[:, i:i + 1]))
    for a, b in zip(tc, jc):
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ MLP, MoE

def _leaves_to_torch(tree):
    return {k: _leaves_to_torch(v) if isinstance(v, dict)
            else _t(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_jax(kind):
    p, _ = jax_mlp.mlp_init(jax.random.key(7), 64, 128, kind, jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jax_mlp.mlp_apply(p, jnp.asarray(x), kind)
    got = M.mlp_apply(_leaves_to_torch(p), _t(x), kind)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_apply_matches_jax(capacity_factor):
    """Expert choices and the dropped fraction exact (1.25 drops tokens,
    8.0 none), then outputs and metrics within the MoE bar."""
    e, k, g = 4, 2, 16
    p, _ = jax_mlp.moe_init(jax.random.key(8), 64, 32, e, jnp.float32)
    x = np.random.default_rng(7).standard_normal((2, 24, 64)).astype(
        np.float32)
    kw = dict(num_experts=e, top_k=k, capacity_factor=capacity_factor,
              group_size=g, return_metrics=True)
    want, wm = jax_mlp.moe_apply(p, jnp.asarray(x), **kw)
    tp = _leaves_to_torch(p)
    got, gm = M.moe_apply(tp, _t(x), **kw)

    xg = jnp.asarray(x).reshape(-1, g, 64)
    logits = jnp.einsum("ngd,de->nge", xg, p["router"])
    _, want_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    _, _, got_idx = M.moe_route(tp["router"], _t(x).reshape(-1, g, 64), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    dropped = float(wm["moe_dropped_frac"])
    assert float(gm["moe_dropped_frac"]) == dropped
    assert (dropped > 0) == (capacity_factor < 2), dropped
    _close(got, want, MOE_TOL)
    for key in ("moe_aux_loss", "moe_top1_load_max"):
        _close(gm[key], wm[key], dict(rtol=1e-5, atol=1e-6))


def test_moe_top_k_breaks_ties_to_the_lower_index():
    router = torch.zeros((8, 4))                      # every prob 1/4
    _, gates, idx = M.moe_route(router, torch.ones((1, 3, 8)), 2)
    assert idx.tolist() == [[[0, 1]] * 3]
    assert torch.equal(gates, torch.full((1, 3, 2), 0.5))


def test_moe_groups_must_divide_the_tokens():
    with pytest.raises(ValueError, match="groups of 64"):
        M.moe_groups(100, 64)
    assert M.moe_groups(40, 64) == (1, 40)


# -------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    """The ten architectures at f32 smoke width from JAX's params: MoE
    expert choices exact first, then logits and the loss."""
    case = jax_case(arch)
    cfg = port_cfg(arch)
    p = params_from_numpy(case["flat"], cfg, device="cpu")
    batch = to_torch(case["batch"])
    with recorded_routes() as (_, routes):
        logits = T.forward(p, cfg, batch)
    assert len(routes) == len(case["routes"]) == (
        cfg.num_layers if cfg.family == "moe" else 0)
    for got, want in zip(routes, case["routes"]):
        np.testing.assert_array_equal(got, want)
    tol = MOE_TOL if cfg.family == "moe" else LOGIT_TOL
    assert logits.shape == case["logits"].shape == (
        2, 20, cfg.padded_vocab)
    _close(logits, case["logits"], tol)
    loss, metrics = T.lm_loss(p, cfg, batch)
    _close(loss, case["loss"], tol)
    assert float(metrics["tokens"]) == case["metrics"]["tokens"] == 40
    _close(metrics["logit_max"], case["metrics"]["logit_max"], tol)


def test_per_layer_path_matches_jax():
    """gemma2 smoke at 3 layers: the period 2 does not divide 3, so the
    layers are a per-layer list in both packages."""
    case = jax_case("gemma2_2b", num_layers=3)
    cfg = port_cfg("gemma2_2b", num_layers=3)
    assert cfg.uniform_period == 3
    p = params_from_numpy(case["flat"], cfg, device="cpu")
    assert isinstance(p["layers"], list) and len(p["layers"]) == 3
    assert p["layers"][0]["mixer"]["wq"]["w"].dim() == 2
    _close(T.forward(p, cfg, to_torch(case["batch"])), case["logits"],
           LOGIT_TOL)


def test_params_cross_both_ways():
    """JAX's leaves -> the port's tree -> numpy give the same names,
    shapes and values; a bf16 tree crosses exactly; a missing or
    misshapen leaf is refused."""
    case = jax_case("gemma2_2b")
    cfg = port_cfg("gemma2_2b")
    back = params_to_numpy(params_from_numpy(case["flat"], cfg,
                                             device="cpu"))
    assert list(back) == list(case["flat"])
    for name, arr in case["flat"].items():
        np.testing.assert_array_equal(back[name], arr)
    bf_cfg = jax_smoke_config("llama3_8b")
    _, flat = jax_params(bf_cfg)
    assert flat["embed/table"].dtype.name == "bfloat16"
    p = params_from_numpy(flat, get_smoke_config("llama3_8b"), device="cpu")
    assert p["layers"][0]["mlp"]["up"]["w"].dtype == torch.bfloat16
    for name, arr in params_to_numpy(p).items():
        np.testing.assert_array_equal(arr, flat[name].astype(np.float32))
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "embed/table"},
                          get_smoke_config("llama3_8b"), device="cpu")
    bad = dict(flat, **{"embed/table": flat["embed/table"][:, :3]})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, get_smoke_config("llama3_8b"), device="cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_7b"])
def test_recurrent_params_cross_both_ways(arch):
    """recurrentgemma's per-layer list (5 smoke layers, period 3) and
    rwkv6's stacked slot cross by path name and back unchanged, in JAX's
    leaf order; the recurrent leaves are where JAX puts them."""
    case = jax_case(arch)
    cfg = port_cfg(arch)
    p = params_from_numpy(case["flat"], cfg, device="cpu")
    back = params_to_numpy(p)
    assert list(back) == list(case["flat"])
    for name, arr in case["flat"].items():
        np.testing.assert_array_equal(back[name], arr)
    if arch == "recurrentgemma_2b":
        assert isinstance(p["layers"], list) and len(p["layers"]) == 5
        assert p["layers"][0]["mixer"]["lam"].shape == (cfg.lru_width,)
        assert "wq" in p["layers"][2]["mixer"]
    else:
        assert len(p["layers"]) == 1
        assert p["layers"][0]["mixer"]["tm_w2"].shape == (
            2, 5, 32, cfg.d_model)
        assert p["layers"][0]["mlp"]["maa_k"].dtype == torch.float32


def test_language_model_module_names_and_forward():
    case = jax_case("whisper_small")
    cfg = port_cfg("whisper_small")
    model = T.LanguageModel(cfg, params_from_numpy(case["flat"], cfg,
                                                   device="cpu"))
    names = sorted(model.state_dict())
    assert names == sorted(n.replace("/", ".") for n in case["flat"])
    assert all(not p.requires_grad for p in model.parameters())
    _close(model(to_torch(case["batch"])), case["logits"], LOGIT_TOL)
    fresh = T.LanguageModel(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    assert sorted(fresh.state_dict()) == names


def test_init_draws_jax_distributions():
    """The port's own draws from JAX's distributions: one generator seed
    gives one tree, norms start at their init values, the router is f32
    and the expert weights have JAX's scale."""
    cfg = get_smoke_config("granite_moe_1b_a400m")
    a, axes = T.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    b, _ = T.init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    for x, y in zip(params_to_numpy(a).values(),
                    params_to_numpy(b).values()):
        np.testing.assert_array_equal(x, y)
    lp = a["layers"][0]
    assert torch.equal(lp["norm1"]["scale"], torch.ones_like(
        lp["norm1"]["scale"]))
    assert lp["mlp"]["router"].dtype == torch.float32
    w = lp["mlp"]["gate"].to(torch.float32)
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.02
    assert axes["layers"][0]["mlp"]["gate"] == ("experts", "embed", "ffn")


# ----------------------------------------------------- causality, smoke

@pytest.mark.parametrize("arch", ARCHS)
def test_causality(arch):
    """Changing the last token never changes earlier logits."""
    cfg = port_cfg(arch)
    p, _ = T.init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    batch = to_torch(make_batch(cfg))
    logits1 = T.forward(p, cfg, batch)
    toks = batch["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 7) % cfg.vocab_size
    logits2 = T.forward(p, cfg, {**batch, "tokens": toks})
    torch.testing.assert_close(logits1[:, :-1], logits2[:, :-1],
                               rtol=1e-5, atol=1e-5)


def test_vocab_padding_never_predicted():
    cfg = port_cfg("granite_moe_1b_a400m")
    full = dataclasses.replace(cfg, vocab_size=49155)
    assert full.padded_vocab == 49664 > full.vocab_size
    p, _ = T.init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    loss, m = T.lm_loss(p, cfg, to_torch(make_batch(cfg)))
    assert np.isfinite(float(loss))
    # a padded id as the gold label scores -1e30: its loss is enormous
    pad = cfg.padded_vocab - 1
    assert pad >= cfg.vocab_size
    labels = torch.full((2, 20), pad, dtype=torch.int32)
    big, _ = T.lm_loss(p, cfg, {**to_torch(make_batch(cfg)),
                                "labels": labels})
    assert float(big) > 1e29
    # invalid (negative) labels count for nothing
    none, nm = T.lm_loss(p, cfg, {**to_torch(make_batch(cfg)),
                                  "labels": torch.full((2, 20), -1)})
    assert float(none) == 0.0 and float(nm["tokens"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite_bf16(arch):
    """``tests/test_arch_smoke.py``'s forward at the configs' bf16."""
    cfg = get_smoke_config(arch)
    assert cfg.param_dtype == "bfloat16"
    p, _ = T.init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    batch = to_torch(make_batch(cfg, s=16, dtype=np.float32))
    logits = T.forward(p, cfg, batch)
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


def test_fused_prefill_waits_for_9d():
    """ROADMAP item 9d (steps and decoding) has landed: ``collect_len``
    no longer raises; the block returns its output unchanged beside the
    layer's decode cache (``tests/test_torch_decoding.py`` holds the
    caches against JAX's)."""
    cfg = port_cfg("llama3_8b")
    p, _ = T.init_params(cfg, device="cpu")
    lp = T._index(p["layers"][0], 0)
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, cache = T.block_apply(lp, cfg, 0, x, collect_len=8)
    torch.testing.assert_close(y, T.block_apply(lp, cfg, 0, x), rtol=0,
                               atol=0)
    assert cache["kind_attn"].k.shape == (1, 8, cfg.num_kv_heads,
                                          cfg.resolved_head_dim)
    assert int(cache["kind_attn"].length) == 4
