"""The port's ten configurations against the JAX package's.

The published numbers (``tests/test_arch_smoke.py:67-105``), the derived
numbers of all ten configs equal to JAX's, and, for all ten at full
size, the port's ``init_params`` on the ``meta`` device (no memory:
grok-1 is 315,684,034,560 parameters) against ``jax.eval_shape`` of
JAX's: leaf paths, shapes and dtypes exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as jax_T

from repro_torch.common.tree import tree_count_params, tree_flatten_with_paths
from repro_torch.configs import ALIASES, all_arch_ids, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T

ARCHS = all_arch_ids()
ATTN_ARCHS = [a for a in ARCHS if a not in ("recurrentgemma_2b", "rwkv6_7b")]


def test_registry_matches_jax():
    from repro import configs as jax_configs

    assert ARCHS == jax_configs.all_arch_ids()
    assert ALIASES == jax_configs.ALIASES
    assert get_config("llama3-8b") == get_config("llama3_8b")
    assert get_config("qwen1.5-4b").name == "qwen1.5-4b"


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_assignment(arch):
    """Pin the published numbers so config drift fails loudly."""
    cfg = get_config(arch)
    expect = {
        "granite_moe_1b_a400m": (24, 1024, 16, 8, 512, 49155),
        "grok_1_314b": (64, 6144, 48, 8, 32768, 131072),
        "recurrentgemma_2b": (26, 2560, 10, 1, 7680, 256000),
        "internvl2_1b": (24, 896, 14, 2, 4864, 151655),
        "rwkv6_7b": (32, 4096, 64, 64, 14336, 65536),
        "gemma2_2b": (26, 2304, 8, 4, 9216, 256000),
        "granite_20b": (52, 6144, 48, 1, 24576, 49152),
        "llama3_8b": (32, 4096, 32, 8, 14336, 128256),
        "qwen1_5_4b": (40, 2560, 20, 20, 6912, 151936),
        "whisper_small": (12, 768, 12, 12, 3072, 51865),
    }[arch]
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size)
    assert got == expect, (arch, got, expect)


def test_moe_expert_counts():
    g = get_config("granite_moe_1b_a400m")
    assert (g.num_experts, g.num_experts_per_tok) == (32, 8)
    k = get_config("grok_1_314b")
    assert (k.num_experts, k.num_experts_per_tok) == (8, 2)


def test_param_counts_in_expected_range():
    grok = get_config("grok_1_314b")
    assert 280e9 < grok.num_params_total < 360e9, grok.num_params_total
    assert 60e9 < grok.num_params_active < 110e9, grok.num_params_active
    llama = get_config("llama3_8b")
    assert 7e9 < llama.num_params_total < 9.5e9, llama.num_params_total
    rg = get_config("recurrentgemma_2b")
    assert 2e9 < rg.num_params_total < 4.5e9, rg.num_params_total


def test_long_context_applicability():
    assert get_config("recurrentgemma_2b").supports_long_context
    assert get_config("rwkv6_7b").supports_long_context
    for a in ATTN_ARCHS:
        assert not get_config(a).supports_long_context, a


DERIVED = ("num_params_total", "num_params_active", "padded_vocab",
           "uniform_period", "supports_long_context", "is_attention_free",
           "resolved_head_dim")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, smoke):
    """Every field and every derived number equal to JAX's."""
    ours = (get_smoke_config if smoke else get_config)(arch)
    theirs = (jax_get_smoke_config if smoke else jax_get_config)(arch)
    assert vars(ours) == vars(theirs)
    for name in DERIVED:
        assert getattr(ours, name) == getattr(theirs, name), name
    for layer in range(ours.num_layers):
        assert ours.mixer_of(layer) == theirs.mixer_of(layer)
        assert ours.mlp_of(layer) == theirs.mlp_of(layer)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_equals_jax_eval_shape(arch):
    """Leaf paths, shapes and dtypes of the full config, with no memory;
    the logical axes tree equal to JAX's."""
    cfg = get_config(arch)
    params, axes = T.init_params(cfg, device="meta")
    flat = tree_flatten_with_paths(params)
    assert all(x.is_meta for _, x in flat)
    got = [(name, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for name, x in flat]
    jax_axes = []

    def init(key):
        p, a = jax_T.init_params(key, jax_get_config(arch))
        jax_axes.append(a)
        return p

    shapes = jax.eval_shape(init, jax.random.key(0))
    want = [(name, tuple(x.shape), str(np.dtype(x.dtype)))
            for name, x in jax_flatten(shapes)]
    assert got == want
    assert axes == jax_axes[0]
    if arch == "grok_1_314b":
        assert tree_count_params(params) == 315_684_034_560
    if arch == "recurrentgemma_2b":
        assert tree_count_params(params) == 2_894_574_080
    if arch == "rwkv6_7b":
        assert tree_count_params(params) == 7_577_018_368


def test_meta_tensors_hold_no_memory():
    params, _ = T.init_params(get_config("grok_1_314b"), device="meta")
    leaf = params["layers"][0]["mlp"]["gate"]
    assert leaf.shape == (64, 8, 6144, 32768) and leaf.is_meta
    assert leaf.dtype == torch.bfloat16
