"""The port's sharding rules against the JAX package's.

A mesh is its axis shape in the port (a dict); JAX's ``spec_for`` reads
only ``mesh.shape``, so it is handed an object with that dict. Specs are
compared as tuples: the port's tuple against JAX's ``PartitionSpec``.
"""

import itertools
import types

import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import sharding as jax_sharding
from repro.models import transformer as jax_T

from repro_torch.configs import get_smoke_config
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

MESHES = [
    {"data": 1},
    {"data": 2, "model": 16},
    {"data": 16, "model": 2},
    {"pod": 2, "data": 16, "model": 16},
    {"pod": 1, "data": 2, "model": 1},
    {"model": 16},
]
SHAPES = [(8, 7), (4096, 14336), (32, 4096, 128), (6, 2, 16), (1,), (2, 48)]
LOGICAL = [None, "embed", "vocab", "ffn", "experts", "heads", "kv_heads",
           "batch", "layers", "unknown"]
RULE_TABLES = [
    S.PARAM_RULES,
    S.ACT_RULES,
    dict(S.PARAM_RULES, embed=("pod", "data"), ffn=("data", "model")),
    {"embed": "data", "vocab": "data", "batch": ("model", "pod")},
]


def jax_mesh(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


def _grid():
    for mesh, shape, rules in itertools.product(MESHES, SHAPES,
                                                range(len(RULE_TABLES))):
        for logical in itertools.islice(
                itertools.product(LOGICAL, repeat=len(shape)), 0, None, 7):
            yield mesh, shape, logical, rules


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
def test_spec_for_equals_jax_on_a_grid(mesh_i):
    mesh = MESHES[mesh_i]
    n = 0
    for m, shape, logical, rules in _grid():
        if m is not mesh:
            continue
        got = S.spec_for(shape, logical, RULE_TABLES[rules], mesh)
        want = jax_sharding.spec_for(shape, logical, RULE_TABLES[rules],
                                     jax_mesh(mesh))
        assert got == tuple(want), (mesh, shape, logical, rules)
        n += 1
    assert n > 100


class TestShardingRules:
    """``tests/test_distributed.py::TestShardingRules`` on the port."""

    def test_divisibility_fallback(self):
        spec = S.spec_for((8, 7), ("embed", None), {"embed": "data"},
                          {"data": 1})
        assert spec == ("data",)

    def test_missing_axis_filtered_not_dropped(self):
        """The (pod, data) binding must keep data on a pod-less mesh."""
        spec = S.spec_for((4, 4), ("batch", None),
                          {"batch": ("pod", "data")}, {"data": 1})
        assert spec == ("data",)

    def test_no_axis_reuse_within_tensor(self):
        spec = S.spec_for((4, 4), ("a", "b"), {"a": "data", "b": "data"},
                          {"data": 1})
        assert spec == ("data",)  # second binding blocked (axis used)


def _jax_specs(arch, mesh):
    """JAX's spec of every leaf of its smoke params (the "layers" dim
    prepended to stacked leaves, as its ``param_shardings`` does)."""
    import jax
    from repro.common.tree import tree_flatten_with_paths as jax_flatten

    box = []

    def init(key):
        p, a = jax_T.init_params(key, jax_get_smoke_config(arch))
        box.append(a)
        return p

    shapes = jax.eval_shape(init, jax.random.key(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    names = [n for n, _ in jax_flatten(shapes)]
    out = {}
    for name, (path, leaf) in zip(names, flat):
        logical = jax_sharding._get_by_path(box[0], path)
        if len(logical) == leaf.ndim - 1:
            logical = ("layers",) + tuple(logical)
        out[name] = tuple(jax_sharding.spec_for(
            leaf.shape, logical, jax_sharding.PARAM_RULES, jax_mesh(mesh)))
    return out


@pytest.mark.parametrize("arch", ["llama3_8b", "granite_moe_1b_a400m",
                                  "whisper_small", "gemma2_2b",
                                  "recurrentgemma_2b", "rwkv6_7b"])
def test_param_shardings_equal_jax_leaf_by_leaf(arch):
    from repro_torch.common.tree import tree_flatten_with_paths

    mesh = {"data": 2, "model": 16}
    params, axes = T.init_params(get_smoke_config(arch), device="meta")
    specs = S.param_shardings(params, axes, mesh)
    got = {}
    for name, x in tree_flatten_with_paths(params):
        node = specs
        for key in name.split("/"):
            node = node[int(key)] if isinstance(node, list) else node[key]
        got[name] = node
    assert got == _jax_specs(arch, mesh)
    with S.sharding_ctx(mesh):
        assert S.active_mesh() == mesh
        assert S.param_shardings(params, axes) == specs
    assert S.active_mesh() is None


def test_param_shardings_without_a_mesh_are_none():
    params, axes = T.init_params(get_smoke_config("llama3_8b"),
                                 device="meta")
    specs = S.param_shardings(params, axes)
    assert specs["embed"]["table"] is None
    assert specs["layers"][0]["mixer"]["wq"]["w"] is None


def test_param_shardings_refuse_a_leaf_of_another_rank():
    with pytest.raises(ValueError, match="w: shape"):
        S.param_shardings({"w": torch.empty(2, 3, 4, 5, device="meta")},
                          {"w": ("embed", "ffn")}, {"data": 2})


def test_sharding_ctx_overrides_rules():
    with S.sharding_ctx({"data": 4}, param_overrides=[("ffn", "data")]):
        specs = S.param_shardings({"w": torch.empty(8, 8, device="meta")},
                                  {"w": ("ffn", None)})
    assert specs == {"w": ("data",)}


def test_constrain_is_the_identity():
    x = torch.arange(12.0).reshape(3, 4)
    assert S.constrain(x, ("batch", "embed")) is x
    with S.sharding_ctx({"data": 2, "model": 2}):
        assert S.constrain(x, ("batch", "embed")) is x
