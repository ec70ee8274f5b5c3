"""The port's dry-run contract against the JAX package's, on the CPU:
``SHAPES``, ``input_specs``, ``params_specs`` and ``params_axes`` of the
full configs, made on ``meta`` with no memory (JAX's ``ShapeDtypeStruct``
and ``eval_shape``), with JAX's leaf names, shapes and dtypes exactly.
"""

import numpy as np
import pytest

from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.configs import get_config as jax_config
from repro.models import steps as jax_S
from repro.optim import AdamWConfig as JaxAdamWConfig
from test_torch_models import ARCHS

from repro_torch.common.tree import tree_flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig


@pytest.mark.parametrize("shape", list(S.SHAPES))
def test_input_specs_on_meta_match_jax(shape):
    """Every input of llama3-8b's four cells (``tests/test_arch_smoke.py``
    ``test_input_specs_no_allocation``), the decode cache of 32k x 128
    (terabytes) included: JAX's names, shapes and dtypes, all on
    ``meta``."""
    want = jax_flatten(jax_S.input_specs(jax_config("llama3_8b"), shape))
    got = tree_flatten_with_paths(S.input_specs(get_config("llama3_8b"),
                                                shape))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.is_meta, name
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[1] == np.dtype(w.dtype).name, name
    sh = S.SHAPES[shape]
    assert (sh.name, sh.kind, sh.seq_len, sh.global_batch) == (
        jax_S.SHAPES[shape].name, jax_S.SHAPES[shape].kind,
        jax_S.SHAPES[shape].seq_len, jax_S.SHAPES[shape].global_batch)


@pytest.mark.parametrize("arch", ["whisper_small", "internvl2_1b",
                                  "recurrentgemma_2b"])
def test_input_specs_prefixes_and_recurrent_cache(arch):
    """The frames, patches and recurrent-state inputs of the other
    families, for every shape, equal JAX's."""
    for shape in S.SHAPES:
        want = jax_flatten(jax_S.input_specs(jax_config(arch), shape))
        got = tree_flatten_with_paths(S.input_specs(get_config(arch), shape))
        assert [(n, tuple(g.shape)) for n, g in got] == [
            (n, tuple(w.shape)) for n, w in want]
        assert all(g.is_meta for _, g in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_and_axes_match_jax(arch):
    """The full config's parameters and AdamW state (``meta``) and the
    logical axes: JAX's leaf names, shapes and dtypes."""
    want = jax_flatten(jax_S.params_specs(jax_config(arch), True,
                                          JaxAdamWConfig()))
    got = tree_flatten_with_paths(S.params_specs(get_config(arch), True,
                                                 AdamWConfig()))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[1] == np.dtype(w.dtype).name, name
    bare = tree_flatten_with_paths(S.params_specs(get_config(arch), False))
    assert [n for n, _ in bare] == [n[len("params/"):] for n, _ in got
                                    if n.startswith("params/")]

    def axes_of(tree):
        if isinstance(tree, dict):
            return {k: axes_of(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [axes_of(v) for v in tree]
        return tuple(tree)

    assert axes_of(S.params_axes(get_config(arch))) == axes_of(
        jax_S.params_axes(jax_config(arch)))


