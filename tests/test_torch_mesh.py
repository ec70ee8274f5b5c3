"""The port's mesh helpers (``repro_torch.launch.mesh``) against the JAX
package's, on the CPU: ``tests/test_multiproc.py``'s ``TestHostMesh``
(the two ``ValueError``s with JAX's messages, the single-device meshes)
and ``batch_axes``. A mesh in the port is its axis shape, the dict JAX's
``Mesh.shape`` gives, in JAX's axis order. The production meshes need
256 and 512 JAX devices; ``tests/test_torch_dryrun.py`` holds them
against JAX's in its 512-device subprocess."""

import types

import pytest

from repro.launch.mesh import batch_axes as jax_batch_axes
from repro.launch.mesh import make_host_mesh as jax_host_mesh

from repro_torch.launch.mesh import (
    batch_axes,
    make_host_mesh,
    make_production_mesh,
)


def _jax_error(*args, **kwargs) -> str:
    with pytest.raises(ValueError) as e:
        jax_host_mesh(*args, **kwargs)
    return str(e.value)


class TestHostMesh:
    def test_multi_axis_without_shape_raises(self):
        with pytest.raises(ValueError, match="explicit shape") as e:
            make_host_mesh(8, axes=("data", "model"))
        assert str(e.value) == _jax_error(8, axes=("data", "model"))

    def test_shape_product_must_match(self):
        with pytest.raises(ValueError, match="places") as e:
            make_host_mesh(8, axes=("data", "model"), shape=(2, 2))
        assert str(e.value) == _jax_error(8, axes=("data", "model"),
                                          shape=(2, 2))

    def test_single_device_meshes(self):
        assert make_host_mesh(1) == {"data": 1} == dict(jax_host_mesh(1).shape)
        m = make_host_mesh(1, axes=("a", "b"), shape=(1, 1))
        assert m == {"a": 1, "b": 1} == dict(
            jax_host_mesh(1, axes=("a", "b"), shape=(1, 1)).shape)
        assert list(m) == ["a", "b"]

    def test_multi_axis_shape_in_axis_order(self):
        m = make_host_mesh(8, axes=("model", "data"), shape=(2, 4))
        assert list(m.items()) == [("model", 2), ("data", 4)]


def test_production_meshes():
    """JAX's ``make_production_mesh`` (``repro/launch/mesh.py:17-22``):
    (16, 16) over (data, model), (2, 16, 16) over (pod, data, model)."""
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert list(one.items()) == [("data", 16), ("model", 16)]
    assert list(two.items()) == [("pod", 2), ("data", 16), ("model", 16)]


@pytest.mark.parametrize("mesh", [
    {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
    {"data": 8}, {"model": 4}, {"pod": 2, "model": 2}, {"pipe": 4}])
def test_batch_axes_match_jax(mesh):
    """``batch_axes`` reads only ``mesh.shape`` in JAX."""
    want = jax_batch_axes(types.SimpleNamespace(shape=mesh))
    assert batch_axes(mesh) == want
