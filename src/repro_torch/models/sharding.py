"""Logical-axis sharding rules: params and activations carry *logical* axis
names; a rule table maps them onto mesh axes with divisibility fallback.

Counterpart of ``repro/models/sharding.py``. The port runs a model on one
device and has no ``Mesh``: a mesh here is its axis shape, a dict from
axis name to size (all JAX's ``spec_for`` reads of a mesh), and a
partition spec is a tuple, the counterpart of ``PartitionSpec``, with
JAX's trailing ``None`` entries trimmed. ``constrain`` is the identity, as
JAX's is without an active mesh; the rules are kept so that a later
distributed port places each tensor as the JAX package does.

Divisibility fallback: a logical axis only binds to a mesh axis if the dim
divides the axis size and the axis is not already used by an earlier
logical axis of the same tensor; otherwise it is replicated.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Union

AxisBinding = Union[None, str, tuple]
MeshShape = Dict[str, int]

# Baseline parameter rules (logical name -> mesh axes, tried in order).
PARAM_RULES: dict[str, AxisBinding] = {
    "vocab": "model",
    "embed": "data",        # FSDP: gather-on-use
    "qkv_dim": "model",     # flattened heads*head_dim — always divisible
    "kv_dim": "model",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ffn": "model",
    "ffn2": None,
    "experts": "model",     # MoE EP when E % axis == 0, else ffn gets it
    "layers": None,         # stacked leading dim
}

# Baseline activation rules.
ACT_RULES: dict[str, AxisBinding] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "qkv_dim": "model",
    "kv_dim": "model",
    "heads": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[MeshShape] = None
        self.param_rules = dict(PARAM_RULES)
        self.act_rules = dict(ACT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[MeshShape],
                 param_overrides: Sequence[tuple] = (),
                 act_overrides: Sequence[tuple] = ()):
    """Activate a mesh shape + rule overrides for ``param_shardings()``."""
    old = (_CTX.mesh, _CTX.param_rules, _CTX.act_rules)
    _CTX.mesh = mesh
    _CTX.param_rules = dict(PARAM_RULES, **dict(param_overrides))
    _CTX.act_rules = dict(ACT_RULES, **dict(act_overrides))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.param_rules, _CTX.act_rules = old


def _binding_axes(binding: AxisBinding) -> tuple:
    if binding is None:
        return ()
    if isinstance(binding, str):
        return (binding,)
    return tuple(binding)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             rules: dict, mesh: MeshShape) -> tuple:
    """The partition spec (a tuple) honoring divisibility + no-axis-reuse."""
    used: set = set()
    entries = []
    for dim, name in zip(shape, logical):
        binding = rules.get(name) if name else None
        # keep only axes present in this mesh (e.g. "pod" is absent on the
        # single-pod mesh — the remaining "data" binding must survive)
        axes = tuple(ax for ax in _binding_axes(binding) if ax in mesh)
        size = 1
        for ax in axes:
            size *= mesh[ax]
        if not axes or any(ax in used for ax in axes) or dim % size != 0:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else tuple(axes))
    # drop trailing Nones for tidiness
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_shardings(params, axes_tree, mesh: Optional[MeshShape] = None,
                    rules: Optional[dict] = None):
    """A tree of partition specs matching ``params``' structure (``None``
    leaves without a mesh).

    ``axes_tree`` mirrors ``params`` except its leaves are tuples of logical
    axis names, so the two are walked together by key. A stacked leaf (one
    more dim than its logical axes) gets a leading ``"layers"`` axis.
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.param_rules

    def walk(p, a, path):
        if isinstance(p, dict):
            return {k: walk(v, a[k], f"{path}/{k}") for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, a[i], f"{path}/{i}")
                           for i, v in enumerate(p))
        if mesh is None:
            return None
        logical = (None,) * p.ndim if a is None else tuple(a)
        if len(logical) == p.ndim - 1:
            logical = ("layers",) + logical
        if len(logical) != p.ndim:
            raise ValueError(f"{path.lstrip('/')}: shape {tuple(p.shape)} "
                             f"has no logical axes of its rank: {logical}")
        return spec_for(p.shape, logical, rules, mesh)

    return walk(params, axes_tree, "")


def constrain(x, logical: Sequence[Optional[str]]):
    """JAX's ``with_sharding_constraint`` by logical activation axes: the
    identity, since the port runs a model on one device."""
    del logical
    return x


def active_mesh() -> Optional[MeshShape]:
    return _CTX.mesh
