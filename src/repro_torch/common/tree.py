"""Small tree utilities and the path-named flattening of nested state.

Counterpart of ``repro/common/tree.py``. A tree is a dict, tuple, list or
NamedTuple of leaves; a leaf is anything else (a tensor, an ndarray, a
number); ``None`` is an empty subtree. Leaves come out in JAX's order with
JAX's names, so a checkpoint written by one package restores in the other,
and a reduction over leaves (``tree_global_norm``) adds them in JAX's
order:

- dict keys are visited in sorted order and named by the key;
- tuple and list items are named by their index;
- NamedTuple fields are named by the field name;
- a name is the path of its keys joined with ``/``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """``(key, child)`` of a node, in JAX's order; ``[]`` for ``None``."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(type(tree)._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return tree is not None and not isinstance(tree, (dict, tuple, list))


def tree_flatten_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in a stable order (JAX's)."""
    if _is_leaf(tree):
        return [("", tree)]
    out = []
    for key, child in _children(tree):
        for path, leaf in tree_flatten_with_paths(child):
            out.append((f"{key}/{path}" if path else key, leaf))
    return out


def tree_unflatten(like: PyTree, leaves: Sequence[Any]) -> PyTree:
    """Inverse of ``tree_flatten_with_paths``: ``like``'s structure with
    its leaves replaced, in flattening order, by ``leaves``."""
    it = iter(leaves)
    end = object()

    def build(node):
        if node is None:
            return None
        if _is_leaf(node):
            leaf = next(it, end)
            if leaf is end:
                raise ValueError("tree_unflatten: fewer leaves than the "
                                 "tree holds")
            return leaf
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        items = [build(c) for c in node]
        if _is_namedtuple(node):
            return type(node)(*items)
        return type(node)(items)

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_map(fn: Callable, *trees: PyTree) -> PyTree:
    """``fn`` over the leaves of ``trees`` (all of one structure, leaf for
    leaf), in the structure of the first."""
    flat = [tree_leaves(t) for t in trees]
    if any(len(f) != len(flat[0]) for f in flat[1:]):
        raise ValueError("tree_map: trees of different structures")
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*flat)])


def tree_zeros_like(tree: PyTree, dtype=None) -> PyTree:
    """Zeros of each leaf's shape and device, in ``dtype`` (a torch dtype)
    or the leaf's own."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_count_params(tree: PyTree) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    return sum(int(math.prod(x.shape)) * x.dtype.itemsize
               for x in tree_leaves(tree))


def tree_global_norm(tree: PyTree) -> torch.Tensor:
    """The f32 2-norm of all leaves: each leaf's sum of squares in f32,
    added in leaf order; a 0-dim f32 zero for an empty tree."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = None
    for x in leaves:
        s = torch.sum(torch.square(x.to(torch.float32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_scale(tree: PyTree, scale) -> PyTree:
    return tree_map(lambda x: x * scale, tree)


def tree_cast(tree: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_any_nan(tree: PyTree) -> torch.Tensor:
    """0-dim bool: any NaN in a floating leaf (other leaves are not
    looked at)."""
    flags = [torch.any(torch.isnan(x)) for x in tree_leaves(tree)
             if x.dtype.is_floating_point]
    if not flags:
        return torch.zeros((), dtype=torch.bool)
    return torch.any(torch.stack(flags))
