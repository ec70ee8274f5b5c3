"""Path-named flattening of nested state, for the checkpoint store.

Counterpart of ``tree_flatten_with_paths`` in ``repro/common/tree.py``
(the rest of that module waits for the LM substrate). A tree is a dict,
tuple, list or NamedTuple of leaves; a leaf is anything else (a tensor, an
ndarray, a number); ``None`` is an empty subtree. Leaves come out in JAX's
order with JAX's names, so a checkpoint written by one package restores in
the other:

- dict keys are visited in sorted order and named by the key;
- tuple and list items are named by their index;
- NamedTuple fields are named by the field name;
- a name is the path of its keys joined with ``/``.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

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
