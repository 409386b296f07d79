"""Parameter trees: nested dicts, lists and tuples of tensors, flattened
in JAX's order (dict keys sorted), so sums over the leaves add them in the
reference's order."""
from __future__ import annotations

from typing import Callable, List


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple))


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; containers are rebuilt (a NamedTuple keeps its
    type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """The structure of ``template`` filled with ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            filled = {k: fill(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [fill(v) for v in node]
            return type(node)(*out) if hasattr(node, "_fields") \
                else type(node)(out)
        return next(it)
    return fill(template)
