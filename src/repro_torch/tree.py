"""Pytree helpers: ``jax.tree.map``, ``jax.tree.leaves`` and
``jax.tree.unflatten`` over the dicts, lists, tuples and NamedTuples
(``AdamWState``) that hold the port's parameters, optimizer state, gradients
and caches.  The leaf order is JAX's (dict keys sorted), so a tree carried
from the JAX package keeps its leaf numbering, in checkpoints too."""
from __future__ import annotations


def _rebuild(node, children):
    """A tuple, NamedTuple (``AdamWState``) or list like ``node``."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``jax.tree.map``: ``rest`` are trees of ``tree``'s structure, whose
    leaves are passed to ``fn`` beside ``tree``'s.  ``is_leaf(node)`` true
    stops the walk at ``node`` (a logical-axes tuple, a partition spec)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest),
                                        is_leaf=is_leaf)
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None):
    """The leaves in ``jax.tree.leaves``'s order: dict keys sorted."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (in ``tree_leaves`` order)
    in place of its own."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(v) for v in node])
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out
