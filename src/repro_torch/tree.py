"""Trees of tensors: nested dicts, lists and tuples, flattened in JAX's
order (dict keys sorted, list and tuple items by index).

Every module that pairs the leaves of two trees -- gradients with
parameters, AdamW's state with both, a checkpoint's arrays with a skeleton,
the JAX package's layout with the port's -- flattens through here, so the
order is stated once.
"""

from __future__ import annotations


def paths(tree, prefix=()):
    """(path, leaf) in flattening order; a path is the tuple of dict keys
    and list indices from the root (``("groups", "g0_griffin", "subs", 0,
    "mixer", "in_x")``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def named_leaves(tree):
    """(name, leaf) in flattening order, each named as
    ``jax.tree_util.keystr`` names it (``['groups']['g0_dense']...``)."""
    for path, leaf in paths(tree):
        yield "".join(f"[{k!r}]" for k in path), leaf


def tree_leaves(tree) -> list:
    """The leaves of a tree in flattening order."""
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure -> a tree of that
    structure (tuples come back as lists)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [tree_map(fn, *vs) for vs in zip(*trees)]
    return fn(*trees)


def unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves, in flattening order, replaced
    by ``leaves``."""
    return _unflatten(tree, iter(leaves))


def _unflatten(node, it):
    # a module-level function: a nested one that calls itself is a cycle
    # (function -> closure cell -> function) that keeps ``leaves`` -- a
    # step's gradients -- alive until the cyclic garbage collector runs
    if isinstance(node, dict):
        out = {k: _unflatten(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_unflatten(v, it) for v in node)
    return next(it)
