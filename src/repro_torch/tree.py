"""Trees of tensors: nested dicts, lists, tuples, named tuples and
dataclasses, walked in JAX's flattening order (dict keys sorted) with
each leaf's path written as `jax.tree_util.keystr` writes it (`.field`,
`[i]`, `['key']`).  The checkpoint store names a leaf by this path, and
the optimizer and the LM steps walk parameters, gradients and moments
leaf by leaf with it.
"""
from __future__ import annotations

import dataclasses


def _children(node):
    """[(key string, child)] of a container node, or None for a leaf.
    None is an empty node, as in JAX."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _rebuild(node, children):
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (list, tuple)):
        return type(node)(children)
    return dataclasses.replace(node, **{
        f.name: c for f, c in zip(dataclasses.fields(node), children)})


def leaves_with_paths(tree, prefix=""):
    """[(keystr path, leaf)] in JAX's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids
            for item in leaves_with_paths(child, prefix + key)]


def map_with_paths(fn, tree, prefix=""):
    """The tree with each leaf replaced by fn(path, leaf)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_paths(fn, child, prefix + key)
                           for key, child in kids])
