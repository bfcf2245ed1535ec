"""Trees of tensors: NamedTuples, tuples, lists and dicts nested in any
order, walked as the JAX package walks its pytrees.

A NamedTuple's child is keyed by its field name, a tuple's or list's by
its index, a dict's by `[repr(key)]` in sorted key order (the strings
`jax.tree_util.tree_flatten_with_path` gives the same nodes); None is an
empty subtree, anything else a leaf.  Host values that are leaves (ints,
strings, frozen dataclasses) pass through `map_tensors` unchanged.
"""

from typing import Any, Callable, List, Tuple

import torch


def _children(tree):
    """[(key, child)] of a container; None for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return None


def _rebuild(tree, children):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*children)
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    return type(tree)(children)


def map_leaves(fn: Callable[[Tuple[str, ...], Any], Any], tree,
               path: Tuple[str, ...] = ()):
    """The tree with every leaf `x` at key path `p` replaced by
    `fn(p, x)`."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [map_leaves(fn, c, path + (k,)) for k, c in kids])


def leaves_with_paths(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(key path, leaf)] in walk order."""
    out = []
    map_leaves(lambda p, x: out.append((p, x)), tree)
    return out


def map_tensors(fn: Callable[[torch.Tensor], Any], tree):
    """The tree with `fn` applied to every tensor leaf."""
    return map_leaves(
        lambda _, x: fn(x) if isinstance(x, torch.Tensor) else x, tree)


def tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves in walk order."""
    return [x for _, x in leaves_with_paths(tree)
            if isinstance(x, torch.Tensor)]
