"""Nested dict/list/tuple trees of tensors: the port's ``jax.tree_util``.

Leaves come out in the JAX package's order (dict keys sorted), so a
reduction over leaves (the global gradient norm) sums in the same order
in both packages.  ``None`` is an empty subtree, as in ``jax.tree_util``
(a hybrid model without trailing Mamba layers has ``server_tail`` None).
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch

# flat_slices cuts a leaf into slices of this many elements, so that f32
# temporaries of a large stack stay small
SLICE = 1 << 26


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree, it: Iterator):
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {key: _rebuild(tree[key], it) for key in sorted(tree)}
        return {key: built[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, it) for item in tree)
    return next(it)


def flat_slices(*tensors: torch.Tensor):
    """Matching flat slices of ``SLICE`` elements of same-sized tensors;
    the whole tensors when one of them is not contiguous."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for lo in range(0, flat[0].numel(), SLICE):
        yield tuple(f[lo:lo + SLICE] for f in flat)
