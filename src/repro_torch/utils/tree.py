"""Tree arithmetic over the port's param trees, the port of the JAX
package's ``utils/tree.py``.

A tree is a nested dict (visited in sorted key order, the JAX package's
tree order), NamedTuple, tuple or list of tensors; ``None`` is an empty
subtree, as in JAX. Every helper maps leaf by leaf and runs on the leaves'
device: nothing here reads a tensor back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of ``rest``,
    which share its structure; the result has that structure. A node for
    which ``is_leaf`` is true is a leaf (a `ParamDef` is a NamedTuple)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)

    def sub(*parts):
        return tree_map(fn, *parts, is_leaf=is_leaf)

    if isinstance(tree, dict):
        return {key: sub(tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(*parts) for parts in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(*parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_flatten_with_path(tree: Any, prefix: str = "",
                           is_leaf: Optional[Callable[[Any], bool]] = None
                           ) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in tree order; a path joins dict keys, NamedTuple
    field names and sequence indices with "/". A node for which ``is_leaf``
    is true is a leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(key), tree[key]) for key in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(tree_flatten_with_path(sub, f"{prefix}/{key}" if prefix
                                          else key, is_leaf))
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten_like(template: Any, leaves) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in tree order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf-wise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_dot(a, b):
    """Global inner product <a, b>: per leaf the float32 sum of a * b, the
    leaves' sums added in tree order from 0 (as the JAX package's
    ``tree.reduce``), a 0-d float32 tensor."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    total = torch.zeros((), dtype=torch.float32,
                        device=xs[0].device if xs else None)
    for x, y in zip(xs, ys):
        total = total + torch.sum(x.to(torch.float32) * y.to(torch.float32))
    return total


def global_norm(tree):
    return torch.sqrt(tree_dot(tree, tree))


def tree_size(tree) -> int:
    """Total number of elements."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


# ---------------------------------------------------------------------------
# Flatten / unflatten: the engines' pytree <-> flat bridge
#
# The engines do their ring-buffer and update math on ONE flat vector per
# row; pytree objectives (the MLP's dict of weights) cross that boundary
# through the two helpers below, which only move data: a concatenation of
# the leaves in tree order one way, slices and reshapes the other, so the
# round trip is exact. The layout is the JAX package's element for element
# (dict keys sorted, each leaf row-major), so a flat row of one package
# rebuilds into the same tree in the other. Leaves must share one dtype.
# ---------------------------------------------------------------------------

def _leaf_meta(tree):
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("cannot ravel an empty tree")
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) > 1:
        raise ValueError(
            f"tree_ravel requires one leaf dtype, got "
            f"{sorted(map(str, dtypes))} — cast the tree first")
    return leaves, [tuple(x.shape) for x in leaves]


def tree_ravel(tree):
    """A tree of same-dtype tensors as one 1-D tensor, leaves in tree order;
    a single 1-D leaf passes through untouched."""
    leaves, _ = _leaf_meta(tree)
    if len(leaves) == 1 and leaves[0].dim() == 1:
        return leaves[0]
    return torch.cat([x.reshape(-1) for x in leaves])


def tree_unravel_fn(template):
    """``unravel(flat) -> tree`` for trees shaped like ``template``, the
    inverse of `tree_ravel`. ``flat`` may carry leading batch dimensions
    ``[..., size]``; each leaf then comes back as ``[..., *shape]``."""
    leaves, shapes = _leaf_meta(template)
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    bounds = np.concatenate([[0], np.cumsum(sizes)]).tolist()

    def unravel(flat):
        lead = tuple(flat.shape[:-1])
        parts = [flat[..., lo:hi].reshape(lead + shape)
                 for lo, hi, shape in zip(bounds[:-1], bounds[1:], shapes)]
        return tree_unflatten_like(template, parts)

    return unravel
