"""Gradient compression with error feedback, the port of the JAX package's
``core/compression.py``.

Top-k / random-k sparsification and int8 stochastic quantization, each
with error feedback (Stich et al. 2018): the compression error is carried
and re-injected at the next call, as the paper's τ-bounded staleness
carries stale coordinates. `compressed_update` is what
`core.distributed.bounded_staleness_epoch` applies to each worker's delta
before the cross-worker mean.

Every operator works leaf by leaf on the port's trees
(`repro_torch.utils.tree`), in the JAX package's leaf order, and on the
leaves' device. The draws go through `repro_torch.prng`, so a key keeps
its meaning across both packages: rand-k keeps the indices
``jax.random.choice(key, n, (k,), replace=False)`` keeps (`prng.choice`),
int8 adds the noise ``jax.random.uniform(key, shape, -0.5, 0.5)`` adds.
Top-k takes `torch.topk` of ``|x|``; `torch.round` rounds half to even,
as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import prng
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like, tree_zeros_like)


class ErrorFeedbackState(NamedTuple):
    residual: Any    # tree matching the gradient tree


def init_error_feedback(tree) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_zeros_like(tree))


# ---------------------------------------------------------------------------
# leaf-wise compressors: x -> (compressed_dense, residual)
# ---------------------------------------------------------------------------

def _keep_count(n: int, frac: float) -> int:
    return max(1, int(n * frac))


def _topk_leaf(x: torch.Tensor, frac: float):
    flat = x.reshape(-1)
    idx = torch.topk(flat.abs(), _keep_count(flat.numel(), frac)).indices
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    kept = flat * mask
    return kept.reshape(x.shape), (flat - kept).reshape(x.shape)


def _randk_leaf(x: torch.Tensor, frac: float, key: torch.Tensor):
    flat = x.reshape(-1)
    n = flat.numel()
    k = _keep_count(n, frac)
    idx = prng.choice(key.to(x.device), n, k)
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    kept = flat * mask * (n / k)          # unbiased scaling
    return kept.reshape(x.shape), (flat - flat * mask).reshape(x.shape)


def _int8_leaf(x: torch.Tensor, key: torch.Tensor):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    noise = prng.uniform(key.to(x.device), tuple(x.shape), minval=-0.5,
                         maxval=0.5)
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    deq = q * scale
    return deq, x - deq


def _unzip(tree, pairs):
    """(tree of firsts, tree of seconds) from a leaf list of pairs."""
    return (tree_unflatten_like(tree, [p[0] for p in pairs]),
            tree_unflatten_like(tree, [p[1] for p in pairs]))


def topk_compress(tree, frac: float):
    """Returns (compressed tree, residual tree)."""
    leaves = tree_leaves(tree)
    return _unzip(tree, [_topk_leaf(x, frac) for x in leaves])


def randk_compress(tree, frac: float, key: torch.Tensor):
    leaves = tree_leaves(tree)
    keys = prng.split(key, len(leaves))      # one key per leaf, in order
    return _unzip(tree, [_randk_leaf(x, frac, keys[i])
                         for i, x in enumerate(leaves)])


def int8_compress(tree, key: torch.Tensor):
    leaves = tree_leaves(tree)
    keys = prng.split(key, len(leaves))
    return _unzip(tree, [_int8_leaf(x, keys[i]) for i, x in enumerate(leaves)])


def compressed_update(grads, ef: ErrorFeedbackState, method: str,
                      frac: float, key) -> Tuple[Any, ErrorFeedbackState]:
    """Error-feedback compression: compress(g + residual); carry the error.

    Returns (to_transmit, new_ef). `to_transmit` is what enters the
    cross-worker mean; with method="none" it is `grads` unchanged."""
    if method == "none":
        return grads, ef
    corrected = tree_map(torch.add, grads, ef.residual)
    if method == "topk":
        comp, res = topk_compress(corrected, frac)
    elif method == "randk":
        comp, res = randk_compress(corrected, frac, key)
    elif method == "int8":
        comp, res = int8_compress(corrected, key)
    else:
        raise ValueError(f"unknown compression {method!r}")
    return comp, ErrorFeedbackState(res)


def compressed_bytes(tree, method: str, frac: float) -> int:
    """Wire-size estimate of the compressed payload: topk/randk send k
    (value+index) pairs; int8 sends 1 byte/elem + scale."""
    total = 0
    for x in tree_leaves(tree):
        n = 1
        for d in x.shape:
            n *= int(d)
        if method == "none":
            total += 4 * n
        elif method in ("topk", "randk"):
            total += _keep_count(n, frac) * (4 + 4)
        elif method == "int8":
            total += n + 4
    return total
