"""SVRG as a gradient estimator over param trees, the port of the first half
of the JAX package's ``core/distributed.py``:

1. ``SVRGState`` + ``svrg_direction`` — v = g(w) − g(w_snap) + g_snap for
   arbitrary param trees. The train step takes both gradients on the same
   minibatch (the paper's inner loop, with minibatches instead of single
   instances) and any optimizer consumes v.

2. the snapshot steps — the paper's full-gradient pass, as a mean of the
   gradients of a few reference batches.

The mesh half (``bounded_staleness_epoch``, the per-worker error feedback
and ``core/compression.py``) waits for the sharding slice. Gradients are
taken by `value_and_grad`, the port's counterpart of ``jax.value_and_grad``
for a loss over a param tree.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import (
    tree_add, tree_leaves, tree_map, tree_scale, tree_unflatten_like,
    tree_zeros_like)


class SVRGState(NamedTuple):
    """Optimizer-agnostic SVRG snapshot state (lives beside params).

    g_snap doubles as the snapshot-gradient ACCUMULATOR during the snapshot
    pass (Algorithm 1 computes the full gradient before any inner step
    runs), so SVRG keeps exactly 2 extra param-sized states."""
    w_snap: Any        # snapshot parameters u_0
    g_snap: Any        # full gradient ∇f(u_0) (or in-progress accumulator)
    snap_step: torch.Tensor   # step at which snapshot was taken
    accum_count: torch.Tensor


def value_and_grad(loss_fn: Callable):
    """``f(params, batch) -> (loss, grads)``: the loss (detached) and its
    gradient with respect to every leaf of ``params``, a tree of the same
    structure. ``params`` are not modified; the gradient is taken with
    autograd enabled whatever the caller's grad mode."""

    def f(params, batch):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
            loss = loss_fn(tree_unflatten_like(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten_like(params, grads)

    return f


def _device_of(tree):
    return tree_leaves(tree)[0].device


def init_svrg_state(params) -> SVRGState:
    device = _device_of(params)
    return SVRGState(
        w_snap=params,
        g_snap=tree_zeros_like(params),
        snap_step=torch.zeros((), dtype=torch.int32, device=device),
        accum_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def svrg_direction(g, g0, g_snap):
    """v = g − g0 + g_snap (Algorithm 1, Eq. 2), leaf-wise on trees."""
    return tree_map(lambda a, b, c: a - b + c, g, g0, g_snap)


def make_svrg_grad_fn(loss_fn: Callable):
    """Returns grad_fn(params, svrg_state, batch) -> (loss, v): two
    forward+backward passes on the same batch — at w and at w_snap — then
    the control variate."""
    vgrad = value_and_grad(loss_fn)

    def grad_fn(params, svrg_state: SVRGState, batch):
        loss, g = vgrad(params, batch)
        _, g0 = vgrad(svrg_state.w_snap, batch)
        return loss, svrg_direction(g, g0, svrg_state.g_snap)

    return grad_fn


# ---------------------------------------------------------------------------
# Snapshot pass (full gradient over reference batches)
# ---------------------------------------------------------------------------

def snapshot_begin(svrg_state: SVRGState) -> SVRGState:
    """Start a snapshot pass: zero the accumulator (no inner step runs until
    finalize, exactly Algorithm 1's structure)."""
    return svrg_state._replace(
        g_snap=tree_zeros_like(svrg_state.g_snap),
        accum_count=torch.zeros_like(svrg_state.accum_count),
    )


def snapshot_accumulate(loss_fn: Callable, params, svrg_state: SVRGState,
                        batch) -> SVRGState:
    """One reference batch's contribution to the snapshot gradient."""
    _, g = value_and_grad(loss_fn)(params, batch)
    return svrg_state._replace(
        g_snap=tree_add(svrg_state.g_snap, g),
        accum_count=svrg_state.accum_count + 1,
    )


def snapshot_finalize(params, svrg_state: SVRGState, step) -> SVRGState:
    """w_snap ← w; g_snap ← mean of the accumulated reference gradients."""
    cnt = torch.clamp(svrg_state.accum_count, min=1).to(torch.float32)
    device = svrg_state.accum_count.device
    return SVRGState(
        w_snap=params,
        g_snap=tree_scale(svrg_state.g_snap, 1.0 / cnt),
        snap_step=torch.as_tensor(step, dtype=torch.int32).to(device),
        accum_count=torch.zeros((), dtype=torch.int32, device=device),
    )
