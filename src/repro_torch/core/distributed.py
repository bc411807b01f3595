"""Distributed AsySVRG, the port of the JAX package's ``core/distributed.py``:

1. ``SVRGState`` + ``svrg_direction`` — v = g(w) − g(w_snap) + g_snap for
   arbitrary param trees. The train step takes both gradients on the same
   minibatch (the paper's inner loop, with minibatches instead of single
   instances) and any optimizer consumes v.

2. the snapshot steps — the paper's full-gradient pass, as a mean of the
   gradients of a few reference batches.

3. ``bounded_staleness_epoch`` — the asynchronous inner loop mapped to SPMD
   over a mesh's ``data`` axis: each worker (one rank) runs H local SVRG
   steps on its OWN replica (replica divergence carries the paper's
   coordinate-age mixing), then the replicas reconcile by averaging
   (Option 2), optionally through a compressed delta
   (`core.compression`) whose per-worker ``ErrorFeedbackState`` is
   threaded in and out of the epoch, so the residual accumulates across
   epochs. H is the staleness bound τ; H=1 is synchronous minibatch SVRG.

Gradients are taken by `value_and_grad`, the port's counterpart of
``jax.value_and_grad`` for a loss over a param tree.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.config import SVRGConfig
from repro_torch.core.compression import ErrorFeedbackState, compressed_update
from repro_torch.sharding.context import (all_gather, collective_device,
                                         grad_placed)
from repro_torch.utils.tree import (
    tree_add, tree_leaves, tree_map, tree_scale, tree_sub,
    tree_unflatten_like, tree_zeros_like)


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
    autograd enabled whatever the caller's grad mode. Under a mesh each
    gradient is placed as its parameter (`sharding.context.grad_placed`).
    """

    def f(params, batch):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
            loss = loss_fn(tree_unflatten_like(
                params, [grad_placed(x) for x in leaves]), batch)
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


# ---------------------------------------------------------------------------
# Bounded-staleness local SVRG (one worker per rank of the data axis)
# ---------------------------------------------------------------------------

def init_worker_error_feedback(params, num_workers: int) -> ErrorFeedbackState:
    """Per-worker EF residuals: params-shaped zeros with a leading [W] axis
    (worker w's residual at index w)."""
    return ErrorFeedbackState(tree_map(
        lambda x: torch.zeros((num_workers,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), params))


def _all_reduce_mean(x: torch.Tensor, group, num_workers: int) -> torch.Tensor:
    """``jax.lax.pmean(x, "data")``: the sum over the group's ranks, ÷ W."""
    buf = x.to(collective_device(group), copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device) / num_workers


def bounded_staleness_epoch(
    mesh,
    loss_fn: Callable,                # loss_fn(params, batch) scalar
    params,
    svrg_state: SVRGState,
    local_batches,                    # tree of [W, H, ...]: worker w's at [w]
    step_size: float,
    cfg: SVRGConfig,
    rng: Optional[torch.Tensor] = None,
    ef: Optional[ErrorFeedbackState] = None,
):
    """H local SVRG steps per worker, then the (optionally compressed)
    reconcile. A collective call: every rank of ``mesh`` calls it with the
    same arguments, and rank w of the ``data`` axis is worker w.

    Worker w scans its H minibatches (``local_batches``' slot w) updating
    a private replica; its delta (``w_local - params``) is compressed with
    ``prng.split(rng, max(2, W))[w]`` (``cfg.compression``, ``"none"``
    sends it whole), and the closing all-reduce ÷ W over the ``data``
    group is JAX's ``pmean`` (Option 2 averaging).

    Returns ``(new_params, new_ef)`` on every rank: the reconciled params
    and the ``[W, ...]`` residual tree gathered from every worker. ``ef``
    is each worker's PERSISTENT error-feedback state (None = zeros, a fresh
    run): pass the returned state back in at the next epoch, or the
    untransmitted residual is lost."""
    vgrad = value_and_grad(loss_fn)
    w_snap, g_snap = svrg_state.w_snap, svrg_state.g_snap
    group = mesh.get_group("data")
    num_workers = dist.get_world_size(group)
    worker = dist.get_rank(group)
    if rng is None:
        rng = prng.PRNGKey(0, _device_of(params))
    if ef is None:
        ef = init_worker_error_feedback(params, num_workers)
    key = prng.split(rng, max(2, num_workers))[worker]

    batches = tree_map(lambda x: x[worker], local_batches)
    w_local = params
    for h in range(tree_leaves(batches)[0].shape[0]):
        batch = tree_map(lambda x: x[h], batches)
        _, g = vgrad(w_local, batch)
        _, g0 = vgrad(w_snap, batch)
        v = svrg_direction(g, g0, g_snap)
        w_local = tree_map(lambda wi, vi: wi - step_size * vi, w_local, v)

    # reconcile: average the replicas (Option 2). With compression, transmit
    # only the compressed delta and re-add it to the common base point; the
    # compression error joins this worker's carried residual.
    delta = tree_sub(w_local, params)
    ef_local = ErrorFeedbackState(tree_map(lambda x: x[worker], ef.residual))
    if cfg.compression != "none":
        delta, ef_local = compressed_update(delta, ef_local, cfg.compression,
                                            cfg.compression_k, key)
    delta_mean = tree_map(
        lambda d: _all_reduce_mean(d, group, num_workers), delta)
    residual = tree_map(lambda r: torch.stack(all_gather(r, group)),
                        ef_local.residual)
    return tree_add(params, delta_mean), ErrorFeedbackState(residual)


def reshape_for_workers(batches, num_workers: int, local_steps: int):
    """[W*H, b, ...] -> [W, H, b, ...] worker-major (leaf-wise)."""
    def rs(x):
        if x.shape[0] != num_workers * local_steps:
            raise ValueError(f"need {num_workers * local_steps} microbatches, "
                             f"got {x.shape[0]}")
        return x.reshape((num_workers, local_steps) + tuple(x.shape[1:]))
    return tree_map(rs, batches)
