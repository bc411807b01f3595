"""TrainState + step builders, the port of the JAX package's
``train/state.py``.

`make_train_step(bundle, tcfg)` builds the steady-state inner step of
Algorithm 1 at LM scale: two forward+backward passes on the same minibatch
(at w and at w_snap), the control variate v = g − g0 + g_snap, its clip by
global norm, the optimizer's apply. With optimizer != "svrg" the same
builder gives the plain SGD / momentum / AdamW step.

With ``use_fused_update=True`` (SVRG, whose optimizer is SGD) the update
u′ = u − lr·(clip(g − g0 + g_snap) + wd·u) goes through the fused SVRG
kernel (K1), one launch per param leaf (`kernels.svrg_update.ops
.apply_tree`), and v is never formed as a tree. The clip scale s folds
into K1's step size, lr·s, a device scalar; the decay, which the clip must
not scale, goes into g0 as g0 − (wd/s)·u first. This is written from the
definition: the JAX package's fused branch passes names that are not
defined in its step and skips the clip (its unfused step is the reference
the tests hold both against).

Nothing here reads a device value back to the host: the step counter, the
rate, the norm and the clip scale stay on the device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.distributed import (
    SVRGState, init_svrg_state, snapshot_accumulate, snapshot_begin,
    snapshot_finalize, svrg_direction, value_and_grad)
from repro_torch.kernels.svrg_update import ops as svrg_ops
from repro_torch.models.factory import ModelBundle
from repro_torch.optim import clip_by_global_norm, make_optimizer, make_schedule
from repro_torch.optim.optimizers import clip_scale
from repro_torch.sharding.context import row_block
from repro_torch.sharding.rules import ParamDef, init_from_defs
from repro_torch.utils.tree import tree_add, tree_leaves, tree_map, tree_scale


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    svrg: Optional[SVRGState]
    step: torch.Tensor


def init_train_state(gen: torch.Generator, bundle: ModelBundle,
                     tcfg: TrainConfig) -> TrainState:
    """Params drawn from ``gen`` by the bundle's defs, on the bundle's
    device; ``w_snap`` a distinct copy of them."""
    params = tree_map(lambda x: x.to(bundle.device),
                      init_from_defs(gen, bundle.param_defs))
    opt = make_optimizer(tcfg)
    svrg = (init_svrg_state(tree_map(torch.clone, params))
            if tcfg.optimizer == "svrg" else None)
    return TrainState(params=params, opt_state=opt.init(params), svrg=svrg,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=bundle.device))


def make_train_state_defs(bundle: ModelBundle, tcfg: TrainConfig):
    """ParamDef tree mirroring TrainState."""
    pdefs = bundle.param_defs
    scalar = ParamDef((), (), "zeros", dtype="int32")
    if tcfg.optimizer == "svrg":
        svrg = SVRGState(w_snap=pdefs, g_snap=pdefs, snap_step=scalar,
                         accum_count=scalar)
    else:
        svrg = None
    opt = make_optimizer(tcfg)
    if opt.name == "momentum":
        opt_state = {"m": pdefs}
    elif opt.name == "adamw":
        opt_state = {"m": pdefs, "v": pdefs}
    else:
        opt_state = {}
    return TrainState(params=pdefs, opt_state=opt_state, svrg=svrg,
                      step=scalar)


def _microbatch(batch, mb: int, i: int):
    """Rows [i·B/mb, (i+1)·B/mb) of every input (the JAX package's split);
    of a batch sharded over a mesh, block i of each rank's rows
    (`sharding.context.row_block`)."""
    return {key: row_block(x, mb, i) for key, x in batch.items()}


def _accumulate(fn: Callable, params, svrg, batch, mb: int):
    """The mean over ``mb`` microbatches of ``fn(params, svrg, b) -> (loss,
    *trees)``, each microbatch's gradients freed before the next's."""
    total = None
    for i in range(mb):
        out = fn(params, svrg, _microbatch(batch, mb, i))
        total = out if total is None else (
            total[0] + out[0],
            *(tree_add(a, b) for a, b in zip(total[1:], out[1:])))
    inv = 1.0 / mb
    return (total[0] * inv, *(tree_scale(t, inv) for t in total[1:]))


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig,
                    use_fused_update: bool = False) -> Callable:
    """Returns step(state, batch) -> (state, metrics); ``batch`` holds
    tensors on the bundle's device. metrics: loss, v_norm (the norm of v
    before the clip; 0 when ``grad_clip <= 0``) and lr, 0-d device
    tensors.

    With tcfg.microbatches > 1 the batch is split and the gradients are
    averaged over the pieces, one piece's activations alive at a time."""
    opt = make_optimizer(tcfg)
    schedule = make_schedule(tcfg)
    vgrad = value_and_grad(bundle.loss_fn)
    is_svrg = tcfg.optimizer == "svrg"
    if use_fused_update and not is_svrg:
        raise ValueError("use_fused_update applies to optimizer='svrg' only "
                         f"(got {tcfg.optimizer!r})")

    def grads(params, svrg, batch):
        """(loss, g, g0) with SVRG, (loss, g) otherwise."""
        loss, g = vgrad(params, batch)
        if is_svrg:
            _, g0 = vgrad(svrg.w_snap, batch)
            return loss, g, g0
        return loss, g

    def grads_of(params, svrg, batch):
        """(loss, v): the reference's direction, g itself without SVRG."""
        if is_svrg:
            loss, g, g0 = grads(params, svrg, batch)
            return loss, svrg_direction(g, g0, svrg.g_snap)
        return grads(params, svrg, batch)

    def fused_update(params, g, g0, g_snap, lr):
        """(new params, |v|) through K1; v formed one leaf at a time for its
        norm, with `clip_by_global_norm`'s arithmetic (so |v| equals the
        unfused step's)."""
        if tcfg.grad_clip <= 0:
            vnorm = torch.zeros((), dtype=torch.float32, device=lr.device)
            return svrg_ops.apply_tree(params, g, g0, g_snap, lr,
                                       tcfg.weight_decay), vnorm
        sq = torch.zeros((), dtype=torch.float32, device=lr.device)
        for a, b, c in zip(tree_leaves(g), tree_leaves(g0),
                           tree_leaves(g_snap)):
            v = a - b + c
            sq = sq + torch.sum(v.to(torch.float32) * v.to(torch.float32))
        vnorm = torch.sqrt(sq)
        scale = clip_scale(vnorm, tcfg.grad_clip)
        if tcfg.weight_decay:
            decay = tcfg.weight_decay / scale
            for u, b in zip(tree_leaves(params), tree_leaves(g0)):
                b.sub_(u * decay)
        return svrg_ops.apply_tree(params, g, g0, g_snap, lr * scale), vnorm

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        fn = grads if use_fused_update else grads_of
        if tcfg.microbatches > 1:
            loss, *trees = _accumulate(fn, state.params, state.svrg, batch,
                                       tcfg.microbatches)
        else:
            loss, *trees = fn(state.params, state.svrg, batch)
        lr = schedule(state.step)
        if use_fused_update:
            params, vnorm = fused_update(state.params, *trees,
                                         state.svrg.g_snap, lr)
            opt_state = state.opt_state
        else:
            v, vnorm = clip_by_global_norm(trees[0], tcfg.grad_clip)
            params, opt_state = opt.apply(v, state.opt_state, lr,
                                          state.params, state.step)
        new_state = state._replace(params=params, opt_state=opt_state,
                                   step=state.step + 1)
        return new_state, {"loss": loss, "v_norm": vnorm, "lr": lr}

    return step


def make_snapshot_fns(bundle: ModelBundle, tcfg: TrainConfig):
    """(begin, accumulate, finalize) — the paper's full-gradient pass, run
    between inner steps."""

    def begin(state: TrainState) -> TrainState:
        return state._replace(svrg=snapshot_begin(state.svrg))

    def accumulate(state: TrainState, batch) -> TrainState:
        return state._replace(
            svrg=snapshot_accumulate(bundle.loss_fn, state.params,
                                     state.svrg, batch))

    def finalize(state: TrainState) -> TrainState:
        return state._replace(
            svrg=snapshot_finalize(state.params, state.svrg, state.step))

    return begin, accumulate, finalize
