"""Optimizers over param-tree directions, the port of the JAX package's
``optim/optimizers.py`` with its update order.

The paper's update is plain SGD on the variance-reduced direction v
(Algorithm 1: u ← u − η v); `sgd` is therefore the paper-faithful choice.
`momentum` and `adamw` are beyond-paper options that consume v as the
gradient estimate (SVRG-as-estimator).

Each optimizer is (init(params) -> opt_state, apply(v, opt_state, lr,
params, step) -> (new_params, new_opt_state)). ``lr`` and ``step`` may be
0-d device tensors: nothing here reads them back to the host. Every update
returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.utils.tree import (
    global_norm, tree_leaves, tree_map, tree_zeros_like)


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    apply: Callable[..., Tuple[Any, Any]]   # (v, opt_state, lr, params, step)


def clip_scale(norm, max_norm: float):
    """min(1, max_norm / max(norm, 1e-12)), on ``norm``'s device."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, its norm
    before the clip); ``max_norm <= 0`` clips nothing and reports 0."""
    if max_norm <= 0:
        leaves = tree_leaves(tree)
        return tree, torch.zeros((), dtype=torch.float32,
                                 device=leaves[0].device if leaves else None)
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale, tree), norm


def _sgd(cfg: TrainConfig) -> Optimizer:
    wd = cfg.weight_decay

    def init(params):
        return {}

    def apply(v, opt_state, lr, params, step):
        def upd(p, g):
            g = g + wd * p if wd else g
            return (p - lr * g).to(p.dtype)
        return tree_map(upd, params, v), opt_state

    return Optimizer("sgd", init, apply)


def _momentum(cfg: TrainConfig) -> Optimizer:
    beta = cfg.beta1
    wd = cfg.weight_decay

    def init(params):
        return {"m": tree_zeros_like(params)}

    def apply(v, opt_state, lr, params, step):
        m = tree_map(lambda mo, g: beta * mo + g, opt_state["m"], v)

        def upd(p, mi):
            g = mi + wd * p if wd else mi
            return (p - lr * g).to(p.dtype)
        return tree_map(upd, params, m), {"m": m}

    return Optimizer("momentum", init, apply)


def _adamw(cfg: TrainConfig) -> Optimizer:
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

    def init(params):
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params)}

    def apply(v, opt_state, lr, params, step):
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        m = tree_map(lambda mo, g: b1 * mo + (1 - b1) * g, opt_state["m"], v)
        s = tree_map(lambda so, g: b2 * so + (1 - b2) * g * g,
                     opt_state["v"], v)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def upd(p, mi, si):
            mhat = mi / c1
            shat = si / c2
            return (p - lr * (mhat / (torch.sqrt(shat) + eps) + wd * p)
                    ).to(p.dtype)

        return tree_map(upd, params, m, s), {"m": m, "v": s}

    return Optimizer("adamw", init, apply)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    name = "sgd" if cfg.optimizer == "svrg" else cfg.optimizer
    if name == "sgd":
        return _sgd(cfg)
    if name == "momentum":
        return _momentum(cfg)
    if name == "adamw":
        return _adamw(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
