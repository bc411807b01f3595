"""Carry the JAX package's state into the port, so both packages compute the
same thing from the same inputs (the parity tests' bridge).

Everything crosses as numpy or plain attributes: this module imports
nothing of JAX or of the JAX package, and takes their objects by duck type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import SVRGState
from repro_torch.core.objective import LogisticRegression, Objective
from repro_torch.core.objectives import MLPObjective, NonconvexLogistic
from repro_torch.train.state import TrainState


def _leaf(tree, path: str):
    node = tree
    for key in path.split("/"):
        node = node[key]
    return node


def to_params(w, device, param_shapes=()) -> torch.Tensor:
    """Flat float32 params on ``device`` from a flat vector (numpy or any
    array) or a nested dict of leaves laid out by ``param_shapes``
    (``((path, shape, dtype), ...)``, "/"-joined paths)."""
    if isinstance(w, dict):
        w = np.concatenate([np.asarray(_leaf(w, path)).reshape(-1)
                            for path, _, _ in param_shapes])
    return torch.as_tensor(np.asarray(w, np.float32), device=device)


def to_objective(source, device, l2_reg=None) -> Objective:
    """A port objective from the JAX package's, or from a dataset:

    * a JAX `MLPObjective` (``tokens``, ``targets``, ``vocab_size``, ...):
      the port's `MLPObjective` with the same corpus, widths, activation
      and init seed and scale;
    * a JAX `NonconvexLogistic` (``X``, ``y``, ``lam``, ``alpha``): the
      port's, with the same data and constants;
    * a dataset (anything with ``X``, ``y`` and ``l2_reg``, such as either
      package's `LogRegDataset`), a JAX `LogisticRegression` (``X``, ``y``,
      ``l2``), or an ``(X, y, l2)`` tuple: a `LogisticRegression`;
      ``l2_reg`` overrides the source's λ."""
    if hasattr(source, "tokens"):
        return MLPObjective(np.asarray(source.tokens), np.asarray(source.targets),
                            source.vocab_size, d_model=source.d_model,
                            d_hidden=source.d_hidden,
                            activation=source.activation,
                            init_seed=source.init_seed,
                            init_scale=source.init_scale, device=device)
    if hasattr(source, "alpha"):
        return NonconvexLogistic(np.array(source.X, np.float32),
                                 np.array(source.y, np.float32),
                                 lam=source.lam, alpha=source.alpha,
                                 device=device)
    if isinstance(source, tuple):
        X, y, l2 = source
    else:
        X, y = source.X, source.y
        l2 = getattr(source, "l2_reg", None)
        if l2 is None:
            l2 = source.l2
    l2 = l2 if l2_reg is None else l2_reg
    return LogisticRegression(np.array(X, np.float32), np.array(y, np.float32),
                              float(l2), device=device)


def to_model_params(params, device) -> dict:
    """The port's model params on ``device`` from the JAX package's nested
    param dict (leaves numpy or any array): the same keys, shapes, layout
    and dtypes."""
    if isinstance(params, dict):
        return {key: to_model_params(value, device)
                for key, value in params.items()}
    return torch.as_tensor(np.array(params), device=device)


def to_key(key, device=None) -> torch.Tensor:
    """A port key ([..., 2] int64) from a raw JAX key (uint32 [..., 2])."""
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=device)


def to_train_state(state, device) -> TrainState:
    """The port's `TrainState` on ``device`` from the JAX package's (params,
    opt_state, svrg, step; leaves numpy or any array): the same trees,
    shapes, dtypes and values."""
    svrg = None
    if state.svrg is not None:
        svrg = SVRGState(*(to_model_params(getattr(state.svrg, name), device)
                           for name in SVRGState._fields))
    return TrainState(params=to_model_params(state.params, device),
                      opt_state=to_model_params(state.opt_state, device),
                      svrg=svrg, step=to_model_params(state.step, device))
