"""Objectives: the pluggable protocol the engines optimize, and the paper's
own instance (L2-regularized logistic regression, paper §5):

    f(w) = (1/n) Σ_i log(1 + exp(-y_i x_i·w)) + (λ/2)||w||²

The port of `repro.core.objective`. The engines (`repro_torch.core.asysvrg`
/ `hogwild` / `svrg` / `sweep`) call only the flat adapters of
:class:`Objective`, with params as a flat vector — or, for the batched
sweep engine, a ``[C, d]`` block of rows. Every math method therefore takes
``w`` with any leading batch shape and treats rows independently: a row's
result never depends on the other rows it is computed with.

The snapshot gradient goes through the ``logreg_grad`` kernel
(`repro_torch.kernels.logreg_grad`), which on CPU tensors runs its plain
version. Margins and sums to a scalar are taken in float64 and rounded
once, so they do not depend on summation order: the card, the CPU and any
batch agree on them to within float64 rounding.

Only bare-vector params exist in this slice; pytree params arrive with the
MLP objective.
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.logreg_grad.ops import logreg_grad


def default_device(device=None) -> torch.device:
    """``device``, by default the card: entry points run on CUDA unless the
    caller names another device. Raises where the card is asked for and
    there is none, rather than moving to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the port on "
            "the CPU")
    return device


# Margins and transcendental elementwise ops run in float64 and round once
# to float32. torch's CPU kernels evaluate the SIMD body and the scalar tail
# of a tensor with different code, and its float32 sum over p on the card can
# round a row differently in a [1, p] and a [C, p] call, so a float32 result
# could depend on which rows share the batch. Rounded from float64 it does
# not (to within float64 rounding).

def _log1pexp(z):
    """Numerically stable log(1 + e^z), in float64."""
    z = z.to(torch.float64)
    return torch.logaddexp(torch.zeros_like(z), z)


def _exact_sum(v):
    """Σ over the last axis, accumulated in float64 and rounded once to
    ``v.dtype`` — order-independent to within float64 rounding."""
    return torch.sum(v.to(torch.float64), dim=-1).to(v.dtype)


def _margins_stable(X, y, w):
    """y ⊙ (X w) as a broadcast-multiply + row-reduce summed in float64;
    ``w`` [..., p] → [..., n] float64."""
    return y * torch.sum(X * w[..., None, :], dim=-1, dtype=torch.float64)


def loss_fixed_order(X, y, l2: float, w):
    """f(w) for ``w`` [..., p] → [...]; order-independent sums."""
    t = _log1pexp(-_margins_stable(X, y, w))
    n = X.shape[0]
    return (torch.sum(t, dim=-1) / n).to(w.dtype) + 0.5 * l2 * _exact_sum(w * w)


def full_grad_stable(X, y, l2: float, w):
    """∇f(w) for ``w`` [p] or [C, p] — through the ``logreg_grad`` kernel."""
    if w.dim() == 1:
        return logreg_grad(X, y, w[None, :], l2)[0]
    return logreg_grad(X, y, w, l2)


def sample_grad_stable(X, y, l2: float, w, i):
    """∇f_i(w). ``i`` is an index tensor of shape ``[*lead]`` and ``w``
    broadcasts against ``[*lead, p]``: ``i`` [C] with ``w`` [C, p] is one
    sample per row; ``i`` [L, C] with ``w`` [C, p] is L samples per row.

    The margin and the sigmoid are float64, rounded once: with a float32
    margin a sweep row on the card differed from the same row run alone
    (`tools/check_batch_independence.py`)."""
    x = X[i]
    yi = y[i]
    z = torch.sum(x * w, dim=-1, dtype=torch.float64)
    s = torch.sigmoid(-yi * z).to(torch.float32)
    return (-yi * s)[..., None] * x + l2 * w


# ---------------------------------------------------------------------------
# The pluggable objective protocol
# ---------------------------------------------------------------------------

class Objective:
    """Base class for pluggable objectives (flat params in this slice).

    A subclass provides the PURE pieces, which receive ``data`` (the tuple
    `data_args` returns) as an argument:

      * ``n`` — number of samples (set in ``__init__``);
      * :meth:`data_args` — tuple of tensors/scalars the engines pass down;
      * :meth:`init_params` — the w₀ vector;
      * :meth:`loss_fixed_order(data, w)` — f(w);
      * :meth:`full_grad_stable(data, w)` — ∇f(w);
      * :meth:`sample_grad_stable(data, i, w)` — ∇f_i(w);
      * :meth:`static_key` — hashable tuple of the static config.

    The base supplies the flat adapters the engine calls, fingerprinting
    for group keys, and `param_shapes` metadata.
    """

    n: int

    # -- subclass-provided pieces -------------------------------------------
    def data_args(self) -> Tuple:
        raise NotImplementedError

    def init_params(self):
        raise NotImplementedError

    def loss_fixed_order(self, data, w):                  # noqa: ARG002
        raise NotImplementedError

    def full_grad_stable(self, data, w):                  # noqa: ARG002
        raise NotImplementedError

    def sample_grad_stable(self, data, i, w):             # noqa: ARG002
        raise NotImplementedError

    def static_key(self) -> Tuple:
        return ()

    # -- sizing -------------------------------------------------------------
    @property
    def flat_dim(self) -> int:
        """Total parameter count — the engine's per-row vector width."""
        return int(self.init_params().numel())

    @property
    def device(self) -> torch.device:
        return self.data_args()[0].device

    def num_samples(self, data) -> int:
        """n, from the runtime data (the first data arg is sample-leading)."""
        return data[0].shape[0]

    # -- flat params ----------------------------------------------------------
    def as_flat(self, w):
        """Params as a flat float32 vector on the objective's device."""
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        if w.dim() != 1 or w.shape[0] != self.flat_dim:
            raise ValueError(
                f"flat params have shape {tuple(w.shape)}, objective expects "
                f"({self.flat_dim},)")
        return w

    def init_flat(self):
        return self.as_flat(self.init_params())

    # -- engine-facing flat adapters ----------------------------------------
    def flat_loss(self, data, w_flat):
        return self.loss_fixed_order(data, w_flat)

    def flat_full_grad(self, data, w_flat):
        return self.full_grad_stable(data, w_flat)

    def flat_sample_grad(self, data, i, w_flat):
        return self.sample_grad_stable(data, i, w_flat)

    # -- serial-driver conveniences -------------------------------------------
    def loss(self, w):
        return self.loss_fixed_order(self.data_args(), w)

    def full_grad(self, w):
        return self.full_grad_stable(self.data_args(), w)

    def sample_grad(self, w, i):
        return self.sample_grad_stable(self.data_args(), i, w)

    # -- identity ------------------------------------------------------------
    def runner_static_key(self) -> Tuple:
        return (type(self).__name__,) + tuple(self.static_key())

    def fingerprint(self) -> int:
        """crc32 of the objective's identity AND its data bytes (tensors as
        their bytes, Python floats as float32) — the same digest the JAX
        package computes for the same objective. Memoized: the data is
        immutable for the objective's lifetime."""
        fp = getattr(self, "_fingerprint_cache", None)
        if fp is None:
            fp = zlib.crc32(repr(self.runner_static_key()).encode())
            for leaf in self.data_args():
                if isinstance(leaf, torch.Tensor):
                    arr = np.ascontiguousarray(leaf.detach().cpu().numpy())
                else:
                    arr = np.asarray(leaf, np.float32)
                fp = zlib.crc32(arr.tobytes(),
                                zlib.crc32(str(arr.dtype).encode(), fp))
            self._fingerprint_cache = fp
        return fp

    def param_shapes(self) -> Tuple:
        """((path, shape, dtype),) of the bare param vector."""
        w = self.init_params()
        return (("", tuple(w.shape), str(w.dtype).replace("torch.", "")),)


# ---------------------------------------------------------------------------
# Named-objective registry: `SweepSpec.objective` names a registered
# instance; empty string means "the call's default objective".
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, "Objective"] = {}


def register_objective(name: str, obj: "Objective") -> "Objective":
    """Register an objective instance under ``name`` (re-registering a name
    replaces it)."""
    if not name:
        raise ValueError("objective name must be non-empty")
    if not isinstance(obj, Objective):
        raise TypeError(f"expected an Objective, got {type(obj).__name__}")
    _REGISTRY[name] = obj
    return obj


def get_objective(name: str) -> "Objective":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no objective registered under {name!r} "
            f"(registered: {sorted(_REGISTRY)})") from None


def registered_objectives() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def unregister_objective(name: str) -> None:
    _REGISTRY.pop(name, None)


class LogisticRegression(Objective):
    """Objective bound to a dataset (X, y, λ) — the paper's own workload.

    ``X`` and ``y`` (numpy arrays or tensors) are placed on ``device`` as
    float32: CUDA by default, which raises where there is no card;
    ``device="cpu"`` runs the plain torch versions of the kernels.
    """

    def __init__(self, X, y, l2_reg: float = 1e-4, device=None):
        device = default_device(device)
        self.X = torch.as_tensor(X, dtype=torch.float32, device=device)
        self.X = self.X.contiguous()
        self.y = torch.as_tensor(y, dtype=torch.float32, device=device)
        self.y = self.y.contiguous()
        self.l2 = float(l2_reg)
        self.n, self.p = self.X.shape

    # -- protocol ------------------------------------------------------------
    def data_args(self) -> Tuple:
        return (self.X, self.y, self.l2)

    def init_params(self):
        return torch.zeros(self.p, dtype=torch.float32, device=self.X.device)

    def loss_fixed_order(self, data, w):
        X, y, l2 = data
        return loss_fixed_order(X, y, l2, w)

    def full_grad_stable(self, data, w):
        X, y, l2 = data
        return full_grad_stable(X, y, l2, w)

    def sample_grad_stable(self, data, i, w):
        X, y, l2 = data
        return sample_grad_stable(X, y, l2, w, i)

    # -- the paper's partitioned snapshot pass --------------------------------
    def partial_full_grad(self, w, lo: int, size: int):
        """One thread's UN-normalized gradient sum over rows [lo, lo+size);
        the caller sums the partitions and divides by n."""
        Xs = self.X[lo:lo + size]
        ys = self.y[lo:lo + size]
        s = torch.sigmoid(-_margins_stable(Xs, ys, w)).to(torch.float32)
        return torch.sum((-(ys * s))[:, None] * Xs, dim=0)
