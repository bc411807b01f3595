"""Objectives: the pluggable protocol the engines optimize, and the paper's
own instance (L2-regularized logistic regression, paper §5):

    f(w) = (1/n) Σ_i log(1 + exp(-y_i x_i·w)) + (λ/2)||w||²

The port of `repro.core.objective`. The engines (`repro_torch.core.asysvrg`
/ `hogwild` / `svrg` / `sweep`) call only the flat adapters of
:class:`Objective`, with params as a flat vector — or, for the batched
sweep engine, a ``[C, d]`` block of rows. Every math method therefore takes
``w`` with any leading batch shape and treats rows independently: a row's
result never depends on the other rows it is computed with. Params may be
a pytree (a nested dict of same-dtype tensors, the MLP's); the flat vector
is its leaves in the JAX package's tree order (`repro_torch.utils.tree`),
so a flat row means the same tree in both packages.

The snapshot gradient goes through the ``logreg_grad`` kernel
(`repro_torch.kernels.logreg_grad`), which on CPU tensors runs its plain
version. Margins and sums to a scalar are taken in float64 and rounded
once, so they do not depend on summation order: the card, the CPU and any
batch agree on them to within float64 rounding. The logistic functions take
the penalty as ``reg`` (`repro_torch.kernels.regularizer`): a float λ for
the L2 term, ``(lam, alpha)`` for `NonconvexLogistic`'s clipped one
(`repro_torch.core.objectives`).
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import regularizer
from repro_torch.kernels.logreg_grad.ops import logreg_grad
from repro_torch.utils.tree import (tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_ravel, tree_unravel_fn)


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


def _margins_stable(X, y, w):
    """y ⊙ (X w) as a broadcast-multiply + row-reduce summed in float64;
    ``w`` [..., p] → [..., n] float64."""
    return y * torch.sum(X * w[..., None, :], dim=-1, dtype=torch.float64)


def loss_fixed_order(X, y, reg, w):
    """f(w) for ``w`` [..., p] → [...]; order-independent sums. ``reg``: a
    float λ (L2) or ``(lam, alpha)`` (clipped)."""
    t = _log1pexp(-_margins_stable(X, y, w))
    n = X.shape[0]
    return (torch.sum(t, dim=-1) / n).to(w.dtype) + regularizer.value(reg, w)


def full_grad_stable(X, y, reg, w):
    """∇f(w) for ``w`` [p] or [C, p] — through the ``logreg_grad`` kernel."""
    if w.dim() == 1:
        return logreg_grad(X, y, w[None, :], reg)[0]
    return logreg_grad(X, y, w, reg)


def sample_grad_stable(X, y, reg, w, i):
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
    return (-yi * s)[..., None] * x + regularizer.grad(reg, w)


# ---------------------------------------------------------------------------
# The pluggable objective protocol
# ---------------------------------------------------------------------------

class Objective:
    """Base class for pluggable objectives: pytree params, per-sample grads.

    A subclass provides the PURE pieces, which receive ``data`` (the tuple
    `data_args` returns) as an argument:

      * ``n`` — number of samples (set in ``__init__``);
      * :meth:`data_args` — tuple of tensors/scalars the engines pass down;
      * :meth:`init_params` — the w₀ vector, or a nested dict of same-dtype
        tensors;
      * :meth:`loss_fixed_order(data, w)` — f(w);
      * :meth:`full_grad_stable(data, w)` — ∇f(w);
      * :meth:`sample_grad_stable(data, i, w)` — ∇f_i(w);
      * :meth:`static_key` — hashable tuple of the static config.

    The base supplies the flat adapters the engine calls (for a pytree
    objective they unravel the flat rows; objectives whose params are a
    flat vector, or that compute on the flat rows themselves, override
    them), fingerprinting for group keys, and `param_shapes` metadata.
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

    # -- sizing / template (cached: shapes are static per instance) ---------
    @property
    def _template(self):
        tpl = getattr(self, "_template_cache", None)
        if tpl is None:
            tpl = self.init_params()
            self._template_cache = tpl
        return tpl

    @property
    def flat_dim(self) -> int:
        """Total parameter count — the engine's per-row vector width."""
        return int(sum(x.numel() for x in tree_leaves(self._template)))

    @property
    def device(self) -> torch.device:
        return self.data_args()[0].device

    def num_samples(self, data) -> int:
        """n, from the runtime data (the first data arg is sample-leading)."""
        return data[0].shape[0]

    # -- flat <-> pytree bridge ---------------------------------------------
    def ravel_params(self, tree):
        return tree_ravel(tree)

    def unravel_params(self, flat):
        """The param tree of flat params ``[..., flat_dim]`` (each leaf
        ``[..., *shape]``)."""
        fn = getattr(self, "_unravel_cache", None)
        if fn is None:
            fn = tree_unravel_fn(self._template)
            self._unravel_cache = fn
        return fn(flat)

    def as_flat(self, w):
        """Params — a pytree like `init_params`' or an already-flat vector —
        as a flat float32 vector on the objective's device."""
        if isinstance(w, dict):
            w = tree_ravel(tree_map(
                lambda v: v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)), w))
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        if w.dim() != 1 or w.shape[0] != self.flat_dim:
            raise ValueError(
                f"flat params have shape {tuple(w.shape)}, objective expects "
                f"({self.flat_dim},)")
        return w

    def init_flat(self):
        return self.as_flat(self.ravel_params(self.init_params()))

    # -- engine-facing flat adapters ----------------------------------------
    def flat_loss(self, data, w_flat):
        return self.loss_fixed_order(data, self.unravel_params(w_flat))

    def flat_full_grad(self, data, w_flat):
        return self.ravel_params(
            self.full_grad_stable(data, self.unravel_params(w_flat)))

    def flat_sample_grad(self, data, i, w_flat):
        return self.ravel_params(
            self.sample_grad_stable(data, i, self.unravel_params(w_flat)))

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
        """Serializable ((path, shape, dtype), ...) of the param tree, as the
        JAX package writes it: a bare vector is ``(("", shape, dtype),)``,
        dict trees use "/"-joined key paths in sorted key order; dtypes by
        name ("float32")."""
        return tuple((path, tuple(leaf.shape),
                      str(leaf.dtype).replace("torch.", ""))
                     for path, leaf in tree_flatten_with_path(self._template))


def params_from_flat(flat: np.ndarray, param_shapes):
    """Rebuild a param pytree from a flat vector + `Objective.param_shapes`
    metadata (numpy-side; the wire format's consumer). A single unnamed
    leaf comes back as the bare (reshaped) array; named leaves as a nested
    dict."""
    if not param_shapes:
        return flat
    arrays = []
    off = 0
    for _, shape, dtype in param_shapes:
        size = int(np.prod(shape)) if shape else 1
        arrays.append(np.asarray(flat[off:off + size], dtype)
                      .reshape(tuple(shape)))
        off += size
    if off != len(flat):
        raise ValueError(f"param_shapes cover {off} entries, flat vector "
                         f"has {len(flat)}")
    if len(param_shapes) == 1 and param_shapes[0][0] == "":
        return arrays[0]
    tree: Dict = {}
    for (path, _, _), arr in zip(param_shapes, arrays):
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = arr
    return tree


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

    # flat == pytree for a (p,) parameter vector: skip the generic bridge
    flat_loss = loss_fixed_order
    flat_full_grad = full_grad_stable
    flat_sample_grad = sample_grad_stable

    # -- the paper's partitioned snapshot pass --------------------------------
    def partial_full_grad(self, w, lo: int, size: int):
        """One thread's UN-normalized gradient sum over rows [lo, lo+size);
        the caller sums the partitions and divides by n."""
        Xs = self.X[lo:lo + size]
        ys = self.y[lo:lo + size]
        s = torch.sigmoid(-_margins_stable(Xs, ys, w)).to(torch.float32)
        return torch.sum((-(ys * s))[:, None] * Xs, dim=0)

    def minibatch_grad(self, w, idx):
        """Mean gradient over a batch of sample indices ``idx`` (beyond-paper
        batching), by matmuls as the JAX package computes it."""
        Xb, yb = self.X[idx], self.y[idx]
        s = torch.sigmoid(-yb * (Xb @ w))
        return (-(yb * s) @ Xb) / idx.shape[0] + self.l2 * w

    # -- constants for the theory-facing tests ------------------------------
    def smoothness(self) -> float:
        """L = max_i ‖x_i‖² / 4 + λ (float32, as the JAX package)."""
        row_sq = torch.sum(self.X * self.X, dim=1)
        return float(torch.max(row_sq) / 4.0 + self.l2)

    def strong_convexity(self) -> float:
        return self.l2

    def optimum(self, tol: float = 1e-12, max_iter: int = 5000):
        """High-accuracy reference optimum by deterministic gradient descent
        with the fixed step 1/L (the paper's "gap < 1e-4" metric is measured
        against it): ``(w*, f(w*))``. Each step's gradient is the matmul
        form of the JAX package's ``full_grad``, on the objective's
        device; ``tol`` is accepted for the JAX package's signature."""
        del tol
        step = 1.0 / self.smoothness()
        w = torch.zeros(self.p, dtype=torch.float32, device=self.X.device)
        for _ in range(max_iter):
            s = torch.sigmoid(-(self.y * (self.X @ w)))
            g = (-(self.y * s) @ self.X) / self.n + self.l2 * w
            w = w - step * g
        return w, float(self.loss(w))
