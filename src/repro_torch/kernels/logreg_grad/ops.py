"""Public full logistic-regression gradient: device dispatch, input checks,
launch count.

`logreg_grad` runs the plain version (`ref.logreg_grad_ref`) for CPU
tensors and the CUDA kernels (`csrc/logreg_grad.cu`) for CUDA tensors; it
counts every launch in ``logreg_grad.launches``. It is the AsySVRG
snapshot gradient μ = ∇f(w), for all C rows of a sweep group in one call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch, regularizer
from repro_torch.kernels.logreg_grad import kernel
from repro_torch.kernels.logreg_grad.ref import logreg_grad_ref


def logreg_grad(X, y, W, reg):
    """∇f(w) = −(1/n) Xᵀ(y·σ(−y·Xw)) + R'(w) for each row w of ``W``.

    ``X`` [n, p], ``y`` [n], ``W`` [C, p], all float32 → ``G`` [C, p].
    ``reg`` names the penalty R: a float λ for L2 (R' = λw), or ``(lam,
    alpha)`` for the clipped penalty of `NonconvexLogistic`
    (`repro_torch.kernels.regularizer`).
    """
    reg = regularizer.regularizer(reg)
    if dispatch.route(X, y, W) == dispatch.REFERENCE:
        return logreg_grad_ref(X, y, W, reg)
    if X.dim() != 2 or W.dim() != 2:
        raise ValueError(f"logreg_grad: X {tuple(X.shape)} and W "
                         f"{tuple(W.shape)} must both be 2-D")
    n, p = X.shape
    if y.shape != (n,) or W.shape[1] != p or W.shape[0] < 1:
        raise ValueError(f"logreg_grad: y {tuple(y.shape)}, W "
                         f"{tuple(W.shape)} do not fit X {tuple(X.shape)}")
    if any(t.dtype != torch.float32 for t in (X, y, W)):
        raise TypeError("logreg_grad: X, y and W must be float32")
    if not all(t.is_contiguous() for t in (X, y, W)):
        raise ValueError("logreg_grad: inputs must be contiguous")
    C = W.shape[0]
    scratch = torch.empty(kernel.scratch_floats(n, p, C), dtype=torch.float32,
                          device=X.device)
    G = torch.empty((C, p), dtype=torch.float32, device=X.device)
    rc = kernel.launch(X, y, W, scratch, G, reg)
    if rc != 0:
        raise RuntimeError(f"logreg_grad kernel launch failed: CUDA error {rc}")
    logreg_grad.launches += 1
    return G


logreg_grad.launches = 0
