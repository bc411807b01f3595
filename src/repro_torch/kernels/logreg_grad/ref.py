"""Plain torch version of the full logistic-regression gradient for C weight
rows (paper §5):

    g[c] = −(1/n) Xᵀ (y · σ(−y · X w[c])) + R'(w[c])

with the margins as a broadcast-multiply + row-reduce and the scaled
residual ``−y·σ(−y·z)/n`` formed before the column sum, as
``csrc/logreg_grad.cu`` forms it, and R' the gradient of the L2 or the
clipped penalty (`repro_torch.kernels.regularizer`). Rows are computed one
at a time, so a row's bits never depend on the other rows of the call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import regularizer


def logreg_grad_ref(X, y, W, reg):
    """X [n, p], y [n], W [C, p] → G [C, p]; ``reg`` names the penalty: a
    float λ (L2) or ``(lam, alpha)`` (clipped)."""
    reg = regularizer.regularizer(reg)
    n = X.shape[0]
    rows = []
    for w in W:
        z = torch.sum(X * w, dim=-1)
        s = (-y * torch.sigmoid(-y * z)) / n
        rows.append(torch.sum(s[:, None] * X, dim=0) + regularizer.grad(reg, w))
    return torch.stack(rows)
