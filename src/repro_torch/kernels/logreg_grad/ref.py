"""Plain torch version of the full logistic-regression gradient for C weight
rows (paper §5):

    g[c] = −(1/n) Xᵀ (y · σ(−y · X w[c])) + λ w[c]

with the margins as a broadcast-multiply + row-reduce and the scaled
residual ``−y·σ(−y·z)/n`` formed before the column sum, as
``csrc/logreg_grad.cu`` forms it. Rows are computed one at a time, so a
row's bits never depend on the other rows of the call.
"""
from __future__ import annotations

import torch


def logreg_grad_ref(X, y, W, l2: float):
    """X [n, p], y [n], W [C, p] → G [C, p]."""
    n = X.shape[0]
    rows = []
    for w in W:
        z = torch.sum(X * w, dim=-1)
        s = (-y * torch.sigmoid(-y * z)) / n
        rows.append(torch.sum(s[:, None] * X, dim=0) + l2 * w)
    return torch.stack(rows)
