"""The penalty K2 (`logreg_grad`) and K3 (`sweep_epoch`) add to the logistic
loss, and its plain versions.

Two kinds, named by the objective's data after ``(X, y)``:

  * L2 (`LogisticRegression`, data ``(X, y, l2)``): (λ/2)·‖w‖², gradient λw;
  * clipped (`NonconvexLogistic`, data ``(X, y, lam, alpha)``): the bounded,
    nonconvex λ·Σ_j αw_j²/(1 + αw_j²), gradient 2λαw/(1 + αw²)².

The wrappers take the penalty as ``reg``: a float λ or a 1-tuple ``(λ,)``
for L2, a pair ``(lam, alpha)`` for the clipped kind. Every constant is a
float32 and every operation a float32 operation, in the order the kernels
use (explicitly rounded intrinsics there, no fused multiply-add), so K3 is
equal in bits to its plain version for both kinds:

    L2 gradient       l2 · w
    clipped gradient  (c · w) / (den · den),  c = (2·lam) · alpha,
                      den = 1 + (alpha · w) · w
    L2 value          (l2 / 2) · float32(Σ w·w)
    clipped value     lam · float32(Σ aw2 / (1 + aw2)),  aw2 = (alpha · w) · w

with the sums over the last axis taken in float64 and rounded once. The
clipped forms are the JAX package's `NonconvexLogistic._penalty_grad` and
`_penalty` (``lam * 2.0 * alpha * w / (den * den)``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

L2, CLIPPED = 0, 1


class Regularizer(NamedTuple):
    kind: int      # L2 or CLIPPED
    lam: float     # λ (the L2 weight, or the clipped penalty's λ), float32
    alpha: float   # the clip sharpness α (0 for L2), float32


def _f32(v) -> float:
    return float(np.float32(v))


def regularizer(reg) -> Regularizer:
    """The penalty named by ``reg``: a float or ``(l2,)`` for L2, ``(lam,
    alpha)`` for the clipped kind; its constants rounded to float32."""
    if isinstance(reg, Regularizer):
        return reg
    if isinstance(reg, (tuple, list)):
        if len(reg) == 1:
            return Regularizer(L2, _f32(reg[0]), 0.0)
        if len(reg) == 2:
            return Regularizer(CLIPPED, _f32(reg[0]), _f32(reg[1]))
        raise ValueError(f"a regularizer is (l2,) or (lam, alpha), got "
                         f"{len(reg)} values")
    return Regularizer(L2, _f32(reg), 0.0)


def clip_coef(reg: Regularizer) -> float:
    """c = (2·lam)·alpha in float32, the clipped gradient's constant."""
    return _f32(np.float32(np.float32(2.0) * np.float32(reg.lam))
                * np.float32(reg.alpha))


def grad(reg, w):
    """The penalty's gradient at ``w`` (float32, any shape)."""
    reg = regularizer(reg)
    if reg.kind == L2:
        return reg.lam * w
    den = 1.0 + reg.alpha * w * w
    return clip_coef(reg) * w / (den * den)


def value(reg, w):
    """The penalty at each row of ``w`` [..., d] → [...] (float32)."""
    reg = regularizer(reg)
    if reg.kind == L2:
        sq = torch.sum((w * w).to(torch.float64), dim=-1).to(w.dtype)
        return 0.5 * reg.lam * sq
    aw2 = reg.alpha * w * w
    ratio = torch.sum((aw2 / (1.0 + aw2)).to(torch.float64), dim=-1)
    return reg.lam * ratio.to(w.dtype)
