"""Plain torch version of the fused SVRG control-variate update:

    u' = u − lr · (g − g0 + gf + wd·u)

Math in float32, the result cast back to ``u.dtype`` — the same arithmetic,
in the same order, as ``csrc/svrg_update.cu``. ``u`` is ``[C, d]`` with a
per-row ``lr[C]`` (or ``[d]`` with a scalar ``lr``).

The kernel's epilogue, as the torch ops it replaces: with ``ring``
``[C, B, d]`` and ``slot`` ``[C]`` (int64), ``ring[c, slot[c]] = u'[c]``;
with ``acc`` (``u``'s shape), ``acc += u'``. Both are updated in place.
"""
from __future__ import annotations

import torch


def svrg_update_ref(u, g, g0, gf, lr, wd: float = 0.0, *, ring=None,
                    slot=None, acc=None):
    f32 = torch.float32
    lr = torch.as_tensor(lr, dtype=f32, device=u.device)
    if lr.dim() == 1 and u.dim() == 2:
        lr = lr[:, None]
    v = (g.to(f32) - g0.to(f32)) + gf.to(f32)
    if wd:
        v = v + wd * u.to(f32)
    out = (u.to(f32) - lr * v).to(u.dtype)
    if ring is not None:
        rows = torch.arange(ring.shape[0], device=ring.device)
        ring[rows, slot] = out.reshape(-1, out.shape[-1])
    if acc is not None:
        acc += out
    return out
