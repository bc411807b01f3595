"""Public fused SVRG update: device dispatch, input checks, launch count.

`svrg_update` runs the plain version (`ref.svrg_update_ref`) for CPU
tensors and the CUDA kernel (`csrc/svrg_update.cu`) for CUDA tensors; it
counts every kernel launch in ``svrg_update.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.svrg_update import kernel
from repro_torch.kernels.svrg_update.ref import svrg_update_ref


def svrg_update(u, g, g0, gf, lr, wd: float = 0.0):
    """u' = u − lr·(g − g0 + gf + wd·u), math in float32.

    ``u``, ``g``, ``g0``, ``gf``: one shape, ``[C, d]`` (or ``[d]``, one
    row), float32 or bfloat16. ``lr``: a float, or a float32 tensor with
    one step size per row (``[C]``).
    """
    if dispatch.route(u, g, g0, gf) == dispatch.REFERENCE:
        return svrg_update_ref(u, g, g0, gf, lr, wd)
    if u.dim() not in (1, 2):
        raise ValueError(f"svrg_update: u is {tuple(u.shape)}, expected [d] "
                         "or [C, d]")
    rows = u.reshape(-1, u.shape[-1])
    C = rows.shape[0]
    for name, t in (("g", g), ("g0", g0), ("gf", gf)):
        if t.shape != u.shape or t.dtype != u.dtype:
            raise ValueError(f"svrg_update: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, u is {tuple(u.shape)} {u.dtype}")
    if u.dtype not in kernel.DTYPE_CODES:
        raise TypeError(f"svrg_update: no kernel for dtype {u.dtype}")
    if not all(t.is_contiguous() for t in (u, g, g0, gf)):
        raise ValueError("svrg_update: inputs must be contiguous")
    lr = torch.as_tensor(lr, dtype=torch.float32, device=u.device)
    lr = lr.expand(C).contiguous() if lr.dim() == 0 else lr
    if lr.shape != (C,) or not lr.is_contiguous():
        raise ValueError(f"svrg_update: lr is {tuple(lr.shape)}, expected "
                         f"({C},) for {C} rows")
    out = torch.empty_like(u)
    rc = kernel.launch(rows, g, g0, gf, lr, out, float(wd))
    if rc != 0:
        raise RuntimeError(f"svrg_update kernel launch failed: CUDA error {rc}")
    svrg_update.launches += 1
    return out


svrg_update.launches = 0
