"""Public fused SVRG update: device dispatch, input checks, launch count.

`svrg_update` runs the plain version (`ref.svrg_update_ref`) for CPU
tensors and the CUDA kernel (`csrc/svrg_update.cu`) for CUDA tensors; it
counts every kernel launch in ``svrg_update.launches``. The engine calls it
once per inner update, so its host path is what one update costs on the
host: the checks below compare attributes and ints, and the launch passes
one packed argument (`kernel.launch`).

`apply_leaf` / `apply_tree` are the train step's fused update over a param
tree: one `svrg_update` per floating-point leaf, the leaf viewed as
``[numel // last_dim, last_dim]`` rows (the kernel takes any ``[C, d]``, so
the JAX package's padding to (64, 128) tiles is dropped).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.svrg_update import kernel
from repro_torch.kernels.svrg_update.ref import svrg_update_ref
from repro_torch.utils.tree import tree_map

_F32 = torch.float32


def svrg_update(u, g, g0, gf, lr, wd: float = 0.0, *, ring=None, slot=None,
                acc=None):
    """u' = u − lr·(g − g0 + gf + wd·u), math in float32; returns u'.

    ``u``, ``g``, ``g0``, ``gf``: one shape, ``[C, d]`` (or ``[d]``, one
    row), float32 or bfloat16. ``lr``: a float, or a float32 tensor with
    one step size per row (``[C]``) on ``u``'s device.

    The engine's inner step, in the same launch: ``ring`` ``[C, B, d]`` of
    ``u``'s dtype with ``slot`` ``[C]`` int64 on ``u``'s device gets
    ``ring[c, slot[c]] = u'[c]``, with ``slot`` in ``[0, B)``; ``acc`` of
    ``u``'s shape and dtype gets ``acc += u'``. Both are updated in place.
    """
    if not u.is_cuda:
        tensors = [t for t in (u, g, g0, gf, lr, ring, slot, acc)
                   if isinstance(t, torch.Tensor)]
        if dispatch.route(*tensors) == dispatch.REFERENCE:
            return svrg_update_ref(u, g, g0, gf, lr, wd, ring=ring, slot=slot,
                                   acc=acc)
    device = u.get_device()
    shape, dtype = u.shape, u.dtype
    if len(shape) not in (1, 2):
        raise ValueError(f"svrg_update: u is {tuple(shape)}, expected [d] "
                         "or [C, d]")
    if dtype not in kernel.DTYPE_CODES:
        raise TypeError(f"svrg_update: no kernel for dtype {dtype}")
    rows = shape[0] if len(shape) == 2 else 1
    for name, t in (("g", g), ("g0", g0), ("gf", gf), ("acc", acc)):
        if t is None:
            continue
        if t.shape != shape or t.dtype != dtype or t.get_device() != device:
            raise ValueError(f"svrg_update: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, u is {tuple(shape)} "
                             f"{dtype} on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"svrg_update: {name} is not contiguous")
    if not u.is_contiguous():
        raise ValueError("svrg_update: u is not contiguous")
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((rows,), float(lr), dtype=_F32, device=u.device)
    elif lr.dim() == 0:
        lr = lr.to(device=u.device, dtype=_F32).expand(rows).contiguous()
    if (lr.shape != (rows,) or lr.dtype != _F32 or lr.get_device() != device
            or not lr.is_contiguous()):
        raise ValueError(f"svrg_update: lr is {tuple(lr.shape)} {lr.dtype} "
                         f"on {lr.device}, expected ({rows},) float32 on "
                         f"{u.device}")
    if (ring is None) != (slot is None):
        raise ValueError("svrg_update: ring and slot come together")
    if ring is not None:
        rshape = ring.shape
        if (len(rshape) != 3 or rshape[0] != rows or rshape[2] != shape[-1]
                or ring.dtype != dtype or ring.get_device() != device
                or not ring.is_contiguous()):
            raise ValueError(f"svrg_update: ring is {tuple(ring.shape)} "
                             f"{ring.dtype} on {ring.device}, expected a "
                             f"contiguous [{rows}, B, {shape[-1]}] {dtype}")
        if (slot.shape != (rows,) or slot.dtype != torch.int64
                or slot.get_device() != device or not slot.is_contiguous()):
            raise ValueError(f"svrg_update: slot is {tuple(slot.shape)} "
                             f"{slot.dtype} on {slot.device}, expected "
                             f"({rows},) int64")
    out = torch.empty_like(u)
    rc = kernel.launch(u, g, g0, gf, lr, out, wd, ring, slot, acc)
    if rc != 0:
        raise RuntimeError(f"svrg_update kernel launch failed: CUDA error {rc}")
    svrg_update.launches += 1
    return out


svrg_update.launches = 0


def apply_leaf(u, g, g0, gf, lr, wd: float = 0.0):
    """u − lr·(g − g0 + gf + wd·u) for one param leaf of any shape (a 0-d or
    1-d leaf is one row); ``lr`` a float or a 0-d float32 tensor on ``u``'s
    device (no host read). A leaf that is not contiguous is copied first."""
    shape = (-1, u.shape[-1]) if u.dim() >= 2 else (-1,)
    out = svrg_update(*(t.contiguous().view(shape) for t in (u, g, g0, gf)),
                      lr, wd)
    return out.view(u.shape)


def apply_tree(params, g, g0, gf, lr, wd: float = 0.0):
    """`apply_leaf` over every leaf of the param tree: one launch per leaf
    on the card."""
    return tree_map(lambda u, a, b, c: apply_leaf(u, a, b, c, lr, wd),
                    params, g, g0, gf)
