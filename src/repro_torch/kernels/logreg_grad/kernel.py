"""ctypes launcher of ``csrc/logreg_grad.cu`` (built by `kernels._build`).

Takes tensors the wrapper (`ops.logreg_grad`) has already checked and
allocated; passes raw device pointers and PyTorch's current stream, and
returns the CUDA error code of the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library


@functools.cache
def _entries():
    lib = library("logreg_grad")
    scratch = lib.logreg_grad_scratch_floats
    scratch.argtypes = [ctypes.c_longlong] * 3
    scratch.restype = ctypes.c_longlong
    launch_fn = lib.logreg_grad_launch
    launch_fn.argtypes = ([ctypes.c_void_p] * 5
                          + [ctypes.c_longlong] * 3
                          + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                             ctypes.c_void_p])
    launch_fn.restype = ctypes.c_int
    return scratch, launch_fn


def scratch_floats(n: int, p: int, C: int) -> int:
    """float32 elements of scratch one call needs."""
    return int(_entries()[0](n, p, C))


def launch(X, y, W, scratch, G, reg) -> int:
    """G = ∇f(W) for X [n, p], y [n], W [C, p], into G [C, p]; ``reg`` a
    `regularizer.Regularizer`."""
    n, p = X.shape
    stream = torch.cuda.current_stream(X.device).cuda_stream
    return _entries()[1](X.data_ptr(), y.data_ptr(), W.data_ptr(),
                         scratch.data_ptr(), G.data_ptr(), n, p, W.shape[0],
                         reg.kind, reg.lam, reg.alpha, stream)
