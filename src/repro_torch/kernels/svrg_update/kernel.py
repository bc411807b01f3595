"""ctypes launcher of ``csrc/svrg_update.cu`` (built by `kernels._build`).

Takes tensors the wrapper (`ops.svrg_update`) has already checked and
allocated; passes raw device pointers and PyTorch's current stream, and
returns the CUDA error code of the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = library("svrg_update").svrg_update_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(u, g, g0, gf, lr, out, wd: float) -> int:
    """out = u − lr·(g − g0 + gf + wd·u) for [rows, d] tensors, lr [rows]."""
    rows, d = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    return _entry()(DTYPE_CODES[u.dtype], u.data_ptr(), g.data_ptr(),
                    g0.data_ptr(), gf.data_ptr(), lr.data_ptr(),
                    out.data_ptr(), rows, d, wd, stream)
