"""ctypes launcher of ``csrc/svrg_update.cu`` (built by `kernels._build`).

Takes tensors the wrapper (`ops.svrg_update`) has already checked and
allocated; passes raw device pointers and PyTorch's current stream, and
returns the CUDA error code of the launch. The C entry takes its fifteen
arguments as one array of int64 in a buffer of the calling thread: a ctypes
call converts each argument on its own, so one packed argument replaces
fifteen conversions on the engine's per-update path.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import threading

import torch

from repro_torch.kernels._build import library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NARGS = 15
_local = threading.local()


@functools.cache
def _entry():
    fn = library("svrg_update").svrg_update_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _args():
    """This thread's argument buffer and its address."""
    try:
        return _local.args
    except AttributeError:
        buf = (ctypes.c_int64 * _NARGS)()
        _local.args = (buf, ctypes.addressof(buf))
        return _local.args


def _float_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0] if x else 0


def launch(u, g, g0, gf, lr, out, wd: float, ring=None, slot=None,
           acc=None) -> int:
    """out = u − lr·(g − g0 + gf + wd·u) for [rows, d] tensors (or [d]),
    lr [rows]; then ring[c, slot[c]] = out[c] and acc += out where given."""
    d = u.shape[-1]
    buf, addr = _args()
    buf[:] = (DTYPE_CODES[u.dtype], u.data_ptr(), g.data_ptr(), g0.data_ptr(),
              gf.data_ptr(), lr.data_ptr(), out.data_ptr(),
              0 if ring is None else ring.data_ptr(),
              0 if ring is None else slot.data_ptr(),
              0 if acc is None else acc.data_ptr(),
              u.numel() // d, d, 0 if ring is None else ring.shape[1],
              _float_bits(wd),
              torch._C._cuda_getCurrentRawStream(u.get_device()))
    return _entry()(addr)
