"""ctypes launcher of ``csrc/sweep_epoch.cu`` (built by `kernels._build`).

Takes tensors the wrapper (`ops.sweep_epoch`) has already checked and
allocated; passes raw device pointers and PyTorch's current stream, and
returns the CUDA error code of the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

ENGINE_CODES = {"asysvrg": 0, "hogwild": 1}


@functools.cache
def _entries():
    lib = library("sweep_epoch")
    max_shared = lib.sweep_epoch_max_shared_bytes
    max_shared.argtypes = [ctypes.c_int]
    max_shared.restype = ctypes.c_longlong
    launch_fn = lib.sweep_epoch_launch
    launch_fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 5
                          + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                          + [ctypes.c_int] + [ctypes.c_float] * 3
                          + [ctypes.c_void_p])
    launch_fn.restype = ctypes.c_int
    draws_fn = lib.sweep_epoch_draws
    draws_fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.c_void_p] * 5)
    draws_fn.restype = ctypes.c_int
    return max_shared, launch_fn, draws_fn


def max_shared_bytes(device: torch.device) -> int:
    """The most dynamic shared memory a block may use on ``device``."""
    return int(_entries()[0](device.index or 0))


def launch(X, y, w, mu, keys, step, row_ints, ring, out, terms, loss, *,
           engine: str, total: int, buf_len: int, option: int, drop: bool,
           staged: bool, smem_bytes: int, reg, keep_p: float) -> int:
    """out [C, d] = one epoch of ``total`` updates from w [C, d] and loss
    [C] = f(out); ``ring`` is a [C, buf_len, d] buffer or None (ring in
    shared memory), ``staged`` takes the sampled rows through shared-memory
    stages (else through L2 prefetches), ``smem_bytes`` is the block's
    dynamic shared memory, which the kernel checks against its own layout;
    ``terms`` is a [C, n] float64 buffer for the loss's per-sample terms,
    ``mu`` None for Hogwild!; ``reg`` a `regularizer.Regularizer`."""
    n, d = X.shape
    stream = torch.cuda.current_stream(X.device).cuda_stream
    return _entries()[1](
        X.data_ptr(), y.data_ptr(), w.data_ptr(),
        None if mu is None else mu.data_ptr(), keys.data_ptr(),
        step.data_ptr(), row_ints.data_ptr(),
        None if ring is None else ring.data_ptr(), out.data_ptr(),
        terms.data_ptr(), loss.data_ptr(), n, d, w.shape[0], total, buf_len,
        ENGINE_CODES[engine], option, int(drop), int(staged), smem_bytes,
        reg.kind, reg.lam, reg.alpha, keep_p, stream)


def draws(key, n: int, d: int, tau: int, delay_id: int, steps: int, idx, age,
          read_u, drop_u) -> int:
    """The kernel's draws for one key [2]: idx, age [steps] int32 and the
    reader and drop uniforms [steps, d] float32."""
    stream = torch.cuda.current_stream(key.device).cuda_stream
    return _entries()[2](key.data_ptr(), n, d, tau, delay_id, steps,
                         idx.data_ptr(), age.data_ptr(), read_u.data_ptr(),
                         drop_u.data_ptr(), stream)
