"""ctypes launcher of ``csrc/sweep_epoch_mlp.cu`` (built by `kernels._build`).

Takes tensors the wrapper (`ops`) has already checked and allocated; passes
raw device pointers and PyTorch's current stream, and returns the CUDA error
code of the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

ENGINE_CODES = {"asysvrg": 0, "hogwild": 1}

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


@functools.cache
def _entries():
    lib = library("sweep_epoch_mlp")
    max_shared = lib.sweep_epoch_mlp_max_shared_bytes
    max_shared.argtypes = [_I]
    max_shared.restype = _LL
    epoch = lib.sweep_epoch_mlp_launch
    epoch.argtypes = ([_P] * 10 + [_LL] * 5 + [_I] + [_LL] * 3 + [_I] * 3
                      + [_LL, _LL, _F, _P])
    full = lib.sweep_epoch_mlp_full
    full.argtypes = ([_P] * 6 + [_LL] * 5 + [_I] + [_LL] * 2 + [_I]
                     + [_LL] * 2 + [_P])
    grad = lib.sweep_epoch_mlp_sample_grad
    grad.argtypes = ([_P, _P, _LL, _LL, _P, _P] + [_LL] * 4
                     + [_I, _I, _LL, _LL, _P])
    for fn in (epoch, full, grad):
        fn.restype = _I
    return max_shared, epoch, full, grad


def max_shared_bytes(device: torch.device) -> int:
    """The most dynamic shared memory a block may use on ``device``."""
    return int(_entries()[0](device.index or 0))


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch(tokens, targets, w, mu, keys, step, row_ints, vecs, out, loss, *,
           dims, act: int, engine: str, total: int, buf_len: int,
           option: int, drop: bool, smem_bytes: int, threads: int,
           keep_p: float) -> int:
    """out [C, d] = one epoch of ``total`` updates from w [C, d] and loss
    [C] = f(out); ``vecs`` is the global placement's [C, row floats]
    buffer or None (all in shared memory), ``mu`` None for Hogwild!;
    ``dims`` = (S, V, D, H)."""
    return _entries()[1](
        tokens.data_ptr(), targets.data_ptr(), w.data_ptr(), _ptr(mu),
        keys.data_ptr(), step.data_ptr(), row_ints.data_ptr(), _ptr(vecs),
        out.data_ptr(), loss.data_ptr(), tokens.shape[0], *dims, act,
        w.shape[0], total, buf_len, ENGINE_CODES[engine], option, int(drop),
        smem_bytes, threads, keep_p, _stream(w))


def full(tokens, targets, w, acc64, mu, loss, *, dims, act: int, sets: int,
         staged: bool, smem_bytes: int, threads: int) -> int:
    """mu [C, d] = the mean of the samples' gradients at w [C, d] (through
    the float64 scratch ``acc64``) and loss [C] = f(w), ``sets`` samples at
    once, each row in shared memory with ``staged``; with ``mu`` and
    ``acc64`` None the loss alone."""
    return _entries()[2](
        tokens.data_ptr(), targets.data_ptr(), w.data_ptr(), _ptr(acc64),
        _ptr(mu), loss.data_ptr(), tokens.shape[0], *dims, act, w.shape[0],
        sets, int(staged), smem_bytes, threads, _stream(w))


def sample_grad(tokens, targets, i: int, w, g, *, dims, act: int,
                staged: bool, smem_bytes: int, threads: int) -> int:
    """g [d] = ∇f_i(w) for one row w [d]."""
    return _entries()[3](
        tokens.data_ptr(), targets.data_ptr(), tokens.shape[0], i,
        w.data_ptr(), g.data_ptr(), *dims, act, int(staged), smem_bytes,
        threads, _stream(w))
