"""ctypes launchers of the two flash-attention sources (built by
`kernels._build`): ``csrc/flash_attention_wgmma.cu`` (route ``"wgmma"``,
bf16 on the tensor cores) and ``csrc/flash_attention.cu`` (route
``"simt"``, float32 or bf16 on the CUDA cores).

Takes tensors the wrapper (`ops.gqa_flash`) has already checked and
allocated; passes raw device pointers, element strides and PyTorch's current
stream, and returns the CUDA error code of the launch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TENSOR_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _entry(route: str):
    if route == "wgmma":
        fn = library("flash_attention_wgmma").flash_attention_wgmma_launch
        fn.argtypes = _TENSOR_ARGS
    else:
        fn = library("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_int] + _TENSOR_ARGS
    fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, out, *, causal: bool, window: int, route: str) -> int:
    """out [B, Sq, N, h] = attention of q [B, Sq, N, h] over k, v
    [B, Sk, K, h], by the kernel of ``route`` (``"wgmma"`` or ``"simt"``)."""
    B, Sq, N, h = q.shape
    Sk, K = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            B, Sq, Sk, N, K, h, int(causal), int(window), 1.0 / math.sqrt(h),
            stream)
    if route == "wgmma":
        return _entry(route)(*args)
    return _entry(route)(DTYPE_CODES[q.dtype], *args)
