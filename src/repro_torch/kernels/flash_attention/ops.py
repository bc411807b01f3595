"""Public flash-attention wrapper in the model layout: device dispatch,
route choice, input checks, launch counts.

`gqa_flash` takes q ``[B, Sq, N, h]`` and k, v ``[B, Sk, K, h]`` with N a
multiple of K. Query i and key j sit at positions i and j. A key length
of its own (``Sk != Sq``) is for non-causal attention without a window
(an encoder over its valid frames, a cross-attention over an encoder's
or an image's tokens); causal or windowed attention takes ``Sk == Sq``.
A caller masks padded keys at the end of a buffer by passing the view
``k[:, :S_valid]``: the kernels read the view's rows and no others. For
CPU tensors it repeats the kv heads and runs the plain
version (`ref.attention_ref`), as the JAX package's wrapper does. For CUDA
tensors it launches one of two kernels, which read the model layout through
strides (no repeat, no transpose), chosen by dtype and head width alone
(`route`):

  * ``"wgmma"``: bf16 with h a multiple of 16 up to 256
    (``csrc/flash_attention_wgmma.cu``, tensor cores, TMA pipeline);
  * ``"simt"``: float32 (TF32 on the tensor cores would miss the float32
    limit of 2e-5), and bf16 with h a multiple of 8 but not of 16
    (``csrc/flash_attention.cu``, CUDA cores).

This is dispatch on dtype and shape, not a fallback: a failed build or
launch of either kernel raises, and no route is tried after another.
The kernels have no backward (nor has the JAX package's), and their output
is a tensor autograd does not see: on CUDA tensors under grad that need a
gradient, `gqa_flash` raises rather than return attention through which no
gradient would flow. Training attends through `models.layers.attention`.
Launches count in ``gqa_flash.launches`` and, per route, in
``gqa_flash.launches_by_route``.

Fake tensors (``torch._subclasses.fake_tensor``, the dry-run's) take the
custom op ``torch.ops.repro_torch.flash_attention``, whose fake
implementation makes the output's shape, dtype and device and nothing
else: no launch (none counted), no pointer read, and never the plain
attention, whose ``[B, N, Sq, Sk]`` scores the kernel never holds. Its
FLOPs, 4·B·N·h per unmasked (query, key) pair, are registered with
``torch.utils.flop_counter``. A `DTensor` of fake shards (the dry-run
over a fake world) runs that op on rank 0's shards: its keys and values
gathered over any sequence sharding first, and only the kv heads its
query heads read.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils import flop_counter

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256
ROUTES = ("wgmma", "simt")


def route(dtype: torch.dtype, h: int) -> str:
    """The kernel a CUDA call with inputs of ``dtype`` and head width ``h``
    launches: ``"wgmma"`` for bf16 with h a multiple of 16, else
    ``"simt"``. (What neither kernel takes is rejected by the wrapper's
    checks.)"""
    return "wgmma" if dtype == torch.bfloat16 and h % 16 == 0 else "simt"


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on what the CUDA kernels do not take."""
    h = q.shape[-1]
    if q.dtype not in kernel.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gqa_flash: no kernel for dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if h % 8 or not 0 < h <= MAX_HEAD_DIM:
        raise ValueError(f"gqa_flash: head width {h} is not a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    vec = 16 // q.element_size()      # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"gqa_flash: {name} strides {t.stride()} do not "
                             "give 16-byte aligned rows of contiguous heads")


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: under the causal mask and
    ``window`` (0 = global) with Sk = Sq; not causal, every pair."""
    if not causal:
        return Sq * Sk
    if window <= 0 or window >= Sq:
        return Sq * (Sq + 1) // 2
    return window * (window + 1) // 2 + (Sq - window) * window


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """The flash-attention kernel as a torch op; called on fake tensors
    (the dry-run), where only `_fake_flash` runs."""
    return _run(q, k, v, causal, window)


@flash_attention_op.register_fake
def _fake_flash(q, k, v, causal, window):
    return q.new_empty(q.shape)


def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 out_shape=None, **kwargs) -> int:
    B, Sq, N, h = q_shape
    return 4 * B * N * h * attention_pairs(Sq, k_shape[1], causal, window)


if torch.ops.repro_torch.flash_attention not in flop_counter.flop_registry:
    flop_counter.register_flop_formula(
        torch.ops.repro_torch.flash_attention)(_flash_flops)


def _sharded_flash(q, k, v, causal: bool, window: int):
    """The dry-run's attention over `DTensor`s of fake shards: rank 0's
    query shard against the keys and values it reads, through the fake op;
    the output placed as q. On each mesh dim k and v follow q's batch or
    head sharding and are gathered otherwise (a sequence-sharded k or v is
    all-gathered: every query reads every key)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not is_fake(q.to_local()):
        raise RuntimeError("gqa_flash: sharded attention is the dry-run's, "
                           "on fake tensors only")
    placements = [qp if qp == Shard(0) or (qp == Shard(2) and kp == Shard(2))
                  else Replicate()
                  for qp, kp in zip(q.placements, k.placements)]
    mesh = q.device_mesh
    ql = q.to_local()
    G = q.shape[2] // k.shape[2]
    needed = -(-ql.shape[2] // G)      # kv heads rank 0's query heads read
    kl, vl = (t.redistribute(mesh, placements).to_local()[:, :, :needed]
              for t in (k, v))
    out = flash_attention_op(ql, kl, vl, causal, int(window))
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def gqa_flash(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,N,h], k/v [B,Sk,K,h] -> [B,Sq,N,h] in q's dtype."""
    B, Sq, N, h = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, h) or v.shape != k.shape or N % K:
        raise ValueError(f"gqa_flash: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected k = v = [B, Sk, K, h] "
                         "with K dividing N")
    if Sk != Sq and (causal or window):
        raise ValueError(f"gqa_flash: {Sq} queries over {Sk} keys is for "
                         "non-causal attention without a window; causal or "
                         "windowed attention takes as many keys as queries")
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _sharded_flash(q, k, v, causal, window)
    if is_fake(q):
        return flash_attention_op(q, k, v, causal, int(window))
    return _run(q, k, v, causal, window)


def _run(q, k, v, causal: bool, window: int):
    """`gqa_flash` on real tensors: the plain version on the CPU, the
    kernel on the card."""
    B, Sq, N, h = q.shape
    K = k.shape[2]
    if dispatch.route(q, k, v) == dispatch.REFERENCE:
        G = N // K
        qt = q.transpose(1, 2)                              # [B,N,S,h]
        kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
        out = attention_ref(qt, kt, vt, causal=causal, window=window)
        return out.transpose(1, 2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "gqa_flash: the flash-attention kernel has no backward: it runs "
            "outside autograd, so q, k and v would get no gradient. Attend "
            "through models.layers.attention where a gradient is needed, or "
            "call this under torch.no_grad()")
    _check_kernel_inputs(q, k, v)
    chosen = route(q.dtype, h)
    out = torch.empty((B, Sq, N, h), dtype=q.dtype, device=q.device)
    rc = kernel.launch(q, k, v, out, causal=causal, window=int(window),
                       route=chosen)
    if rc != 0:
        raise RuntimeError(f"flash_attention {chosen} kernel launch failed: "
                           f"CUDA error {rc}")
    gqa_flash.launches += 1
    gqa_flash.launches_by_route[chosen] += 1
    return out


gqa_flash.launches = 0
gqa_flash.launches_by_route = dict.fromkeys(ROUTES, 0)
