"""Public ops of the MLP objective's sweep kernel: device dispatch, input
checks, placement by size and launch counts.

`sweep_epoch_mlp` runs one epoch's inner loop for the C rows of a group of
`repro_torch.core.objectives.MLPObjective` and the loss at each row's new
iterate: the plain version (`ref.sweep_epoch_mlp_ref`) for CPU tensors, the
CUDA kernel (``csrc/sweep_epoch_mlp.cu``, one launch for every row) for
CUDA tensors. `mlp_full_grad` gives the rows' snapshot gradients μ and
their loss, `mlp_loss` the loss alone; both are entries of the same source.
`sample_grad` exposes one sample's gradient of one row, for holding the
in-kernel backward against the objective's apart from the draws.

Where the read iterate, the ring buffer, u0, μ and acc live is the epoch
launch's placement, the first of `PLACEMENTS` whose block fits the card's
shared memory (`shared_bytes`), as `kernels.sweep_epoch.ops.
choose_placement` picks K3's, unless the caller names one:

* ``"shared"``: all of them, the producer's two stages of
  per-coordinate words and the transposed copies of w1 and w2 that the
  backward reads (`row_bytes`), in shared memory beside the activations;
* ``"global"``: all of them in a device buffer of `row_bytes` a row.

The block's warps: each gradient set (two for AsySVRG, one for Hogwild!)
has `position_warps` warps, one per position of the sample, and the epoch
block adds the producer warpgroup (`epoch_threads`); a full-gradient or
loss block runs `full_layout`'s sets samples at once, each a set
(`full_threads`), with the row in shared memory where it fits.
These rules and the bytes are the layout of ``csrc/sweep_epoch_mlp.cu``,
which refuses a launch whose bytes or threads differ.

A width whose activations alone exceed a block's shared memory is refused,
with its bytes named; there is no fallback. Every counted launch (epoch,
full gradient, loss) adds one to ``sweep_epoch_mlp.launches`` and to its
entry in ``sweep_epoch_mlp.launches_by_entry``; epoch launches count by
placement in ``sweep_epoch_mlp.placements``. `sample_grad` is not counted.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.sweep_epoch.ref import check_rows
from repro_torch.kernels.sweep_epoch_mlp import kernel
from repro_torch.kernels.sweep_epoch_mlp.ref import (
    ACTIVATIONS,
    MLPWidths,
    full_grad_ref,
    loss_ref,
    sample_grad_ref,
    sweep_epoch_mlp_ref,
)

SHARED, GLOBAL = "shared", "global"
PLACEMENTS = (SHARED, GLOBAL)   # in order of preference
ENTRIES = ("epoch", "full_grad", "loss")
STAGES = 2                      # the producer's queue depth
POSITION_WARPS = 8              # most warps of one gradient set
PRODUCER_WARPS = 4              # the epoch block's producer warpgroup
FULL_WARPS = 16                 # most warps of a full-gradient or loss block
_STAGE_BASE = 48                # a stage's two mbarriers and step header


def position_warps(S: int) -> int:
    """Warps of one gradient set: one per position, at most 8; positions
    cycle over them where S is larger."""
    return min(S, POSITION_WARPS)


def epoch_threads(S: int, engine: str) -> int:
    """Threads of one epoch block: the sets' position warps, then the
    producer warpgroup."""
    sets = 2 if engine == "asysvrg" else 1
    return 32 * (sets * position_warps(S) + PRODUCER_WARPS)


def _acts_bytes(S: int, widths: MLPWidths) -> int:
    """One activation set: float64 [S, D] ×4, [S, H] ×2, [S, V]."""
    V, D, H = widths.vocab_size, widths.d_model, widths.d_hidden
    return 8 * S * (4 * D + 2 * H + V)


def _queue_bytes(S: int) -> int:
    """The producer's stages: two mbarriers, the step header and the
    sample's tokens and targets each."""
    return -(-(STAGES * (_STAGE_BASE + 8 * S)) // 16) * 16


def _trans_floats(widths: MLPWidths) -> int:
    """One iterate's transposed copies of w2 and w1, rows of odd length:
    [V, H | 1] and [H, D | 1]."""
    V, D, H = widths.vocab_size, widths.d_model, widths.d_hidden
    return V * (H | 1) + H * (D | 1)


def row_bytes(widths: MLPWidths, buf_len: int, engine: str) -> int:
    """Bytes of one row's state beside its activations: the iterates the
    passes read widened to float64 with their transposed copies (u_read,
    and u0 for AsySVRG), then float32 the buf_len ring slots, μ and acc
    (AsySVRG) and the two stages of per-coordinate words; to 16 bytes. In
    shared memory under ``"shared"``, the device buffer's row under
    ``"global"``."""
    svrg = engine == "asysvrg"
    d = widths.flat_dim
    floats = (buf_len + (2 if svrg else 0) + STAGES) * d
    doubles = (2 if svrg else 1) * (d + _trans_floats(widths))
    return -(-(8 * doubles + 4 * floats) // 16) * 16


def shared_bytes(S: int, widths: MLPWidths, buf_len: int, engine: str,
                 placement: str) -> int:
    """Dynamic shared memory of one epoch block (one row): one activation
    set per gradient (two for AsySVRG), the producer's queue, and with
    ``"shared"`` the row's `row_bytes`."""
    if engine not in kernel.ENGINE_CODES or placement not in PLACEMENTS:
        raise ValueError(f"sweep_epoch_mlp: unknown engine {engine!r} or "
                         f"placement {placement!r}")
    svrg = engine == "asysvrg"
    row = row_bytes(widths, buf_len, engine) if placement == SHARED else 0
    return (2 if svrg else 1) * _acts_bytes(S, widths) + _queue_bytes(S) + row


def _full_bytes(S: int, widths: MLPWidths, sets: int = 1,
                staged: bool = False) -> int:
    """Dynamic shared memory of a full-gradient, loss or sample-gradient
    block of ``sets`` samples, each its activations and its positions'
    float64 losses, and with ``staged`` the row w and its transposed
    copies widened to float64."""
    row = widths.flat_dim + _trans_floats(widths)
    return sets * (_acts_bytes(S, widths) + 8 * S) + (8 * row if staged else 0)


def full_layout(S: int, widths: MLPWidths, n: int,
                limit: int) -> tuple[int, bool]:
    """(sets, staged) of a full-gradient or loss block: the row goes to
    shared memory where it fits beside one set; then as many sets as
    `FULL_WARPS` warps hold, fit in ``limit`` bytes and the n samples fill,
    at least one."""
    staged = _full_bytes(S, widths, 1, True) <= limit
    room = limit - _full_bytes(S, widths, 0, staged)
    sets = max(1, min(FULL_WARPS // position_warps(S),
                      room // _full_bytes(S, widths), n))
    return sets, staged


def full_threads(S: int, sets: int) -> int:
    """Threads of a full-gradient, loss or sample-gradient block."""
    return 32 * sets * position_warps(S)


def choose_placement(S: int, widths: MLPWidths, buf_len: int, engine: str,
                     limit: int) -> str:
    """The first of `PLACEMENTS` whose block fits ``limit`` bytes of
    dynamic shared memory; raises, naming the bytes, where none does."""
    for placement in PLACEMENTS:
        if shared_bytes(S, widths, buf_len, engine, placement) <= limit:
            return placement
    raise ValueError(
        f"sweep_epoch_mlp: S = {S} and widths {tuple(widths)} need "
        f"{shared_bytes(S, widths, buf_len, engine, GLOBAL)} bytes of "
        f"activations per block, more than a block has ({limit} bytes)")


def _check_data(tokens, targets, w, widths: MLPWidths) -> None:
    if widths.activation not in ACTIVATIONS:
        raise ValueError(f"sweep_epoch_mlp: unknown activation "
                         f"{widths.activation!r}")
    if tokens.dim() != 2 or targets.shape != tokens.shape:
        raise ValueError(f"sweep_epoch_mlp: tokens {tuple(tokens.shape)} and "
                         f"targets {tuple(targets.shape)} must be one [n, S]")
    if w.shape[-1] != widths.flat_dim:
        raise ValueError(f"sweep_epoch_mlp: rows of width {w.shape[-1]}, "
                         f"the widths give {widths.flat_dim}")


def _check_cuda(tokens, targets, floats, ints=()) -> None:
    """The kernel's input types, contiguity and sizes."""
    if tokens.dtype != torch.int32 or targets.dtype != torch.int32:
        raise TypeError("sweep_epoch_mlp: tokens and targets must be int32")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("sweep_epoch_mlp: params, mu and step must be float32")
    if any(t.dtype != torch.int64 for t in ints):
        raise TypeError("sweep_epoch_mlp: keys must be int64")
    if not all(t.is_contiguous() for t in (tokens, targets, *floats, *ints)):
        raise ValueError("sweep_epoch_mlp: inputs must be contiguous")
    if tokens.shape[0] >= 2**31 or tokens.shape[1] > 256:
        raise ValueError(f"sweep_epoch_mlp: n = {tokens.shape[0]}, S = "
                         f"{tokens.shape[1]} out of range (S <= 256)")


@functools.lru_cache(maxsize=64)
def _row_ints(tau, scheme_id, delay_id, device):
    """The rows' [3, C] int32 settings on ``device``, made once per settings:
    a group's every epoch launch takes the same, and a copy from host
    memory at each launch would wait for the stream."""
    return torch.tensor([tau, scheme_id, delay_id], dtype=torch.int32,
                        device=device)


def _limit(device) -> int:
    limit = kernel.max_shared_bytes(device)
    if limit < 0:
        raise RuntimeError(f"sweep_epoch_mlp: cannot read the shared memory "
                           f"limit of {device}")
    return limit


def _fit_full(S: int, widths: MLPWidths, device) -> int:
    """The bytes of a one-set block, refused where they do not fit; and
    the card's limit."""
    nbytes = _full_bytes(S, widths)
    limit = _limit(device)
    if nbytes > limit:
        raise ValueError(
            f"sweep_epoch_mlp: S = {S} and widths {tuple(widths)} need "
            f"{nbytes} bytes of activations per block, more than a block "
            f"has ({limit} bytes)")
    return limit


def _dims(tokens, widths: MLPWidths):
    return (tokens.shape[1], widths.vocab_size, widths.d_model,
            widths.d_hidden)


def _count(entry: str) -> None:
    sweep_epoch_mlp.launches += 1
    sweep_epoch_mlp.launches_by_entry[entry] += 1


def sweep_epoch_mlp(tokens, targets, w, mu, keys, step, tau: Sequence[int],
                    scheme_id: Sequence[int], delay_id: Sequence[int], *,
                    widths: MLPWidths, engine: str, total: int, buf_len: int,
                    option: int, drop_prob: float,
                    placement: str | None = None):
    """One epoch of ``total`` inner updates for each row of ``w``.

    ``tokens``/``targets`` [n, S] int32 (the objective's data), ``w`` [C, d]
    and ``mu`` [C, d] (None for ``engine="hogwild"``) float32; ``keys``
    [C, 2] int64 epoch keys; ``step`` [C] float32 (η, or Hogwild!'s current
    γ); ``tau``, ``scheme_id``, ``delay_id``: one host int per row. Returns
    the rows' new iterates [C, d] (the last iterate, or for AsySVRG with
    option 2 the epoch's average) and the loss f at each [C].
    ``placement`` names one of `PLACEMENTS` for a CUDA launch instead of
    the first that fits."""
    C = w.shape[0]
    check_rows(C, tau, scheme_id, delay_id, engine=engine, total=total,
               buf_len=buf_len, option=option, drop_prob=drop_prob)
    widths = MLPWidths(*widths)
    _check_data(tokens, targets, w, widths)
    if placement is not None and placement not in PLACEMENTS:
        raise ValueError(f"sweep_epoch_mlp: unknown placement {placement!r}")
    svrg = engine == "asysvrg"
    mu = mu if svrg else None
    tensors = (tokens, targets, w, keys, step) + ((mu,) if svrg else ())
    if dispatch.route(*tensors) == dispatch.REFERENCE:
        return sweep_epoch_mlp_ref(
            tokens, targets, w, mu, keys, step, tau, scheme_id, delay_id,
            widths=widths, engine=engine, total=total, buf_len=buf_len,
            option=option, drop_prob=drop_prob)
    d = widths.flat_dim
    if (w.dim() != 2 or keys.shape != (C, 2) or step.shape != (C,)
            or (svrg and mu.shape != w.shape)):
        raise ValueError(f"sweep_epoch_mlp: w {tuple(w.shape)}, keys "
                         f"{tuple(keys.shape)}, step {tuple(step.shape)} do "
                         f"not fit {C} rows of width {d}")
    _check_cuda(tokens, targets, (w, step) + ((mu,) if svrg else ()), (keys,))
    S = tokens.shape[1]
    limit = _limit(w.device)
    where = placement or choose_placement(S, widths, buf_len, engine, limit)
    nbytes = shared_bytes(S, widths, buf_len, engine, where)
    if nbytes > limit:
        raise ValueError(f"sweep_epoch_mlp: placement {where!r} needs "
                         f"{nbytes} bytes of shared memory per block, more "
                         f"than a block has ({limit} bytes)")
    row_ints = _row_ints(tuple(tau), tuple(scheme_id), tuple(delay_id),
                         w.device)
    vecs = (None if where == SHARED else
            torch.empty((C, row_bytes(widths, buf_len, engine) // 4),
                        dtype=torch.float32, device=w.device))
    out = torch.empty((C, d), dtype=torch.float32, device=w.device)
    loss = torch.empty(C, dtype=torch.float32, device=w.device)
    rc = kernel.launch(tokens, targets, w, mu, keys, step, row_ints, vecs,
                       out, loss, dims=_dims(tokens, widths),
                       act=ACTIVATIONS.index(widths.activation),
                       engine=engine, total=total, buf_len=buf_len,
                       option=option, drop=drop_prob > 0, smem_bytes=nbytes,
                       threads=epoch_threads(S, engine),
                       keep_p=float(np.float32(1.0 - drop_prob)))
    if rc != 0:
        raise RuntimeError(f"sweep_epoch_mlp kernel launch failed ({where}): "
                           f"CUDA error {rc}")
    _count("epoch")
    sweep_epoch_mlp.placements[where] += 1
    return out, loss


sweep_epoch_mlp.launches = 0
sweep_epoch_mlp.launches_by_entry = dict.fromkeys(ENTRIES, 0)
sweep_epoch_mlp.placements = dict.fromkeys(PLACEMENTS, 0)


def _full(tokens, targets, w, widths: MLPWidths, grad: bool):
    widths = MLPWidths(*widths)
    _check_data(tokens, targets, w, widths)
    if dispatch.route(tokens, targets, w) == dispatch.REFERENCE:
        if grad:
            return full_grad_ref(tokens, targets, w, widths)
        return None, loss_ref(tokens, targets, w, widths)
    if w.dim() != 2:
        raise ValueError(f"sweep_epoch_mlp: w {tuple(w.shape)} must be [C, d]")
    _check_cuda(tokens, targets, (w,))
    n, S = tokens.shape
    sets, staged = full_layout(S, widths, n, _fit_full(S, widths, w.device))
    C, d = w.shape
    acc64 = (torch.empty((C, d), dtype=torch.float64, device=w.device)
             if grad else None)
    mu = torch.empty((C, d), dtype=torch.float32, device=w.device) \
        if grad else None
    loss = torch.empty(C, dtype=torch.float32, device=w.device)
    rc = kernel.full(tokens, targets, w, acc64, mu, loss,
                     dims=_dims(tokens, widths),
                     act=ACTIVATIONS.index(widths.activation), sets=sets,
                     staged=staged,
                     smem_bytes=_full_bytes(S, widths, sets, staged),
                     threads=full_threads(S, sets))
    if rc != 0:
        raise RuntimeError(f"sweep_epoch_mlp full-gradient launch failed: "
                           f"CUDA error {rc}")
    _count("full_grad" if grad else "loss")
    return mu, loss


def mlp_full_grad(tokens, targets, w, widths: MLPWidths):
    """(μ [C, d], f [C]) at the rows of ``w`` [C, d]: μ the mean of the
    samples' float64 gradients in sample order, rounded once."""
    return _full(tokens, targets, w, widths, True)


def mlp_loss(tokens, targets, w, widths: MLPWidths):
    """f [C] at the rows of ``w`` [C, d]."""
    return _full(tokens, targets, w, widths, False)[1]


def sample_grad(tokens, targets, i: int, w, widths: MLPWidths):
    """∇f_i(w) [d] float32 for one row ``w`` [d] and sample ``i``: the
    kernel's backward on a CUDA row, its plain version on a CPU one. Not
    counted."""
    widths = MLPWidths(*widths)
    _check_data(tokens, targets, w, widths)
    if w.dim() != 1 or not 0 <= i < tokens.shape[0]:
        raise ValueError(f"sample_grad: one row [d] and a sample in "
                         f"[0, {tokens.shape[0]}), got {tuple(w.shape)}, {i}")
    if dispatch.route(tokens, targets, w) == dispatch.REFERENCE:
        idx = torch.tensor([i], device=w.device)
        return sample_grad_ref(tokens, targets, idx, w[None], widths)[0]
    _check_cuda(tokens, targets, (w,))
    S = tokens.shape[1]
    staged = full_layout(S, widths, 1, _fit_full(S, widths, w.device))[1]
    g = torch.empty_like(w)
    rc = kernel.sample_grad(tokens, targets, i, w, g,
                            dims=_dims(tokens, widths),
                            act=ACTIVATIONS.index(widths.activation),
                            staged=staged,
                            smem_bytes=_full_bytes(S, widths, 1, staged),
                            threads=full_threads(S, 1))
    if rc != 0:
        raise RuntimeError(f"sample_grad launch failed: CUDA error {rc}")
    return g
