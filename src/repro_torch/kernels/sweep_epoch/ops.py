"""Public sweep-epoch op: device dispatch, input checks, placement by size
and launch counts.

`sweep_epoch` runs one epoch's inner loop for the C rows of a group and
the loss at each row's new iterate: the plain version
(`ref.sweep_epoch_ref`) for CPU tensors, the CUDA kernel
(`csrc/sweep_epoch.cu`, one launch for every row) for CUDA tensors. A
producer warp in each row's block draws the steps ahead of the row's
update chain and brings each sampled row of X either into shared-memory
stages by bulk copy or into L2 by prefetch. Where the ring buffer and the
rows live is the launch's placement, the first of `PLACEMENTS` whose
block fits the card's shared memory (`shared_bytes`), unless the caller
names one (for holding each against the plain version, and for timing):

* ``"shared"``: the ring and the row stages in shared memory;
* ``"global"``: the ring in a [C, buf_len, d] device buffer, the stages in
  shared memory;
* ``"global_l2"``: the ring in device memory, the rows prefetched into L2.

Every launch counts in ``sweep_epoch.launches`` and, by placement, in
``sweep_epoch.placements``. The loss runs in the same launch call, over
all of the card's SMs.

`run_sweep`'s fused group body (`core.sweep._fused_group_fn`) takes it
per epoch of a `LogisticRegression` or `NonconvexLogistic` group, after
one ``logreg_grad`` launch for the rows' snapshot gradients μ (AsySVRG
groups); the launch also gives the epoch's losses. An `MLPObjective`
group runs on the MLP's own kernel instead, ``sweep_epoch_mlp``
(`repro_torch.kernels.sweep_epoch_mlp`, ``csrc/sweep_epoch_mlp.cu``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import dispatch, regularizer
from repro_torch.kernels.sweep_epoch import kernel
from repro_torch.kernels.sweep_epoch.ref import check_rows, sweep_epoch_ref

SHARED, GLOBAL, GLOBAL_L2 = "shared", "global", "global_l2"
PLACEMENTS = (SHARED, GLOBAL, GLOBAL_L2)  # in order of preference
# Queue depth S, the steps drawn (and rows staged) ahead: `kStages` of
# csrc/sweep_epoch.cu, mirrored here for the size of a block.
STAGES = 2
# placement -> (the ring in shared memory, the rows staged in shared memory)
_LAYOUT = {SHARED: (True, True), GLOBAL: (False, True),
           GLOBAL_L2: (False, False)}
_SCRATCH_BYTES = 512  # the two float64 sums of 16 warps, double-buffered
_STEP_BYTES = 64      # per stage: full and empty mbarriers, one queue entry


def shared_bytes(d: int, buf_len: int, engine: str, placement: str) -> int:
    """Dynamic shared memory of one block (one row): the reduction scratch,
    `STAGES` queue entries with their mbarriers, with the rows staged
    `STAGES` spans of 16·⌈d/4⌉ + 16 bytes (a row's 16-byte-aligned
    cover), then 4·d bytes for each of u0, μ, acc (AsySVRG) and the read
    iterate, and the ring's 4·d·buf_len where it lives in shared memory;
    the layout of ``csrc/sweep_epoch.cu``, which refuses a launch whose
    bytes differ."""
    if engine not in kernel.ENGINE_CODES or placement not in _LAYOUT:
        raise ValueError(f"sweep_epoch: unknown engine {engine!r} or "
                         f"placement {placement!r}")
    ring_shared, staged = _LAYOUT[placement]
    vectors = (4 if engine == "asysvrg" else 1) + (buf_len if ring_shared else 0)
    stage = -(-4 * d // 16) * 16 + 16 if staged else 0
    return (_SCRATCH_BYTES + STAGES * (_STEP_BYTES + stage)
            + vectors * 4 * d)


def choose_placement(d: int, buf_len: int, engine: str, limit: int) -> str:
    """The first of `PLACEMENTS` whose block fits ``limit`` bytes of
    dynamic shared memory."""
    for placement in PLACEMENTS:
        if shared_bytes(d, buf_len, engine, placement) <= limit:
            return placement
    raise ValueError(f"sweep_epoch: d = {d} needs more shared memory than a "
                     f"block has ({limit} bytes)")


def sweep_epoch(X, y, reg, w, mu, keys, step, tau: Sequence[int],
                scheme_id: Sequence[int], delay_id: Sequence[int], *,
                engine: str, total: int, buf_len: int, option: int,
                drop_prob: float, placement: str | None = None):
    """One epoch of ``total`` inner updates for each row of ``w``.

    ``reg`` names the penalty of the objective: a float λ for L2, ``(lam,
    alpha)`` for the clipped one (`repro_torch.kernels.regularizer`).
    ``X`` [n, d], ``y`` [n], ``w`` [C, d] and ``mu`` [C, d] (None for
    ``engine="hogwild"``) float32; ``keys`` [C, 2] int64 epoch keys;
    ``step`` [C] float32 (η, or Hogwild!'s current γ); ``tau``,
    ``scheme_id``, ``delay_id``: one host int per row. Returns the rows'
    new iterates [C, d] (the last iterate, or for AsySVRG with option 2 the
    average of the epoch's iterates) and the loss f at each [C].
    ``placement`` names one of `PLACEMENTS` for a CUDA launch instead of
    the first that fits; the kernel refuses one whose block does not fit.
    """
    C = w.shape[0]
    reg = regularizer.regularizer(reg)
    check_rows(C, tau, scheme_id, delay_id, engine=engine, total=total,
               buf_len=buf_len, option=option, drop_prob=drop_prob)
    if placement is not None and placement not in _LAYOUT:
        raise ValueError(f"sweep_epoch: unknown placement {placement!r}")
    svrg = engine == "asysvrg"
    mu = mu if svrg else None
    tensors = (X, y, w, keys, step) + ((mu,) if svrg else ())
    if dispatch.route(*tensors) == dispatch.REFERENCE:
        return sweep_epoch_ref(X, y, reg, w, mu, keys, step, tau, scheme_id,
                               delay_id, engine=engine, total=total,
                               buf_len=buf_len, option=option,
                               drop_prob=drop_prob)
    if X.dim() != 2 or w.dim() != 2:
        raise ValueError(f"sweep_epoch: X {tuple(X.shape)} and w "
                         f"{tuple(w.shape)} must both be 2-D")
    n, d = X.shape
    if (y.shape != (n,) or w.shape[1] != d or keys.shape != (C, 2)
            or step.shape != (C,) or (svrg and mu.shape != w.shape)):
        raise ValueError(f"sweep_epoch: y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}, keys {tuple(keys.shape)}, step "
                         f"{tuple(step.shape)} do not fit X {tuple(X.shape)}")
    if n >= 2**31 or C < 1:
        raise ValueError(f"sweep_epoch: n = {n}, C = {C} out of range")
    floats = (X, y, w, step) + ((mu,) if svrg else ())
    if any(t.dtype != torch.float32 for t in floats) or keys.dtype != torch.int64:
        raise TypeError("sweep_epoch: X, y, w, mu and step must be float32, "
                        "keys int64")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sweep_epoch: inputs must be contiguous")
    limit = kernel.max_shared_bytes(X.device)
    if limit < 0:
        raise RuntimeError(f"sweep_epoch: cannot read the shared memory "
                           f"limit of {X.device}")
    where = placement or choose_placement(d, buf_len, engine, limit)
    ring_shared, staged = _LAYOUT[where]
    row_ints = torch.tensor([list(tau), list(scheme_id), list(delay_id)],
                            dtype=torch.int32, device=X.device)
    ring = (None if ring_shared else
            torch.empty((C, buf_len, d), dtype=torch.float32, device=X.device))
    out = torch.empty((C, d), dtype=torch.float32, device=X.device)
    terms = torch.empty((C, n), dtype=torch.float64, device=X.device)
    loss = torch.empty(C, dtype=torch.float32, device=X.device)
    rc = kernel.launch(X, y, w, mu, keys, step, row_ints, ring, out, terms,
                       loss, engine=engine, total=total, buf_len=buf_len,
                       option=option, drop=drop_prob > 0, staged=staged,
                       smem_bytes=shared_bytes(d, buf_len, engine, where),
                       reg=reg,
                       keep_p=float(np.float32(1.0 - drop_prob)))
    if rc != 0:
        raise RuntimeError(f"sweep_epoch kernel launch failed ({where}): "
                           f"CUDA error {rc}")
    sweep_epoch.launches += 1
    sweep_epoch.placements[where] += 1
    return out, loss


sweep_epoch.launches = 0
sweep_epoch.placements = dict.fromkeys(PLACEMENTS, 0)


def kernel_draws(key, n: int, d: int, tau: int, delay_id: int, steps: int):
    """The kernel's own draws for one CUDA key [2] over its first ``steps``
    steps, as `ref.draws` returns them: sample index and read age [steps]
    (int64), reader and drop uniforms [steps, d] (float32). For checking
    the in-kernel generator against `repro_torch.prng`; not counted."""
    if key.device.type != "cuda" or key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError("kernel_draws: key must be one int64 [2] CUDA key")
    ints = dict(dtype=torch.int32, device=key.device)
    idx, age = torch.empty(steps, **ints), torch.empty(steps, **ints)
    read_u, drop_u = (torch.empty((steps, d), dtype=torch.float32,
                                  device=key.device) for _ in range(2))
    rc = kernel.draws(key.contiguous(), n, d, tau, delay_id, steps, idx, age,
                      read_u, drop_u)
    if rc != 0:
        raise RuntimeError(f"sweep_epoch draws launch failed: CUDA error {rc}")
    return idx.long(), age.long(), read_u, drop_u
