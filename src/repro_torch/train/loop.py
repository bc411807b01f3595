"""Host-side training loop: SVRG snapshot scheduling, checkpoint/restart,
metrics; the port of the JAX package's ``train/loop.py``.

Fault tolerance:
  * auto-resume: if checkpoint_dir holds a valid step, training continues
    from it (the data pipeline is counter-based, so the step number IS the
    cursor).
  * step-atomic async checkpoints every checkpoint_every steps.
  * SVRG epoch barrier: a failure between snapshot passes re-runs the
    snapshot from the restored step (idempotent).

The loop reads device values back to the host only on its log steps.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.config import TrainConfig
from repro_torch.models.factory import ModelBundle
from repro_torch.train.state import (
    TrainState, init_train_state, make_snapshot_fns, make_train_step)
from repro_torch.utils.misc import log
from repro_torch.utils.tree import tree_map


def device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {key: torch.as_tensor(x).to(device) for key, x in batch.items()}


def train(bundle: ModelBundle, tcfg: TrainConfig,
          batch_at: Callable[[int], Any],
          snapshot_batch_at: Optional[Callable[[int], Any]] = None,
          hooks: Optional[Callable[[int, Dict], None]] = None) -> TrainState:
    """Run tcfg.steps training steps on the bundle's device. ``batch_at(step)``
    supplies data (counter-based — restart-safe), numpy or tensors. The
    params are drawn from a generator on that device seeded with
    ``tcfg.seed``. ``hooks(step, metrics)`` runs on each log step with the
    metrics as floats."""
    is_svrg = tcfg.optimizer == "svrg"
    snapshot_batch_at = snapshot_batch_at or batch_at
    device = bundle.device

    step_fn = make_train_step(bundle, tcfg)
    if is_svrg:
        begin_fn, accum_fn, finalize_fn = make_snapshot_fns(bundle, tcfg)

    ckpt = Checkpointer(tcfg.checkpoint_dir, tcfg.keep_checkpoints)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    state = init_train_state(gen, bundle, tcfg)
    start_step = 0
    if tcfg.checkpoint_dir and ckpt.list_steps():
        state, start_step = ckpt.restore(state)
        log(f"resumed from checkpoint step {start_step}")

    def refresh_snapshot(state: TrainState, step: int) -> TrainState:
        state = begin_fn(state)
        for j in range(tcfg.svrg.snapshot_batches):
            state = accum_fn(state, device_batch(
                snapshot_batch_at(step * 131 + j), device))
        state = finalize_fn(state)
        # finalize sets w_snap = params: keep a distinct copy, as the JAX
        # package does
        w_snap = tree_map(torch.clone, state.svrg.w_snap)
        return state._replace(svrg=state.svrg._replace(w_snap=w_snap))

    t0 = time.perf_counter()
    try:
        for step in range(start_step, tcfg.steps):
            if is_svrg and step % tcfg.svrg.snapshot_every == 0:
                state = refresh_snapshot(state, step)
            state, metrics = step_fn(state, device_batch(batch_at(step),
                                                         device))
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                log(f"step {step}: loss={m['loss']:.4f} "
                    f"|v|={m['v_norm']:.3f} lr={m['lr']:.2e} ({dt:.1f}s)")
                if hooks:
                    hooks(step, m)
            if tcfg.checkpoint_dir and (step + 1) % tcfg.checkpoint_every == 0:
                ckpt.save(state, step + 1, blocking=False)
    finally:
        ckpt.wait()          # no writer thread outlives the loop
    if tcfg.checkpoint_dir:
        ckpt.save(state, tcfg.steps, blocking=True)
    return state
