"""Hogwild! (Recht et al. 2011) — the paper's baseline, same delay engine.

The port of `repro.core.hogwild`. Plain asynchronous SGD: v_m =
∇f_{i_m}(û_m) with NO control variate, run under the same bounded-delay
read semantics as AsySVRG so the comparison isolates the paper's
contribution. Settings follow the paper §5.1: each epoch runs n/p
iterations per thread (1 effective pass), constant step γ decayed by 0.9
per epoch.

The engine shares AsySVRG's random streams and readers
(`asysvrg._delay_chunks`) and its per-row epoch masking, and runs C rows
at once. The update keeps its own plain form, u − γ·v, not the
``svrg_update`` kernel.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.asysvrg import (
    AsyRunResult,
    DELAY_IDS,
    SCHEME_IDS,
    _check_kinds,
    _delay_chunks,
    _gather_read,
    _masked_epochs,
)
from repro_torch.core.objective import Objective


def _resolve_hogwild_steps(n: int, num_threads: int, tau: int):
    """(p, total = (n // p)·p, clamped τ) — the ONE place this arithmetic
    lives; `run_hogwild`'s update bookkeeping and the sweep engine both
    derive from it, so the two can never drift."""
    p_threads = max(1, num_threads)
    total = max(1, n // p_threads) * p_threads          # n/p per thread
    tau = (p_threads - 1) if tau < 0 else tau
    tau = max(0, min(tau, total - 1))
    return p_threads, total, tau


def _hogwild_epoch_core(obj: Objective, data, w, key, gamma, tau, scheme_id,
                        delay_id, *, total: int, buf_len: int,
                        drop_prob: float):
    """One Hogwild! epoch (total async updates) for C rows: ``w`` [C, d],
    ``key`` [C, 2], ``gamma`` [C] float32; ``tau``/``scheme_id``/
    ``delay_id`` per row (host ints)."""
    C, dim = w.shape
    rows = torch.arange(C, device=w.device)
    buffer = w[:, None, :].repeat(1, buf_len, 1)        # slot m%(τ+1) = u_m
    step = gamma[:, None]
    u = w
    for idx, slots, keep, wslot in _delay_chunks(
            key, obj.num_samples(data), tau, scheme_id, delay_id,
            total=total, dim=dim, drop_prob=drop_prob):
        for j in range(idx.shape[0]):
            v = obj.flat_sample_grad(data, idx[j], _gather_read(buffer, slots[j]))
            if keep is not None:
                v = v * keep[j]
            u = u - step * v
            buffer[rows, wslot[j]] = u
    return u


def _hogwild_epochs_core(obj: Objective, data, w0, key, gamma0, decay, tau,
                         scheme_id, delay_id, *, epochs: int, total: int,
                         buf_len: int, drop_prob: float, row_epochs=None):
    """``epochs`` Hogwild! epochs for C rows, γ ← decay·γ after each live
    epoch: returns (w_fin [C, d], losses [C, epochs+1]). Frozen rows keep
    their iterate, γ and last loss (`asysvrg._masked_epochs`)."""
    gamma = gamma0.clone()

    def epoch(live, w, sub):
        sel = torch.tensor(live, device=w.device)
        w_new = _hogwild_epoch_core(
            obj, data, w, sub, gamma[sel], [tau[c] for c in live],
            [scheme_id[c] for c in live], [delay_id[c] for c in live],
            total=total, buf_len=buf_len, drop_prob=drop_prob)
        gamma[sel] = gamma[sel] * decay[sel]
        return w_new, obj.flat_loss(data, w_new)

    return _masked_epochs(obj, data, w0, key, epochs=epochs,
                          row_epochs=row_epochs, epoch=epoch)


def hogwild_epoch(obj: Objective, w, key, step_size: float,
                  num_threads: int, tau: int = -1, scheme: str = "unlock",
                  drop_prob: float = 0.02, delay_kind: str = "fixed"):
    """One Hogwild! epoch for one configuration: flat ``w`` [d] and key [2]
    → the epoch's last iterate [d], on the objective's device."""
    _check_kinds(scheme, delay_kind)
    w = obj.as_flat(w)
    _, total, tau = _resolve_hogwild_steps(obj.n, num_threads, tau)
    delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[delay_kind]
    gamma = torch.full((1,), step_size, dtype=torch.float32, device=w.device)
    return _hogwild_epoch_core(
        obj, obj.data_args(), w[None], key.to(w.device)[None], gamma, [tau],
        [SCHEME_IDS[scheme]], [delay_id], total=total, buf_len=tau + 1,
        drop_prob=drop_prob)[0]


def run_hogwild(obj: Objective, epochs: int, step_size: float,
                num_threads: int = 8, decay: float = 0.9,
                scheme: str = "unlock", tau: int = -1, seed: int = 0,
                w0=None, delay_kind: str = "fixed",
                drop_prob: float = 0.02) -> AsyRunResult:
    """Multi-epoch driver for one configuration, on the objective's device;
    `total_updates` derives from the same ``total = (n // p)·p`` the epoch
    scans over."""
    _check_kinds(scheme, delay_kind)
    w = obj.init_flat() if w0 is None else obj.as_flat(w0)
    _, total, tau = _resolve_hogwild_steps(obj.n, num_threads, tau)
    delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[delay_kind]
    f32 = dict(dtype=torch.float32, device=w.device)
    w_fin, losses = _hogwild_epochs_core(
        obj, obj.data_args(), w[None], prng.PRNGKey(seed, w.device)[None],
        torch.full((1,), step_size, **f32), torch.full((1,), decay, **f32),
        [tau], [SCHEME_IDS[scheme]], [delay_id], epochs=epochs, total=total,
        buf_len=tau + 1, drop_prob=drop_prob)
    return AsyRunResult(
        w=w_fin[0],
        history=tuple(losses[0].tolist()),
        effective_passes=tuple(float(e) for e in range(epochs + 1)),
        total_updates=epochs * total)
