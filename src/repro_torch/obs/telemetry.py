"""Algorithm telemetry: realized staleness + update-magnitude series.

The port of `repro.obs.telemetry`. The paper's convergence guarantee is
parameterized by the delay bound τ, but what convergence actually
responds to is the REALIZED staleness of each read (Lian et al.,
1506.08272): a row configured at τ=7 whose uniform schedule mostly drew
d_m <= 2 behaves like a much smaller τ. An opt-in ``SweepSpec.telemetry``
flag surfaces that per row, WITHOUT touching the engines:

  * The engines draw every delay d_m from a key chain that is a pure
    function of the row's seed — per epoch ``key, sub = split(key)``,
    then ``k_idx, k_delay, k_scan = split(sub, 3)`` and ``delays =
    _delay_schedule_core(delay_id, total, τ, k_delay)`` (the batched
    engines' `core.asysvrg._delay_chunks`; the fused kernel draws the
    same delays in-kernel, bit for bit). `repro_torch.prng` reproduces
    `jax.random` bit for bit, so replaying that chain HERE, on the CPU,
    gives the exact delays the run used, integer for integer the JAX
    package's — recomputation, not instrumentation.
  * Update-norm and loss-delta series come from arrays the engine already
    returned (``final_w``, ``histories``).

Nothing is added to, reordered in, or read out of a group runner, so
results with the flag on equal those with it off bit for bit.

Computed only for rows that set the flag (a host-side replay costs
O(epochs · M̃) work per row); un-flagged rows carry zeros and
``rows[c] == False``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.asysvrg import _delay_schedule_core


class SweepTelemetry(NamedTuple):
    """Row-aligned telemetry series (all [C] or [C, max_epochs]).

    ``rows`` marks which rows were computed (``SweepSpec.telemetry``);
    every series is zero where ``rows`` is False. Staleness entries are
    the realized delays d_m the row's reads executed with; per-epoch
    entries past a row's own budget are zero (the row was frozen)."""
    rows: np.ndarray                 # [C] bool: telemetry computed?
    staleness_mean: np.ndarray       # [C] mean d_m over the row's run
    staleness_var: np.ndarray        # [C] variance of d_m
    staleness_max: np.ndarray        # [C] max realized d_m (<= τ always)
    staleness_per_epoch: np.ndarray  # [C, max_epochs] per-epoch mean d_m
    update_norm: np.ndarray          # [C] ||w_final - w0||_2
    loss_delta: np.ndarray           # [C, max_epochs] loss[e+1] - loss[e]
    loss_delta_var: np.ndarray       # [C] variance of live loss deltas


def realized_delays(seed: int, delay_id: int, tau: int, total: int,
                    epochs: int) -> np.ndarray:
    """[epochs, total] int32 — the exact delay schedule the run drew,
    replayed on the CPU from ``PRNGKey(seed)`` along the engines' key
    chain (`core.asysvrg._masked_epochs`, `_delay_chunks`)."""
    key = prng.PRNGKey(seed)[None]
    out = np.empty((epochs, total), np.int32)
    for e in range(epochs):
        halves = prng.split(key, 2)
        key, sub = halves[:, 0], halves[:, 1]
        k_delay = prng.split(sub, 3)[:, 1]
        out[e] = _delay_schedule_core(torch.tensor([delay_id]), total,
                                      torch.tensor([tau]), k_delay)[0].numpy()
    return out


def compute(specs: Sequence, resolved: Sequence, histories: np.ndarray,
            final_w: np.ndarray, w_init) -> Optional["SweepTelemetry"]:
    """Telemetry for every flagged row of one assembled result (None when
    no row set the flag). ``specs``/``resolved`` are the row-aligned
    normalized specs and `_Resolved` entries; ``histories`` has the
    result's [C, max_epochs+1] width; ``w_init`` is the flat start
    iterate every row shares (a tensor on any device, or an array)."""
    flags = np.asarray([bool(getattr(s, "telemetry", False))
                        for s in specs])
    if not flags.any():
        return None
    C, width = histories.shape
    max_epochs = width - 1
    if isinstance(w_init, torch.Tensor):
        w_init = w_init.detach().cpu().numpy()
    w0 = np.asarray(w_init, np.float64)

    stale_mean = np.zeros(C, np.float64)
    stale_var = np.zeros(C, np.float64)
    stale_max = np.zeros(C, np.int64)
    stale_epoch = np.zeros((C, max_epochs), np.float64)
    update_norm = np.zeros(C, np.float64)
    loss_delta = np.zeros((C, max_epochs), np.float64)
    loss_delta_var = np.zeros(C, np.float64)

    hist64 = np.asarray(histories, np.float64)
    for c in np.flatnonzero(flags):
        r = resolved[c]
        epochs = min(int(r.epochs), max_epochs)
        delays = realized_delays(specs[c].seed, r.delay_id, r.tau,
                                 r.total, epochs)
        flat = delays.reshape(-1).astype(np.float64)
        stale_mean[c] = flat.mean() if flat.size else 0.0
        stale_var[c] = flat.var() if flat.size else 0.0
        stale_max[c] = int(delays.max()) if delays.size else 0
        stale_epoch[c, :epochs] = delays.mean(axis=1)
        update_norm[c] = float(np.linalg.norm(
            np.asarray(final_w[c], np.float64) - w0))
        deltas = hist64[c, 1:epochs + 1] - hist64[c, :epochs]
        loss_delta[c, :epochs] = deltas
        loss_delta_var[c] = deltas.var() if deltas.size else 0.0

    return SweepTelemetry(rows=flags, staleness_mean=stale_mean,
                          staleness_var=stale_var, staleness_max=stale_max,
                          staleness_per_epoch=stale_epoch,
                          update_norm=update_norm, loss_delta=loss_delta,
                          loss_delta_var=loss_delta_var)


def to_dict(tel: "SweepTelemetry") -> dict:
    """JSON-safe wire form (nested lists of Python scalars — exact, like
    the rest of the result payload)."""
    return {name: np.asarray(getattr(tel, name)).tolist()
            for name in SweepTelemetry._fields}


_DTYPES = {"rows": np.bool_, "staleness_max": np.int64}


def from_dict(payload: dict) -> "SweepTelemetry":
    return SweepTelemetry(**{
        name: np.asarray(payload[name], _DTYPES.get(name, np.float64))
        for name in SweepTelemetry._fields})
