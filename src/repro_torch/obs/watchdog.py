"""Divergence watchdog evaluated at slice/flush boundaries.

The port of `repro.obs.watchdog`, numpy only. A diverging row (NaN/Inf
in its loss history, or a loss-explosion ratio past threshold — the
nonconvex regime of Reddi et al., 1506.06840) is detected **after** a
group dispatch returns, on the host-side numpy histories.  Per-tenant
policy decides what happens:

``record``
    Mark the row in ``SweepResult.diverged_rows``; keep its outputs.
``cancel_row``
    Freeze the row at its last trusted epoch by re-dispatching the
    group once with the row's epoch budget truncated via the existing
    per-row epoch-mask semantics (``_Resolved._replace(epochs=k)`` —
    ``epochs`` is a per-row argument of the group runner, never part of
    its cache key, so the re-dispatch reuses the cached runner and
    builds nothing).  Surviving rows keep their **first**-dispatch
    outputs; only the cancelled rows take the re-dispatched (genuinely
    frozen) history and final iterate.
``cancel_job``
    Raise :class:`JobDiverged` — ``run_job`` propagates it.  Coalesced
    ``flush`` batches mix tenants, so there the policy degrades to
    ``cancel_row`` (one tenant's divergence must not cancel another's
    rows).

The watchdog never runs inside an engine (RL006): detection and the
freeze decision are pure host code on the returned histories.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Watchdog", "JobDiverged", "POLICIES", "first_bad_epoch"]

POLICIES = ("record", "cancel_row", "cancel_job")


class JobDiverged(RuntimeError):
    """Raised under the ``cancel_job`` policy; carries the offenders."""

    def __init__(self, rows: Dict[int, int]):
        self.rows = dict(rows)  # flat row index -> last trusted epoch
        super().__init__(
            "watchdog: job cancelled, diverged rows "
            + ", ".join(f"{r} (last trusted epoch {e})" for r, e in sorted(rows.items()))
        )


def first_bad_epoch(
    history: np.ndarray, epochs: int, explosion_ratio: float
) -> Optional[int]:
    """First epoch ``e >= 1`` whose loss is non-finite or exploded.

    ``history[0]`` is the initial loss (trusted by construction);
    entries past the row's own ``epochs`` budget are frozen re-emits
    and not inspected.  Explosion means ``|loss[e]|`` exceeding
    ``explosion_ratio * max(|loss[0]|, eps)``.
    """
    hist = np.asarray(history, dtype=np.float64)
    limit = min(int(epochs), hist.shape[0] - 1)
    if limit < 1:
        return None
    bound = explosion_ratio * max(abs(float(hist[0])), 1e-12)
    for e in range(1, limit + 1):
        v = float(hist[e])
        if not np.isfinite(v) or abs(v) > bound:
            return e
    return None


@dataclasses.dataclass(frozen=True)
class Watchdog:
    """Divergence policy: a default plus per-tenant overrides."""

    policy: str = "cancel_row"
    explosion_ratio: float = 1e3
    tenant_policies: Optional[Mapping[str, str]] = None

    def __post_init__(self):
        bad = [p for p in (self.policy, *(self.tenant_policies or {}).values())
               if p not in POLICIES]
        if bad:
            raise ValueError(f"unknown watchdog policy {bad[0]!r}; choose from {POLICIES}")
        if self.explosion_ratio <= 0:
            raise ValueError("explosion_ratio must be positive")

    def policy_for(self, tenant: str) -> str:
        if self.tenant_policies:
            return self.tenant_policies.get(tenant, self.policy)
        return self.policy


def enforce_group(
    wd: Watchdog,
    hist: np.ndarray,
    w_fin: np.ndarray,
    *,
    members: Sequence[int],
    resolved: Sequence,
    tenant_of: Callable[[int], str],
    redispatch: Callable[[list], Tuple[np.ndarray, np.ndarray]],
    allow_cancel_job: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Dict[int, int], Dict[int, int]]:
    """Inspect one dispatched group's histories and apply the policy.

    ``members`` maps local history rows to flat spec indices (the port
    dispatches no pad rows, so every row is inspected).  ``redispatch``
    re-runs the group against an amended resolved list — same static
    shape, so the runner cache stays warm.

    Returns ``(hist, w_fin, diverged, overrides)`` where ``diverged``
    maps flat row -> last trusted epoch for every detected row (any
    policy) and ``overrides`` maps flat row -> truncated epoch budget
    for the rows actually frozen (``cancel_row``).
    """
    bad: Dict[int, int] = {}  # local row -> last trusted epoch
    for i, c in enumerate(members):
        e = first_bad_epoch(hist[i], resolved[c].epochs, wd.explosion_ratio)
        if e is not None:
            bad[i] = e - 1
    if not bad:
        return hist, w_fin, {}, {}

    policies = {i: wd.policy_for(tenant_of(members[i])) for i in bad}
    diverged = {int(members[i]): int(k) for i, k in bad.items()}
    if allow_cancel_job and any(p == "cancel_job" for p in policies.values()):
        raise JobDiverged(diverged)

    cancel = {i: bad[i] for i, p in policies.items() if p != "record"}
    overrides: Dict[int, int] = {}
    if cancel:
        amended = list(resolved)
        for i, k in cancel.items():
            c = int(members[i])
            amended[c] = amended[c]._replace(epochs=int(k))
            overrides[c] = int(k)
        hist2, w2 = redispatch(amended)
        hist = np.array(hist, copy=True)
        w_fin = np.array(w_fin, copy=True)
        for i in cancel:
            hist[i] = hist2[i]
            w_fin[i] = w2[i]
    return hist, w_fin, diverged, overrides
