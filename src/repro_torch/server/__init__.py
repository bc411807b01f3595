"""Async serving tier over the port's sweep service, the port of
`repro.server`: an HTTP server in front of `repro_torch.service`, whose
groups run on the card (or on the CPU, for an objective built there).

Four layers on the service's scheduler and runner cache:

  * `repro_torch.server.daemon` — `ServeDaemon` + `FlushPolicy`: a
    background thread triggers the coalesced flush on size/deadline policy
    (clients never block on a barrier); giant sweeps time-slice through
    the checkpointed ``run_job(max_groups=…)`` between flushes. No width
    padding: the port's service dispatches every group at its natural row
    count, so there is no ``WidthRegistry`` and `FlushPolicy` has no
    ``stable_widths`` / ``max_pad_factor``.
  * `repro_torch.server.fairness` — `FairShare` + `TenantPolicy`:
    deficit-round-robin admission with weighted quotas and priority
    classes; one tenant's huge grid cannot starve the queue.
  * `repro_torch.server.http` / `repro_torch.server.client` — stdlib-only
    HTTP front-end (`SweepServer`) and client (`SweepClient`): submit /
    result (long-poll) / flush / stats / healthz / metrics (Prometheus
    0.0.4) / trace / watch / job / ledger, in the JAX package's wire
    format, so either package's client talks to either package's server.
  * `repro_torch.server.metrics` — one JSON snapshot: ServiceStats, queue
    depth, per-tenant rows, p50/p95 flush + request latency, daemon
    counters + heartbeat liveness.
"""
from repro_torch.server.client import ServerError, SweepClient
from repro_torch.server.daemon import (
    DaemonStats,
    FlushPolicy,
    JobHandle,
    ServeDaemon,
)
from repro_torch.server.fairness import FairShare, TenantPolicy
from repro_torch.server.http import SweepServer
from repro_torch.server.metrics import snapshot

__all__ = [
    "FlushPolicy",
    "ServeDaemon",
    "JobHandle",
    "DaemonStats",
    "FairShare",
    "TenantPolicy",
    "SweepServer",
    "SweepClient",
    "ServerError",
    "snapshot",
]
