"""Serving-tier metrics: one JSON-safe snapshot of everything operable;
the port of `repro.server.metrics`.

`snapshot(service, daemon=None, fairness=None)` flattens the accounting
the lower layers already keep — `ServiceStats` (requests/rows/coalescing +
the per-lookup runner-cache counters), queue depth in requests AND rows,
per-tenant row accounting, the p50/p95/max of the recent flush-dispatch
durations and request submit→result latencies, the daemon's trigger
counters, the fair-share deficit state, and the process-global runner
cache — into one plain dict of JSON types. The HTTP ``/stats`` endpoint
returns it verbatim; a Prometheus exporter would walk the same dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.obs import ledger as _ledger
from repro_torch.server.daemon import ServeDaemon
from repro_torch.server.fairness import FairShare
from repro_torch.service import cache as _cache
from repro_torch.service.api import SweepService

PERCENTILES = (50.0, 95.0)


def percentile(values: Sequence[float], q: float) -> float:
    """np.percentile with an empty-series guard (0.0), so the snapshot is
    always JSON-complete."""
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


def _latency_summary(seconds: Sequence[float]) -> Dict[str, float]:
    out: Dict[str, float] = {"count": len(seconds)}
    for q in PERCENTILES:
        out[f"p{q:g}_ms"] = percentile(seconds, q) * 1000.0
    out["max_ms"] = max(seconds) * 1000.0 if seconds else 0.0
    return out


def snapshot(service: SweepService, daemon: Optional[ServeDaemon] = None,
             fairness: Optional[FairShare] = None) -> dict:
    """One consistent, JSON-safe view of the serving tier."""
    stats = service.stats()
    flush_lat, request_lat = service.latencies()
    out = {
        "service": {**dataclasses.asdict(stats),
                    "cache_hit_rate": stats.cache_hit_rate},
        "queue": {
            "depth_requests": service.pending(),
            "depth_rows": service.pending_rows(),
            "oldest_age_ms": (service.oldest_pending_age() or 0.0) * 1000.0,
        },
        "tenants": {t: {"rows_submitted": sub, "rows_completed": done}
                    for t, (sub, done) in service.tenant_rows().items()},
        "flush_latency": _latency_summary(flush_lat),
        "request_latency": _latency_summary(request_lat),
        "runner_cache": {**dataclasses.asdict(_cache.cache_stats()),
                         "size": _cache.cache_size()},
    }
    if daemon is not None:
        # locked copies — the live stats object is concurrently mutated by
        # the flush thread and flush_now() callers (RL003 guards it)
        err = daemon.last_error_snapshot()
        out["daemon"] = {**dataclasses.asdict(daemon.stats_snapshot()),
                         "jobs_pending": daemon.jobs_pending(),
                         "policy": dataclasses.asdict(daemon.policy),
                         "running": daemon.running(),
                         "heartbeat_age_s": daemon.heartbeat_age_s(),
                         "last_error": repr(err) if err else None}
    if fairness is not None:
        out["fairness"] = {
            "quantum_rows": fairness.quantum_rows,
            "max_rows_per_flush": fairness.max_rows_per_flush,
            "deficits": fairness.deficits(),
        }
    if _ledger.ledger_enabled():
        # opt-in section: tests pin the exact default section set, and an
        # empty ledger on every scrape would just be noise
        out["ledger"] = _ledger.ledger().snapshot()
    return out
