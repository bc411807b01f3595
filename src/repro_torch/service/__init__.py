"""Sweep service: persistent runner cache + request coalescing, the port
of `repro.service`.

Three layers turn the sweep engine (`repro_torch.core.sweep`) into a
multi-tenant sweep service:

  * `repro_torch.service.cache` — module-level runner cache: runners
    keyed on the group dims + data signature, hit/miss/compile counters
    (a compile: a runner construction or a kernel build), nothing
    constructed or built for repeated same-shape sweeps.
  * `repro_torch.service.scheduler` — request coalescing: many clients'
    spec rows merged into shared groups, demuxed per request.
  * `repro_torch.service.api` — the `SweepService` front-end (submit /
    flush / result, `ServiceStats`) plus checkpoint-resumable jobs.
"""
from repro_torch.service.api import ResultEvictedError, ServiceStats, SweepService
from repro_torch.service.cache import (
    CacheStats,
    cache_size,
    cache_stats,
    clear_cache,
    get_group_runner,
    scoped_counters,
)
from repro_torch.service.scheduler import (
    CoalescedBatch,
    DispatchInfo,
    FlushSelector,
    SweepRequest,
    coalesce,
    dispatch,
)

__all__ = [
    "SweepService",
    "ServiceStats",
    "ResultEvictedError",
    "CacheStats",
    "cache_stats",
    "cache_size",
    "clear_cache",
    "scoped_counters",
    "get_group_runner",
    "SweepRequest",
    "CoalescedBatch",
    "DispatchInfo",
    "FlushSelector",
    "coalesce",
    "dispatch",
]
