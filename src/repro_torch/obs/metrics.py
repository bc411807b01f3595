"""Histograms for the sweep service's hot-path distributions.

The port of `repro.obs.metrics`. `SweepService.latencies` keeps a bounded
window of recent latencies; Prometheus wants the complementary view — a
CUMULATIVE bucket histogram over the service lifetime, scrape-rate
independent and aggregable across replicas. `Histogram` is the minimal
stdlib implementation of the text-exposition contract: fixed upper
bounds, cumulative counts at render time, `_sum`/`_count` series.

`ServiceHistograms` is the fixed set every `SweepService` carries
(observed inside `flush()`, on by default — four integer increments per
flush is noise next to a group's launches, and the ``enabled`` flag lets
a measurement price the histograms on their own):

  * ``flush_latency_seconds``   — one coalesced dispatch, wall clock
  * ``request_latency_seconds`` — submit -> result-available, per request
  * ``rows_per_flush``          — coalesced batch size (did batching work?)

(The JAX package's fourth, ``pad_factor``, measures its width-padding
policy; the port dispatches every group at its natural width and has
none.)

Thread-safety: each histogram owns a lock; observers never touch the
service lock, so recording can't extend any critical section.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

# Latency buckets: 1 ms .. 30 s, roughly x2.5 per step — the JAX
# package's buckets, so both packages' exposition lines up.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
ROWS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
                1024.0)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus classic semantics:
    bucket ``le=x`` counts observations <= x; ``+Inf`` == ``_count``)."""

    def __init__(self, buckets: Sequence[float]):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)   # guarded-by: _lock
        self._sum = 0.0                          # guarded-by: _lock
        self._count = 0                          # guarded-by: _lock

    def observe(self, value: float) -> None:
        value = float(value)
        # linear scan: bucket lists here are ~10 entries and observe runs
        # once per flush/request, not per row
        i = 0
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """(cumulative (le, count) pairs, sum, count) — render-ready."""
        with self._lock:
            counts = list(self._counts)
            total = self._sum
            n = self._count
        cumulative: List[Tuple[float, int]] = []
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            cumulative.append((bound, running))
        return cumulative, total, n


class ServiceHistograms:
    """The serving tier's fixed histogram set, rendered by
    `repro_torch.obs.prometheus.render` under ``repro_<name>``."""

    def __init__(self):
        # observe-site gate (one bool read, checked by the service before
        # recording). Default on; obs_overhead flips it per measurement
        # round to price the histogram feature in isolation.
        self.enabled = True
        self.flush_latency_seconds = Histogram(LATENCY_BUCKETS_S)
        self.request_latency_seconds = Histogram(LATENCY_BUCKETS_S)
        self.rows_per_flush = Histogram(ROWS_BUCKETS)

    def as_dict(self) -> Dict[str, Histogram]:
        return {
            "flush_latency_seconds": self.flush_latency_seconds,
            "request_latency_seconds": self.request_latency_seconds,
            "rows_per_flush": self.rows_per_flush,
        }
