"""Live progress streaming: a bounded, thread-safe event bus.

The port of `repro.obs.progress`. ``ProgressBus`` carries per-slice
progress events out of the sweep service while a sweep is still running:
``service/api.run_job`` publishes one event per dispatched group slice
and ``SweepService.flush`` one event per completed request; consumers
poll with a cursor.  Everything here is **host-side** — events are built
from numpy histories *after* a group's results reached the host (the
RL006 obs boundary), and the publishing fast path when streaming is off
is a single bool check.

The bus is a bounded deque: a slow or absent consumer can never grow
memory without bound, at the cost that a consumer more than
``maxlen`` events behind misses the overwritten prefix (the cursor it
gets back is still monotone, so it knows only that events up to that
sequence number existed).

This module is stdlib-only.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

__all__ = [
    "ProgressEvent",
    "ProgressBus",
    "progress_bus",
    "progress_enabled",
    "enable_progress",
    "disable_progress",
]


@dataclasses.dataclass(frozen=True)
class ProgressEvent:
    """One slice/flush worth of live progress.

    ``losses`` holds, per row dispatched in this slice, the row's loss
    history **exactly as it will appear in the final ``SweepResult``**
    (trimmed to the row's own epoch budget) — recomputed on the host
    from the returned slice histories, never from inside an engine.
    ``loss_deltas`` are the per-epoch first differences of the same
    series, the signal a live tuner promotes/retires on.
    """

    seq: int                                  # bus-assigned, monotone
    kind: str                                 # "slice" | "flush" | "done"
    watch_id: str                             # e.g. "job-3", "req-17"
    tenant: str
    group: str                                # group label (engine/M/opt/...)
    slice_index: int
    slices_total: int
    rows: Tuple[int, ...]                     # row indices within the job/request
    losses: Tuple[Tuple[float, ...], ...]     # per row, trimmed history
    loss_deltas: Tuple[Tuple[float, ...], ...]
    diverged: Tuple[int, ...]                 # rows the watchdog flagged
    wall_s: float                             # dispatch wall-clock for the slice
    trace_id: str
    ts: float                                 # host wall-clock at publish

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ProgressBus:
    """Bounded multi-producer / multi-consumer event stream.

    Consumers poll with a cursor (the highest ``seq`` they have seen);
    ``watch`` returns every retained event past the cursor, optionally
    filtered to one ``watch_id``, blocking up to ``timeout`` seconds
    for the first match.  Publishing never blocks.
    """

    def __init__(self, maxlen: int = 1024):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._events: Deque[ProgressEvent] = deque(maxlen=maxlen)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def publish(
        self,
        *,
        kind: str,
        watch_id: str,
        tenant: str = "default",
        group: str = "",
        slice_index: int = 0,
        slices_total: int = 1,
        rows: Tuple[int, ...] = (),
        losses: Tuple[Tuple[float, ...], ...] = (),
        loss_deltas: Tuple[Tuple[float, ...], ...] = (),
        diverged: Tuple[int, ...] = (),
        wall_s: float = 0.0,
        trace_id: str = "",
    ) -> ProgressEvent:
        with self._cv:
            self._seq += 1
            ev = ProgressEvent(
                seq=self._seq, kind=kind, watch_id=watch_id, tenant=tenant,
                group=group, slice_index=slice_index, slices_total=slices_total,
                rows=tuple(rows), losses=tuple(losses),
                loss_deltas=tuple(loss_deltas), diverged=tuple(diverged),
                wall_s=float(wall_s), trace_id=trace_id, ts=time.time(),
            )
            self._events.append(ev)
            self._cv.notify_all()
            return ev

    def watch(
        self,
        cursor: int = 0,
        watch_id: Optional[str] = None,
        timeout: float = 0.0,
    ) -> Tuple[List[ProgressEvent], int]:
        """Return ``(events, next_cursor)`` with ``seq > cursor``.

        ``next_cursor`` advances to the last matching event's ``seq``
        (or stays put when nothing matched), so callers resume with
        ``cursor=next_cursor`` and never see an event twice.
        """
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            while True:
                evs = [
                    e for e in self._events
                    if e.seq > cursor and (watch_id is None or e.watch_id == watch_id)
                ]
                if evs:
                    return evs, evs[-1].seq
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    return [], cursor
                self._cv.wait(remaining)

    def latest_seq(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._cv:
            self._events.clear()


_BUS = ProgressBus()
_ENABLED = False


def progress_bus() -> ProgressBus:
    return _BUS


def progress_enabled() -> bool:
    """The one-bool fast path checked at every publish site."""
    return _ENABLED


def enable_progress() -> ProgressBus:
    global _ENABLED
    _ENABLED = True
    return _BUS


def disable_progress(clear: bool = False) -> None:
    global _ENABLED
    _ENABLED = False
    if clear:
        _BUS.clear()
