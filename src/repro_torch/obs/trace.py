"""Request-lifecycle flight recorder: bounded, structured, stdlib-only.

The port of `repro.obs.trace`. One process-global `Tracer` records
monotonic-clock spans with explicit parent ids into a ring buffer of
recent traces. A trace id is minted at `SweepService.submit` and threaded
through the scheduler and the runner cache, so one request's life —

    submit -> plan -> coalesce -> pad -> dispatch -> execute -> demux
           -> result

— is retrievable as a span tree (`Tracer.get`) after the result went out.
Design constraints, in order:

  * ZERO warm-path cost when disabled: tracing is opt-in
    (`enable_tracing()`); disabled, `new_trace()` returns ``""`` and every
    span call is a constant-time no-op returning a shared null handle.
  * Outside the engines by construction: spans bracket runner *calls* on
    the host, never the epoch bodies or a kernel launcher, and repro-lint
    RL006 bans these APIs from `*_core` functions and kernel modules.
    A runner call on the card returns once its launches are queued, so
    the ``execute`` span of `repro_torch.core.sweep._dispatch_group`
    closes only after the results reached the host.
  * BOUNDED: at most ``max_traces`` recent traces, ``max_spans`` spans
    each; the last trace that recorded an error is retained separately so
    a crash dump survives the ring buffer.

Shared flush phases touch MANY requests at once (one coalesced dispatch
serves every pooled request), so `span_all` opens one span PER TRACE for
a phase and `span_active` / `annotate` address "whatever span group is
open on this thread" — that is how `service/cache.py` attributes a
cache hit/miss/compile to every request riding the dispatch without ever
learning their trace ids.

Stdlib-only: `repro_torch.core.sweep` imports this module.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Span:
    """One timed phase of one request's life. ``parent_id`` is explicit —
    the dump is a tree, not a flat log — and ``tags`` carry the phase's
    attribution facts (group key, cache hit/miss, kernel mode, rows)."""
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    name: str
    start_s: float
    end_s: Optional[float] = None
    tags: Dict[str, object] = dataclasses.field(default_factory=dict)
    error: Optional[str] = None

    def to_dict(self) -> dict:
        dur = (None if self.end_s is None
               else (self.end_s - self.start_s) * 1000.0)
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "start_s": self.start_s,
                "duration_ms": dur, "tags": dict(self.tags),
                "error": self.error}


class _NullHandle:
    """The disabled-path span handle: a shared, reusable no-op context
    manager, so a tracer-off hot loop allocates nothing per span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullHandle()


class _SpanHandle:
    """Context manager closing one GROUP of spans (one per trace sharing
    the phase). Opening pushes the group on the thread's stack so nested
    `span_active` / `annotate` calls can find it without knowing ids."""
    __slots__ = ("_tracer", "_spans")

    def __init__(self, tracer: "Tracer", spans: List[Span]):
        self._tracer = tracer
        self._spans = spans

    def __enter__(self) -> "_SpanHandle":
        self._tracer._push(self._spans)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._pop(self._spans, exc)
        return False


class Tracer:
    """The flight recorder. Use the module-level singleton via `tracer()`
    (plus `enable_tracing()` / `disable_tracing()`); instances exist for
    tests."""

    def __init__(self, max_traces: int = 256, max_spans: int = 512):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._enabled = False
        self._lock = threading.Lock()
        # trace id -> list of spans, insertion-ordered so the oldest trace
        # is evicted first; a trace's spans append in open order
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()  # guarded-by: _lock
        self._last_error: Optional[dict] = None  # guarded-by: _lock
        self._ids = itertools.count(1)
        self._tls = threading.local()            # per-thread open-span stack

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> None:
        with self._lock:
            self._enabled = True

    def disable(self, clear: bool = False) -> None:
        with self._lock:
            self._enabled = False
            if clear:
                self._traces.clear()
                self._last_error = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------------- recording
    def new_trace(self) -> str:
        """Mint a trace id (or ``""`` when disabled — the empty id threads
        through every span API as a no-op, so call sites never branch)."""
        if not self._enabled:
            return ""
        tid = f"t{next(self._ids):08x}"
        with self._lock:
            self._traces[tid] = []
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
        return tid

    def span(self, trace_id: str, name: str, *,
             parent_name: Optional[str] = None, **tags):
        """Open one span in one trace (context manager)."""
        return self.span_all((trace_id,), name, parent_name=parent_name,
                             **tags)

    def span_all(self, trace_ids: Sequence[str], name: str, *,
                 parent_name: Optional[str] = None, **tags):
        """Open the SAME phase across many traces (one span each) — the
        shared flush phases (coalesce/pad/dispatch/demux) serve every
        pooled request at once. Unknown/empty ids are skipped, so a flush
        mixing traced and untraced requests records only the former."""
        if not self._enabled:
            return _NULL
        now = time.monotonic()
        spans: List[Span] = []
        with self._lock:
            for tid in dict.fromkeys(trace_ids):     # dedupe, keep order
                store = self._traces.get(tid) if tid else None
                if store is None or len(store) >= self.max_spans:
                    continue
                span = Span(trace_id=tid, span_id=next(self._ids),
                            parent_id=self._parent_id_locked(tid,
                                                             parent_name),
                            name=name, start_s=now, tags=dict(tags))
                store.append(span)
                spans.append(span)
        if not spans:
            return _NULL
        return _SpanHandle(self, spans)

    def span_active(self, name: str, **tags):
        """Open ``name`` as a child of every span in the innermost open
        group ON THIS THREAD — for layers (the runner call deep inside
        `_dispatch_group`) that never see trace ids but run inside a
        traced phase."""
        if not self._enabled:
            return _NULL
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return _NULL
        now = time.monotonic()
        spans: List[Span] = []
        with self._lock:
            for parent in stack[-1]:
                store = self._traces.get(parent.trace_id)
                if store is None or len(store) >= self.max_spans:
                    continue
                span = Span(trace_id=parent.trace_id,
                            span_id=next(self._ids),
                            parent_id=parent.span_id, name=name,
                            start_s=now, tags=dict(tags))
                store.append(span)
                spans.append(span)
        if not spans:
            return _NULL
        return _SpanHandle(self, spans)

    def annotate(self, **tags) -> None:
        """Merge tags into every span of the innermost open group on this
        thread (no-op outside any span) — how the runner cache stamps
        hit/miss/compile attribution onto whatever dispatch is running."""
        if not self._enabled:
            return
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return
        with self._lock:
            for span in stack[-1]:
                span.tags.update(tags)

    def record_error(self, trace_id: str, exc: BaseException) -> None:
        """Mark a trace failed and retain its dump as the last-error trace
        (survives ring-buffer eviction — the crash you debug tomorrow)."""
        if not self._enabled or not trace_id:
            return
        with self._lock:
            store = self._traces.get(trace_id)
            if store is None:
                return
            marker = Span(trace_id=trace_id, span_id=next(self._ids),
                          parent_id=store[0].span_id if store else None,
                          name="error", start_s=time.monotonic(),
                          end_s=time.monotonic(),
                          error=f"{type(exc).__name__}: {exc}")
            if len(store) < self.max_spans:
                store.append(marker)
            self._last_error = {
                "trace_id": trace_id,
                "error": marker.error,
                "spans": [s.to_dict() for s in store],
            }

    # ------------------------------------------------------------- retrieval
    def get(self, trace_id: str) -> Optional[dict]:
        """One trace's span tree as a JSON-safe dict (None if unknown or
        already evicted from the ring buffer)."""
        with self._lock:
            store = self._traces.get(trace_id)
            if store is None:
                return None
            return {"trace_id": trace_id,
                    "spans": [s.to_dict() for s in store]}

    def recent(self, n: int = 16) -> List[dict]:
        """Summaries of the n most recent traces, newest first."""
        with self._lock:
            items = list(self._traces.items())[-n:]
        out = []
        for tid, spans in reversed(items):
            root = spans[0] if spans else None
            out.append({
                "trace_id": tid,
                "spans": len(spans),
                "root": root.name if root else None,
                "tags": dict(root.tags) if root else {},
                "error": next((s.error for s in spans if s.error), None),
            })
        return out

    def last_error(self) -> Optional[dict]:
        with self._lock:
            return self._last_error

    # -------------------------------------------------------------- internal
    def _parent_id_locked(self, tid: str,
                          parent_name: Optional[str]) -> Optional[int]:  # holds: _lock
        """Explicit parent ids, resolved in priority order: a named parent
        (latest same-trace span with that name) > the innermost open
        same-trace span on this thread > the trace's root span."""
        store = self._traces.get(tid, [])
        if parent_name is not None:
            for span in reversed(store):
                if span.name == parent_name:
                    return span.span_id
        stack = getattr(self._tls, "stack", None)
        if stack:
            for group in reversed(stack):
                for span in group:
                    if span.trace_id == tid:
                        return span.span_id
        return store[0].span_id if store else None

    def _push(self, spans: List[Span]) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(spans)

    def _pop(self, spans: List[Span],
             exc: Optional[BaseException]) -> None:
        now = time.monotonic()
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is spans:
            stack.pop()
        elif stack and spans in stack:       # defensive: unbalanced exits
            stack.remove(spans)
        with self._lock:
            for span in spans:
                span.end_s = now
                if exc is not None and span.error is None:
                    span.error = f"{type(exc).__name__}: {exc}"


# --------------------------------------------------------------- singleton
_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global flight recorder every layer records into."""
    return _TRACER


def enable_tracing(max_traces: Optional[int] = None,
                   max_spans: Optional[int] = None) -> Tracer:
    """Turn the flight recorder on (optionally re-bounding it). Tracing
    is process-global and OPT-IN: a service with tracing off mints no
    trace ids and pays a single boolean check per would-be span."""
    if max_traces is not None:
        _TRACER.max_traces = int(max_traces)
    if max_spans is not None:
        _TRACER.max_spans = int(max_spans)
    _TRACER.enable()
    return _TRACER


def disable_tracing(clear: bool = False) -> None:
    _TRACER.disable(clear=clear)
