"""`SweepService` — the multi-tenant front-end over the coalescing
scheduler and the persistent runner cache; the port of
`repro.service.api`.

Usage:

    svc = SweepService(obj, epochs=6)
    rid_a = svc.submit(client_a_specs)          # admit; nothing runs yet
    rid_b = svc.submit(client_b_specs, epochs=12)
    svc.flush()                                 # coalesce + dispatch once
    res_a = svc.result(rid_a)                   # == run_sweep(obj, 6, a)
    print(svc.stats())                          # rows coalesced, hit rate…

`submit` only queues; `flush` coalesces every pending request into shared
groups (repro_torch.service.scheduler) and dispatches them through the
module-level runner cache (repro_torch.service.cache), so a warm service
constructs no runner and builds no kernel. ``result()`` flushes
implicitly if its request is still pending. Each request's result equals a
standalone `run_sweep` of its specs (bit for bit in fused mode and on the
CPU; within float64 rounding for batched rows on the card, see the
scheduler's docstring).

Long-running sweeps checkpoint through the port's
`repro_torch.checkpoint.Checkpointer`: :meth:`run_job` dispatches a job
group by group, saving partial results atomically after each, and resumes
from the newest valid checkpoint — a preempted job re-runs only its
unfinished groups. ``max_groups`` bounds one call's work.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.objective import Objective
from repro_torch.core.sweep import (
    SweepResult,
    SweepSpec,
    _active_mesh,
    _assemble_result,
    _dispatch_group,
    check_mesh,
    _write_row_history,
    group_label,
    plan_sweep,
)
from repro_torch.obs import progress as _progress
from repro_torch.obs.metrics import ServiceHistograms
from repro_torch.obs.trace import tracer as _tracer
from repro_torch.service import cache as _cache
from repro_torch.sharding.context import mesh_barrier
from repro_torch.service.scheduler import (FlushSelector, SweepRequest,
                                           coalesce, dispatch)


def _row_loss_series(histories, epochs_per_row):
    """Per-row ``(losses, deltas)`` for live-progress events, each row
    trimmed to its own epoch budget. Host-side numpy over the RETURNED
    histories (never inside an engine — RL006), and value-exact: a float32
    history entry round-trips through the Python float unchanged, so a
    watcher can compare streamed losses bit-for-bit against the final
    ``SweepResult``."""
    losses = []
    deltas = []
    for c in range(histories.shape[0]):
        h = histories[c, :int(epochs_per_row[c]) + 1]
        losses.append(tuple(float(v) for v in h))
        deltas.append(tuple(float(v) for v in np.diff(h)))
    return tuple(losses), tuple(deltas)


class ResultEvictedError(KeyError):
    """The request id WAS completed, but its result has been released —
    evicted past the service's ``max_results`` FIFO retention bound or
    explicitly ``discard()``ed. Distinct from the bare KeyError an id that
    never existed raises, so a client of a busy server knows to re-submit
    (or raise ``max_results``) instead of chasing a phantom id."""


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Service-lifetime accounting. The cache counters are credited at the
    LOOKUP SITE through a thread-scoped sink (`repro_torch.service.cache
    .scoped_counters`), so they cover exactly this service's own lookups —
    another service flushing concurrently in the same process cannot
    pollute them. ``compiles`` counts runner constructions and kernel
    builds (`repro_torch.service.cache`)."""
    requests_submitted: int
    requests_completed: int
    rows_submitted: int
    rows_coalesced: int          # rows that shared a group across requests
    groups_dispatched: int
    groups_merged: int           # dispatched groups holding >1 request
    flushes: int
    cache_hits: int
    cache_misses: int
    compiles: int
    rows_diverged: int = 0       # rows the divergence watchdog flagged

    @property
    def cache_hit_rate(self) -> float:
        lookups = self.cache_hits + self.cache_misses
        return self.cache_hits / lookups if lookups else 0.0


class SweepService:
    """Admit many clients' `SweepSpec` rows, run them as shared groups,
    hand back per-request results.

    One service instance is bound to one DEFAULT objective (`obj` — any
    `repro_torch.core.objective.Objective`, backing specs with
    ``objective=""``), one default epoch budget and one ``drop_prob``/
    ``w0`` — the things `run_sweep` takes as call arguments. The groups
    run on the objective's device: the card, unless the objective was
    built with ``device="cpu"``. ``obj`` may be None when every submitted
    spec names a REGISTERED objective; one service then sweeps many
    objectives, and the objective fingerprint in the group key keeps
    their dispatches apart. ``mesh`` (a named `DeviceMesh`) row-shards
    every flush over its ``data`` axis; ``mesh=None`` re-resolves the
    ambient `repro_torch.sharding.context` mesh at every flush, so a
    service created inside a launcher's `mesh_context` shards its groups
    with no call-site changes. Under a mesh `flush` and `run_job` are
    collective: every rank of the mesh submits the same requests and
    flushes with them.
    """

    def __init__(self, obj: Optional[Objective], *, epochs: int = 10,
                 drop_prob: float = 0.02, mesh=None,
                 w0=None, max_results: int = 1024,
                 latency_window: int = 512, max_tenants: int = 1024,
                 watchdog=None):
        check_mesh(mesh)
        self.obj = obj
        self.mesh = mesh
        self.default_epochs = epochs
        self.drop_prob = drop_prob
        self.w0 = w0
        # divergence watchdog (repro_torch.obs.watchdog.Watchdog, or None):
        # inspects every dispatched group's histories at flush/slice
        # boundaries and applies the owning tenant's policy. Set before
        # serving, never mutated mid-flight.
        self.watchdog = watchdog
        # flush-policy hook a serving tier installs: submit listeners wake
        # a flush daemon
        self._submit_listeners: List[Callable[[], None]] = []  # guarded-by: _lock
        # queue/id/results/stats mutations hold _lock so concurrent tenant
        # threads can't mint duplicate ids or lose a submit that races a
        # flush; the group dispatch itself runs OUTSIDE the lock (re-entrant
        # so helpers can lock themselves when called from either path)
        self._lock = threading.RLock()
        # ids detached from the queue but not yet in _results; result()
        # waits on this condition instead of misreporting a mid-dispatch
        # request as unknown
        self._inflight: set = set()  # guarded-by: _lock
        self._done_cv = threading.Condition(self._lock)
        self._pending: List[SweepRequest] = []  # guarded-by: _lock
        # completed results are FIFO-bounded (like the LRU-bounded runner
        # cache one layer down): a long-lived server must not accumulate
        # every tenant's histories forever. Clients read soon after flush;
        # evicted ids raise KeyError like unknown ones.
        self._results: "OrderedDict[int, SweepResult]" = OrderedDict()  # guarded-by: _lock
        self._max_results = max_results
        # ids a thread is currently blocked on in wait_result()/result():
        # the retention eviction skips these — a result must never be
        # thrown away while its consumer is blocked waiting for it
        self._watched: Dict[int, int] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        # service-local cache accounting, credited PER LOOKUP: dispatch
        # windows install this sink on their thread via
        # `cache.scoped_counters`, so only lookups this service actually
        # performs land here — exact even when several services flush
        # concurrently (the old absorb-the-global-delta scheme was racy
        # across services and is gone)
        self._cache_sink = _cache._Counters()
        self._requests_submitted = 0  # guarded-by: _lock
        self._requests_completed = 0  # guarded-by: _lock
        self._rows_submitted = 0  # guarded-by: _lock
        self._rows_coalesced = 0  # guarded-by: _lock
        self._groups_dispatched = 0  # guarded-by: _lock
        self._groups_merged = 0  # guarded-by: _lock
        self._rows_diverged = 0  # guarded-by: _lock
        self._flushes = 0  # guarded-by: _lock
        # tenant -> [rows submitted, rows completed] (metrics endpoint);
        # FIFO-bounded like the results store — tenant tags are arbitrary
        # client-supplied strings, so an adversarial/buggy client minting a
        # fresh tag per request must not grow the map without bound
        self._tenant_rows: "OrderedDict[str, List[int]]" = OrderedDict()  # guarded-by: _lock
        self._max_tenants = max_tenants
        # recent flush dispatch durations + request submit->complete
        # latencies (seconds), bounded so a long-lived server can't grow
        # them; the metrics layer derives p50/p95 from these
        self._flush_latencies: deque = deque(maxlen=latency_window)  # guarded-by: _lock
        self._request_latencies: deque = deque(maxlen=latency_window)  # guarded-by: _lock
        # request id -> flight-recorder trace id (empty entries are never
        # stored); bounded like the results store so a long-lived server
        # can't accumulate ids forever. The histograms self-lock, so
        # observes happen wherever is convenient.
        self._trace_ids: "OrderedDict[int, str]" = OrderedDict()  # guarded-by: _lock
        self.histograms = ServiceHistograms()

    # ---------------------------------------------------------------- queue
    def submit(self, specs: Sequence[SweepSpec],
               epochs: Optional[int] = None, *, tenant: str = "default",
               priority: int = 0) -> int:
        """Admit one request (one logical client). Returns its id; nothing
        executes until `flush` (or a `result` call forces one).

        ``tenant``/``priority`` tag the request for admission control —
        a flush selector may slice flushes by them; they never affect the
        numeric result.

        Specs are VALIDATED here, not at flush: the request is fully
        planned (normalized AND resolved against the objective, the same
        `plan_sweep` a flush would run), so an invalid spec — bad
        algo/scheme/delay, contradictory svrg τ, non-positive epochs or
        inner-step counts — raises to the submitting client only and can
        never poison a shared flush (which would wedge every other
        tenant's pending request).
        """
        specs = tuple(specs)
        if not specs:
            raise ValueError("empty request")
        default = epochs if epochs is not None else self.default_epochs
        tr = _tracer()
        tid = tr.new_trace()
        with tr.span(tid, "submit", rows=len(specs), tenant=str(tenant)):
            with tr.span(tid, "plan", parent_name="submit"):
                plan_sweep(self.obj, default, specs)  # raises on bad spec
            with self._lock:
                rid = self._next_id
                self._next_id += 1
                self._pending.append(SweepRequest(
                    request_id=rid, specs=specs, epochs=default,
                    tenant=str(tenant), priority=int(priority),
                    submitted_at=time.monotonic(), trace_id=tid))
                if tid:
                    self._trace_ids[rid] = tid
                    while len(self._trace_ids) > self._max_results:
                        self._trace_ids.popitem(last=False)
                self._requests_submitted += 1
                self._rows_submitted += len(specs)
                rows = self._tenant_rows.setdefault(str(tenant), [0, 0])
                rows[0] += len(specs)
                while len(self._tenant_rows) > self._max_tenants:
                    self._tenant_rows.popitem(last=False)
                listeners = tuple(self._submit_listeners)
            tr.annotate(request_id=rid)
        for cb in listeners:                     # outside the lock: a
            cb()                                 # listener may touch us
        return rid

    def add_submit_listener(self, cb: Callable[[], None]) -> None:
        """Register a callback fired after every successful submit (the
        background flush daemon's wake-up hook)."""
        with self._lock:
            self._submit_listeners.append(cb)

    def remove_submit_listener(self, cb: Callable[[], None]) -> None:
        with self._lock:
            if cb in self._submit_listeners:
                self._submit_listeners.remove(cb)

    def flush(self, selector: Optional[FlushSelector] = None) -> List[int]:
        """Coalesce + dispatch pending requests; returns completed ids.

        ``selector`` (the fair-share admission hook) partitions the queue
        into the requests this flush takes and the ones it keeps for the
        next; ``None`` takes everything. Kept requests stay pending in
        their selector-returned order.

        The queue is detached BEFORE dispatch (one atomic swap), so a
        request submitted while the groups run lands in the fresh queue
        for the next flush instead of being silently dropped by a
        post-dispatch clear; if dispatch fails the detached requests are
        re-queued rather than lost."""
        with self._lock:
            if selector is None:
                pending, self._pending = self._pending, []
            else:
                before = sorted(r.request_id for r in self._pending)
                take, keep = selector(tuple(self._pending))
                pending, keep = list(take), list(keep)
                after = sorted(r.request_id for r in pending + keep)
                if after != before:
                    raise ValueError(
                        "flush selector must partition the pending queue "
                        f"(got ids {after}, queue held {before})")
                self._pending = keep
            self._inflight.update(r.request_id for r in pending)
        if not pending:
            return []
        tr = _tracer()
        tids = tuple(r.trace_id for r in pending) if tr.enabled else ()
        t0 = time.perf_counter()
        try:
            with tr.span_all(tids, "coalesce", parent_name="submit",
                             requests=len(pending)):
                batch = coalesce(self.obj, tuple(pending))
            with _cache.scoped_counters(self._cache_sink):
                results, info = dispatch(self.obj, batch, w0=self.w0,
                                         drop_prob=self.drop_prob,
                                         mesh=_active_mesh(self.mesh),
                                         watchdog=self.watchdog)
        except Exception as exc:
            for r in pending:
                tr.record_error(r.trace_id, exc)
            with self._lock:
                self._pending = pending + self._pending
                self._inflight.difference_update(
                    r.request_id for r in pending)
                self._done_cv.notify_all()
            raise
        now = time.monotonic()
        dt = time.perf_counter() - t0
        if self.histograms.enabled:
            self.histograms.flush_latency_seconds.observe(dt)
            self.histograms.rows_per_flush.observe(info.rows_dispatched)
        if _progress.progress_enabled():
            self._publish_flush_events(pending, results, dt)
        with self._lock:
            self._results.update(results)
            # evict oldest first, but never a result a thread is blocked
            # waiting on — one wide flush completing more requests than
            # max_results must not throw away work whose consumer is
            # already parked on the condition variable
            evictable = [rid for rid in self._results
                         if rid not in self._watched]
            while len(self._results) > self._max_results and evictable:
                del self._results[evictable.pop(0)]
            self._inflight.difference_update(results)
            self._requests_completed += len(results)
            self._rows_coalesced += info.rows_coalesced
            self._groups_dispatched += info.groups_dispatched
            self._groups_merged += info.groups_merged
            self._rows_diverged += info.rows_diverged
            self._flushes += 1
            self._flush_latencies.append(dt)
            for req in pending:
                self._tenant_rows.setdefault(req.tenant, [0, 0])[1] += \
                    req.rows
                if req.submitted_at:
                    latency = now - req.submitted_at
                    self._request_latencies.append(latency)
                    if self.histograms.enabled:
                        self.histograms.request_latency_seconds.observe(
                            latency)
            self._done_cv.notify_all()
        return sorted(results)

    def _publish_flush_events(self, pending, results, dt: float) -> None:
        """One live-progress event per request this flush completed, on the
        ``req-<id>`` watch channel. Losses are the request's OWN result
        histories (each row trimmed to its epoch budget), so what a
        watcher streams is exactly what ``result()`` later returns."""
        bus = _progress.progress_bus()
        by_id = {r.request_id: r for r in pending}
        for rid, res in results.items():
            req = by_id[rid]
            losses, deltas = _row_loss_series(res.histories,
                                              res.epochs_per_row)
            diverged = ()
            if res.diverged_rows is not None:
                diverged = tuple(int(c) for c in
                                 np.flatnonzero(res.diverged_rows >= 0))
            bus.publish(kind="flush", watch_id=f"req-{rid}",
                        tenant=req.tenant, rows=tuple(range(len(res.specs))),
                        losses=losses, loss_deltas=deltas, diverged=diverged,
                        wall_s=dt, trace_id=req.trace_id)

    def _missing(self, request_id: int) -> KeyError:  # holds: _lock
        """The right error for an id that is not pending/inflight/stored.
        Every minted id enters the queue, so an id below the mint counter
        MUST have completed and been released — distinguishable from a
        phantom id with no bookkeeping at all."""
        if 0 <= request_id < self._next_id:
            return ResultEvictedError(
                f"result for request {request_id} was evicted: completed "
                f"results are FIFO-bounded (max_results={self._max_results})"
                " or were explicitly discarded; re-submit the specs or "
                "raise max_results")
        return KeyError(f"unknown request id {request_id}")

    def _watch(self, request_id: int) -> None:
        """Mark an id as actively awaited (refcounted): the retention
        eviction will not drop it while any waiter is parked on it."""
        with self._lock:
            self._watched[request_id] = self._watched.get(request_id, 0) + 1

    def _unwatch(self, request_id: int) -> None:
        with self._lock:
            count = self._watched.get(request_id, 0) - 1
            if count <= 0:
                self._watched.pop(request_id, None)
            else:
                self._watched[request_id] = count

    def result(self, request_id: int) -> SweepResult:
        """This request's `SweepResult` (equal to a standalone `run_sweep`
        of its specs). Flushes first if it is still queued,
        and WAITS if another thread's flush has the request in flight.
        Raises `ResultEvictedError` for completed-then-released ids and
        bare KeyError for ids that never existed."""
        tr = _tracer()
        self._watch(request_id)
        try:
            with tr.span(self.trace_id(request_id), "result",
                         parent_name="submit"):
                while True:
                    with self._done_cv:        # shares the service lock
                        if request_id in self._results:
                            return self._results[request_id]
                        if request_id in self._inflight:
                            self._done_cv.wait()
                            continue
                        queued = any(r.request_id == request_id
                                     for r in self._pending)
                        if not queued:
                            raise self._missing(request_id)
                    self.flush()
        finally:
            self._unwatch(request_id)

    def wait_result(self, request_id: int,
                    timeout: Optional[float] = None) -> SweepResult:
        """Like :meth:`result` but NEVER triggers a flush itself — it
        waits for someone else's (another thread's flush, a flush daemon),
        so a result poll can't defeat coalescing.
        Raises TimeoutError if the deadline passes first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        tr = _tracer()
        self._watch(request_id)
        try:
            with tr.span(self.trace_id(request_id), "result",
                         parent_name="submit"):
                with self._done_cv:
                    while True:
                        if request_id in self._results:
                            return self._results[request_id]
                        if (request_id not in self._inflight
                                and not any(r.request_id == request_id
                                            for r in self._pending)):
                            raise self._missing(request_id)
                        remaining = (None if deadline is None
                                     else deadline - time.monotonic())
                        if remaining is not None and remaining <= 0:
                            raise TimeoutError(
                                f"request {request_id} not completed "
                                f"within {timeout}s (still queued or in "
                                "flight)")
                        self._done_cv.wait(remaining)
        finally:
            self._unwatch(request_id)

    def discard(self, request_id: int) -> None:
        """Release a completed result early (no-op if absent) — the
        explicit retention hook for clients that have consumed it."""
        with self._lock:
            self._results.pop(request_id, None)

    def sweep(self, specs: Sequence[SweepSpec],
              epochs: Optional[int] = None) -> SweepResult:
        """submit + flush + result in one call (the single-tenant path —
        still coalesced with anything already queued, still cache-warm)."""
        return self.result(self.submit(specs, epochs))

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def pending_rows(self) -> int:
        """Total spec rows waiting in the queue (the flush-size trigger)."""
        with self._lock:
            return sum(r.rows for r in self._pending)

    def oldest_pending_age(self) -> Optional[float]:
        """Seconds since the OLDEST queued request was admitted (the
        flush-deadline trigger), or None when the queue is empty."""
        with self._lock:
            stamps = [r.submitted_at for r in self._pending
                      if r.submitted_at]
            if not stamps:
                return None
            return time.monotonic() - min(stamps)

    def trace_id(self, request_id: int) -> str:
        """The flight-recorder trace id :meth:`submit` minted for a
        request ("" when tracing was off at submit, or the id aged out of
        the bounded map); `repro_torch.obs.trace.tracer().get` returns its
        span tree."""
        with self._lock:
            return self._trace_ids.get(request_id, "")

    def tenant_rows(self) -> Dict[str, Tuple[int, int]]:
        """Per-tenant (rows submitted, rows completed) snapshot."""
        with self._lock:
            return {t: (v[0], v[1]) for t, v in self._tenant_rows.items()}

    def latencies(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        """(recent flush dispatch durations, recent request submit->result
        latencies), both in seconds and bounded by ``latency_window`` —
        the raw series a metrics layer derives p50/p95 from."""
        with self._lock:
            return tuple(self._flush_latencies), \
                tuple(self._request_latencies)

    # ---------------------------------------------------------------- stats
    def stats(self) -> ServiceStats:
        """A LOCKED snapshot: the service-level fields are read under the
        service lock in one critical section, so a completed flush is
        counted all-or-nothing across them. The cache counters are the one
        exception — they advance at lookup/trace time MID-dispatch (under
        the cache lock), so a snapshot taken during a flush can show its
        lookups before its ``flushes`` increment; successive snapshots are
        monotonic either way."""
        with self._lock:
            cache = self._cache_sink.snapshot()
            return ServiceStats(
                requests_submitted=self._requests_submitted,
                requests_completed=self._requests_completed,
                rows_submitted=self._rows_submitted,
                rows_coalesced=self._rows_coalesced,
                groups_dispatched=self._groups_dispatched,
                groups_merged=self._groups_merged,
                flushes=self._flushes,
                cache_hits=cache.hits,
                cache_misses=cache.misses,
                compiles=cache.compiles,
                rows_diverged=self._rows_diverged)

    # ------------------------------------------------------ checkpointed job
    def run_job(self, specs: Sequence[SweepSpec],
                epochs: Optional[int] = None, *,
                checkpointer: Checkpointer,
                max_groups: Optional[int] = None,
                tenant: str = "default",
                progress_id: Optional[str] = None,
                ) -> Tuple[Optional[SweepResult], bool]:
        """Run one long sweep group-by-group with checkpoint-resume.

        After every dispatched group the partial result is saved through
        ``checkpointer`` (the port's `Checkpointer`; atomic rename — a
        crash mid-job loses at most the in-flight group). A rerun with the
        same specs/epochs restores the newest checkpoint and dispatches
        only the unfinished groups; a fingerprint of the resolved plan
        guards against resuming a DIFFERENT job from the same directory.
        ``max_groups`` caps how many groups this call dispatches
        (preemption budget). Under a mesh the call is collective and
        ``checkpointer`` names one directory that every rank reads: the
        mesh's first rank alone writes it, and the ranks meet at a barrier
        after the restore and after each save.

        Each group boundary is a live-observability slice: when progress
        streaming is on (`repro_torch.obs.progress`) a ``slice`` event
        carrying the group's per-row loss series is published to
        ``progress_id``, plus a final ``done`` event. When
        ``self.watchdog`` is set, each slice's histories are inspected;
        ``tenant`` selects the per-tenant policy, and a ``cancel_job``
        verdict raises `repro_torch.obs.watchdog.JobDiverged` (finished
        groups stay checkpointed). Watchdog truncations persist in the
        checkpoint (``epochs_eff``/``diverged``), so a resumed job keeps
        its frozen rows.

        Returns ``(result, done)`` — ``result`` is None until every group
        has run, then equal to ``run_sweep(obj, epochs, specs)`` (with
        ``diverged_rows`` marked when the watchdog intervened): each group
        is the same dispatch `run_sweep` makes.
        """
        epochs = epochs if epochs is not None else self.default_epochs
        plan = plan_sweep(self.obj, epochs, specs)
        job_obj = plan.objective
        group_items = list(plan.groups.items())
        resolved = plan.resolved
        C = len(plan.specs)
        max_epochs = max(r.epochs for r in resolved)
        epochs_per_row = np.asarray([r.epochs for r in resolved], np.int64)
        # the fingerprint pins the RESOLVED plan AND the numeric inputs:
        # specs + epochs + drop_prob + the objective fingerprint (its static
        # config AND every data leaf's bytes) + the actual w0 bytes, so
        # groups checkpointed from one starting point or dataset are never
        # blended with groups resumed under another
        w_init = (job_obj.init_flat() if self.w0 is None
                  else job_obj.as_flat(self.w0))
        fp = zlib.crc32(repr((plan.specs, tuple(epochs_per_row.tolist()),
                              self.drop_prob,
                              job_obj.fingerprint())).encode())
        fp = zlib.crc32(np.ascontiguousarray(
            w_init.detach().cpu().numpy()).tobytes(), fp)

        # the checkpointed state: host tensors (the port's Checkpointer
        # stores torch trees), written through their numpy views below.
        # ``epochs_eff`` is the EFFECTIVE per-row epoch budget (cancel_row
        # truncations land here), ``diverged`` -1 healthy, else the last
        # trusted epoch
        state = {
            "histories": torch.zeros((C, max_epochs + 1), dtype=torch.float32),
            "final_w": torch.zeros((C, job_obj.flat_dim), dtype=torch.float32),
            "done": torch.zeros((len(group_items),), dtype=torch.int8),
            "fingerprint": torch.tensor(fp, dtype=torch.int64),
            "epochs_eff": torch.from_numpy(epochs_per_row.copy()),
            "diverged": torch.full((C,), -1, dtype=torch.int64),
        }
        try:
            state, _ = checkpointer.restore(state)
        except FileNotFoundError:
            pass                                 # fresh job
        except (KeyError, ValueError) as e:
            # same directory, different tree/shapes: a different job
            raise ValueError(
                f"checkpoint directory {checkpointer.dir!r} holds a "
                f"different job (incompatible checkpoint: {e})") from e
        else:
            if int(state["fingerprint"]) != fp:
                raise ValueError(
                    "checkpoint directory holds a different job "
                    f"(fingerprint {int(state['fingerprint'])} != {fp})")
        view = {k: v.numpy() for k, v in state.items()}

        mesh = _active_mesh(self.mesh)
        # under a mesh every rank runs the job and gets each group's whole
        # result, but one rank, the mesh's first, writes the shared
        # directory: no rank may still read it when that rank first
        # writes, and none goes on before each write is whole
        writes = mesh is None or not any(mesh.get_coordinate())
        if mesh is not None:
            mesh_barrier(mesh)
        watch_id = progress_id if progress_id is not None else "job"
        dispatched = 0
        with _cache.scoped_counters(self._cache_sink):
            for gi, (key_, members) in enumerate(group_items):
                if view["done"][gi]:
                    continue
                if max_groups is not None and dispatched >= max_groups:
                    return None, False
                group_epochs = plan.group_epochs(key_)
                # the slice's resolved rows honour earlier truncations
                # (this call's or a restored checkpoint's)
                res_rows = [r._replace(epochs=int(e)) if int(e) != r.epochs
                            else r
                            for r, e in zip(resolved, view["epochs_eff"])]
                t0 = time.perf_counter()
                hist, w_fin = _dispatch_group(job_obj, plan.specs,
                                              res_rows, members, key_,
                                              group_epochs, w_init,
                                              self.drop_prob, mesh)
                if self.watchdog is not None:
                    from repro_torch.obs.watchdog import enforce_group

                    hist, w_fin, bad, overrides = enforce_group(
                        self.watchdog, hist, w_fin, members=members,
                        resolved=res_rows, tenant_of=lambda c: tenant,
                        redispatch=lambda amended: _dispatch_group(
                            job_obj, plan.specs, amended, members, key_,
                            group_epochs, w_init, self.drop_prob, mesh))
                    for c, e in bad.items():
                        view["diverged"][c] = e
                    for c, k in overrides.items():
                        view["epochs_eff"][c] = k
                    if bad:
                        with self._lock:
                            self._rows_diverged += len(bad)
                wall_s = time.perf_counter() - t0
                for row, c in enumerate(members):
                    _write_row_history(view["histories"][c], hist[row],
                                       group_epochs)
                    view["final_w"][c] = w_fin[row]
                view["done"][gi] = 1
                dispatched += 1
                with self._lock:
                    self._groups_dispatched += 1
                if writes:
                    checkpointer.save(state, step=int(view["done"].sum()),
                                      extra={"job_fingerprint": int(fp),
                                             "groups_total": len(group_items)})
                if mesh is not None:
                    mesh_barrier(mesh)
                if _progress.progress_enabled():
                    self._publish_slice_event(
                        watch_id, tenant, key_, gi, len(group_items),
                        members, view, wall_s)
        result = _assemble_result(
            plan.specs,
            [r._replace(epochs=int(e)) if int(e) != r.epochs else r
             for r, e in zip(resolved, view["epochs_eff"])],
            view["histories"].copy(), view["final_w"].copy(),
            param_shapes=job_obj.param_shapes(), w_init=w_init,
            diverged={int(c): int(e)
                      for c, e in enumerate(view["diverged"]) if e >= 0})
        if _progress.progress_enabled():
            _progress.progress_bus().publish(
                kind="done", watch_id=watch_id, tenant=tenant,
                slices_total=len(group_items))
        return result, True

    def _publish_slice_event(self, watch_id, tenant, key_, gi, n_groups,
                             members, state, wall_s) -> None:
        """One ``slice`` event per dispatched job group: the slice's rows
        with their loss series AS CHECKPOINTED (each trimmed to the row's
        effective epoch budget — watchdog freezes included), so streaming
        watchers see exactly the final result's histories, incrementally."""
        hist_rows = state["histories"][list(members)]
        eff = state["epochs_eff"][list(members)]
        losses, deltas = _row_loss_series(hist_rows, eff)
        diverged = tuple(int(c) for c in members
                         if state["diverged"][c] >= 0)
        _progress.progress_bus().publish(
            kind="slice", watch_id=watch_id, tenant=tenant,
            group=group_label(key_), slice_index=gi, slices_total=n_groups,
            rows=tuple(int(c) for c in members), losses=losses,
            loss_deltas=deltas, diverged=diverged, wall_s=wall_s)
