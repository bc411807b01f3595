"""Background flush daemon: size/deadline-triggered coalesced dispatch.

The port of `repro.server.daemon`, over the port's `SweepService`.
`SweepService` coalesces across tenants only when someone calls
``flush()`` — so a deployment either flushes eagerly on every submit (no
cross-tenant coalescing) or parks clients behind an explicit barrier. This
module is the async alternative, the serving-layer echo of the paper's thesis that
asynchronous scheduling beats synchronous coordination: submits return
immediately, a background thread triggers the coalesced dispatch when a
`FlushPolicy` says the batch is worth running, and results land through
the service's condition variable (``wait_result``) with no client-side
barrier anywhere.

Policy triggers (whichever fires first):

  * SIZE — pending rows ≥ ``max_rows``: the batch already fills a worthwhile
    dispatch; waiting longer only adds latency.
  * DEADLINE — the OLDEST queued request has waited ``max_delay_ms``: bounded
    worst-case queueing latency, however quiet the queue is.

No width padding: the port's service dispatches every group at its natural
row count (a torch runner is not traced per row count, so a new width costs
no compile), so this module has no ``WidthRegistry`` and `FlushPolicy` has
no ``stable_widths`` / ``max_pad_factor``; ``/stats``' ``policy`` object
lacks those two keys.

Giant single requests can't be sliced by admission control (results are
per-request atomic), so the daemon time-slices them THROUGH the engine:
:meth:`ServeDaemon.submit_job` runs a sweep group-by-group via the
checkpointed ``SweepService.run_job(max_groups=…)`` between flushes — one
tenant's thousand-row grid proceeds a few groups per turn while everyone
else's small requests keep flushing in between.
"""
from __future__ import annotations

import dataclasses
import tempfile
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.sweep import SweepResult, SweepSpec
from repro_torch.server.fairness import FairShare
from repro_torch.service.api import SweepService


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """When the daemon dispatches, and how it shapes the batch.

    ``max_rows`` — size trigger: flush as soon as this many spec rows are
    queued. ``max_delay_ms`` — deadline trigger: flush once the oldest
    queued request has waited this long (the worst-case queueing latency a
    client sees on an idle server). ``job_groups_per_slice`` — how many
    groups one background-job turn may dispatch between flushes.
    ``heartbeat_stall_s`` — how stale the flush thread's per-iteration
    heartbeat may grow before ``/healthz`` reports the daemon STALLED
    (503): must comfortably exceed one flush's dispatch time, since the
    loop only stamps between turns.
    """
    max_rows: int = 64
    max_delay_ms: float = 50.0
    job_groups_per_slice: int = 1
    heartbeat_stall_s: float = 30.0

    def __post_init__(self):
        if self.max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {self.max_rows}")
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0, got "
                             f"{self.max_delay_ms}")
        if self.job_groups_per_slice < 1:
            raise ValueError("job_groups_per_slice must be >= 1, got "
                             f"{self.job_groups_per_slice}")
        if self.heartbeat_stall_s <= 0:
            raise ValueError("heartbeat_stall_s must be > 0, got "
                             f"{self.heartbeat_stall_s}")


class JobHandle:
    """A time-sliced background job's future. ``result()`` blocks until the
    daemon has dispatched every group (or surfaces the job's error)."""

    def __init__(self, job_id: int, tenant: str,
                 specs: Tuple[SweepSpec, ...], epochs: Optional[int]):
        self.job_id = job_id
        self.tenant = tenant
        self.specs = specs
        self.epochs = epochs
        self._done = threading.Event()
        self._result: Optional[SweepResult] = None
        self._error: Optional[BaseException] = None
        self.slices = 0                  # run_job turns taken so far

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> SweepResult:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not finished within {timeout}s "
                f"({self.slices} slices dispatched)")
        if self._error is not None:
            raise self._error
        return self._result

    def _finish(self, result: Optional[SweepResult],
                error: Optional[BaseException]) -> None:
        self._result, self._error = result, error
        self._done.set()


@dataclasses.dataclass
class DaemonStats:
    """What the daemon has done (exported by `repro_torch.server.metrics`)."""
    size_flushes: int = 0
    deadline_flushes: int = 0
    forced_flushes: int = 0          # explicit flush_now() calls
    flush_errors: int = 0
    job_slices: int = 0
    jobs_completed: int = 0
    jobs_failed: int = 0


class ServeDaemon:
    """Owns the flush thread: watches the service queue, fires policy-
    triggered coalesced flushes (optionally through a `FairShare`
    selector), and time-slices background jobs in the gaps.

    One daemon per service; ``start()``/``stop()`` bracket the thread
    (``stop(drain=True)`` flushes whatever is still queued and finishes
    every submitted job before returning, so shutdown loses nothing).
    """

    _POLL_S = 0.25               # idle heartbeat; submits wake us early

    def __init__(self, service: SweepService,
                 policy: FlushPolicy = FlushPolicy(), *,
                 fairness: Optional[FairShare] = None,
                 spool_dir: Optional[str] = None):
        self.service = service
        self.policy = policy
        self.fairness = fairness
        # stats/last_error are mutated by the flush thread AND by HTTP
        # threads entering through flush_now(); every touch takes _lock
        # (readers go through stats_snapshot()/last_error_snapshot())
        self.stats = DaemonStats()  # guarded-by: _lock
        self.last_error: Optional[BaseException] = None  # guarded-by: _lock
        self._spool_dir = spool_dir
        self._jobs: List[Tuple[JobHandle, Checkpointer, bool]] = []  # guarded-by: _lock
        self._next_job_id = 0  # guarded-by: _lock
        # job-id -> handle registry for the HTTP tier (POST /job submits,
        # GET /job/<id> polls). FIFO-bounded like the service's result
        # store: finished handles of a long-lived server age out, and a
        # client polling an evicted id gets the same KeyError an unknown
        # one raises.
        self._handles: "OrderedDict[int, JobHandle]" = OrderedDict()  # guarded-by: _lock
        self._max_handles = 256
        # monotonic stamp the flush thread refreshes once per loop turn;
        # /healthz compares its age against policy.heartbeat_stall_s
        self._heartbeat: Optional[float] = None  # guarded-by: _lock
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._drain = True               # stop() overrides before _stop
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeDaemon":
        if self._thread is not None:
            raise RuntimeError("daemon already started")
        self.service.add_submit_listener(self._wake.set)
        self._drain = True
        self._stop.clear()
        with self._lock:
            self._heartbeat = time.monotonic()   # liveness from t=0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sweep-flush-daemon")
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the flush thread. ``drain=True`` (default) first flushes
        whatever is queued and finishes every submitted job, so shutdown
        loses nothing; ``drain=False`` abandons queued work (it stays
        pending on the service). ``timeout=None`` waits for the drain to
        complete; with a finite timeout, an overrun raises and leaves the
        daemon installed so ``stop()`` can be retried."""
        if self._thread is None:
            return
        self._drain = drain
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"flush daemon still draining after {timeout}s; call "
                "stop() again to keep waiting")
        self._thread = None
        self.service.remove_submit_listener(self._wake.set)
        err = self.last_error_snapshot()
        if drain and self.service.pending() and err is not None:
            raise RuntimeError(
                f"drain left {self.service.pending()} request(s) queued "
                "after repeated dispatch failures; they remain pending on "
                "the service") from err

    def __enter__(self) -> "ServeDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ job lane
    def submit_job(self, specs: Sequence[SweepSpec],
                   epochs: Optional[int] = None, *,
                   tenant: str = "default",
                   checkpointer: Optional[Checkpointer] = None) -> JobHandle:
        """Queue a giant sweep for time-sliced execution: the daemon runs
        it ``job_groups_per_slice`` groups per turn via
        ``SweepService.run_job``, between regular flushes, so it can't
        starve the request queue. Without an explicit ``checkpointer`` the
        job spools scratch checkpoints under a temp dir that is deleted on
        completion (crash-resume then needs an explicit one)."""
        owns_spool = checkpointer is None
        if owns_spool:
            checkpointer = Checkpointer(
                tempfile.mkdtemp(prefix="sweep-job-", dir=self._spool_dir))
        with self._lock:
            handle = JobHandle(self._next_job_id, tenant, tuple(specs),
                               epochs)
            self._next_job_id += 1
            self._jobs.append((handle, checkpointer, owns_spool))
            self._handles[handle.job_id] = handle
            while len(self._handles) > self._max_handles:
                self._handles.popitem(last=False)
        self._wake.set()
        return handle

    def job(self, job_id: int) -> JobHandle:
        """The registered handle for ``job_id`` (HTTP ``GET /job/<id>``);
        raises KeyError for an unknown or aged-out id."""
        with self._lock:
            return self._handles[job_id]

    def jobs_pending(self) -> int:
        with self._lock:
            return len(self._jobs)

    # ------------------------------------------------------------ snapshots
    def stats_snapshot(self) -> DaemonStats:
        """A consistent COPY of the counters. The live ``stats`` object is
        mutated concurrently by the flush thread and by HTTP threads inside
        ``flush_now``; exporters (`repro_torch.server.metrics`) must read through
        here, never the live object."""
        with self._lock:
            return dataclasses.replace(self.stats)

    def last_error_snapshot(self) -> Optional[BaseException]:
        """The most recent dispatch failure (None once a flush succeeds)."""
        with self._lock:
            return self.last_error

    def running(self) -> bool:
        """True while the flush thread exists and is alive."""
        thread = self._thread
        return thread is not None and thread.is_alive()

    def heartbeat_age_s(self) -> Optional[float]:
        """Seconds since the flush thread last completed a loop turn (None
        before the first ``start()``). The loop stamps at least every
        ``_POLL_S`` while healthy; an age past
        ``policy.heartbeat_stall_s`` means a flush is wedged on the device or
        the thread died — ``/healthz`` turns 503 on either."""
        with self._lock:
            if self._heartbeat is None:
                return None
            return time.monotonic() - self._heartbeat

    # ------------------------------------------------------------ triggers
    def _flush_due(self) -> Optional[str]:
        """Which policy trigger (if any) says the queue should flush now."""
        rows = self.service.pending_rows()
        if rows == 0:
            return None
        if rows >= self.policy.max_rows:
            return "size"
        age = self.service.oldest_pending_age()
        if age is not None and age * 1000.0 >= self.policy.max_delay_ms:
            return "deadline"
        return None

    def _next_deadline_s(self) -> Optional[float]:
        """Seconds until the oldest queued request hits the deadline."""
        age = self.service.oldest_pending_age()
        if age is None:
            return None
        return max(0.0, self.policy.max_delay_ms / 1000.0 - age)

    def flush_now(self) -> List[int]:
        """Force one fair-share flush from the caller's thread (the HTTP
        /flush endpoint and the drain path)."""
        with self._lock:
            self.stats.forced_flushes += 1
        return self._flush_once()

    def _flush_once(self) -> List[int]:
        selector = self.fairness.select if self.fairness is not None else None
        try:
            done = self.service.flush(selector)   # dispatch runs unlocked
            with self._lock:
                self.last_error = None
            return done
        except Exception as e:             # requests were re-queued by the
            with self._lock:               # service; remember and back off
                self.stats.flush_errors += 1   # so a poisoned dispatch
                self.last_error = e            # cannot spin the daemon hot
            return []

    # ------------------------------------------------------------ main loop
    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                self._heartbeat = time.monotonic()
            err = self.last_error_snapshot()   # one coherent view per turn
            trigger = self._flush_due()
            if trigger is not None and err is None:
                with self._lock:
                    setattr(self.stats, f"{trigger}_flushes",
                            getattr(self.stats, f"{trigger}_flushes") + 1)
                self._flush_once()
                continue                   # fairness may have left a slice
            if err is None and self._job_slice():
                continue                   # more job groups may be waiting
            wait = self._next_deadline_s()
            if wait is not None and wait <= 0 and err is None:
                continue                   # deadline crossed since the
            #                                trigger check: re-check now
            if wait is None or err is not None:
                wait = self._POLL_S        # idle heartbeat / error backoff
            self._wake.wait(min(wait, self._POLL_S))
            self._wake.clear()
            with self._lock:
                if self.last_error is not None:
                    self.last_error = None  # one backoff period, then retry
        if self._drain:
            # "shutdown loses nothing": retry erroring flushes a few times
            # before giving up; a persistent failure is surfaced by stop()
            # (last_error + still-pending requests), not swallowed
            failures = 0
            while self.service.pending() and failures < 3:
                if self._flush_once():
                    failures = 0
                else:
                    failures += 1
            while self._job_slice():
                pass

    def _job_slice(self) -> bool:
        """Run ONE time-slice of the head background job; True if a slice
        was dispatched (the job rotates to the back of the lane so several
        giant jobs interleave fairly)."""
        with self._lock:
            if not self._jobs:
                return False
            handle, ckpt, owns_spool = self._jobs.pop(0)
        try:
            # tenant + progress channel ride along: each slice publishes a
            # live event on "job-<id>" when progress streaming is enabled,
            # and the watchdog (if configured) applies this tenant's policy
            result, done = self.service.run_job(
                handle.specs, handle.epochs, checkpointer=ckpt,
                max_groups=self.policy.job_groups_per_slice,
                tenant=handle.tenant,
                progress_id=f"job-{handle.job_id}")
        except Exception as e:
            with self._lock:
                self.stats.jobs_failed += 1
            handle._finish(None, e)
            if owns_spool:
                ckpt.delete()
            return True
        handle.slices += 1
        with self._lock:
            self.stats.job_slices += 1
            if done:
                self.stats.jobs_completed += 1
        if done:
            handle._finish(result, None)
            if owns_spool:
                ckpt.delete()
        else:
            with self._lock:
                self._jobs.append((handle, ckpt, owns_spool))
        return True
