"""Per-tenant admission + fair-share flush slicing; the port of
`repro.server.fairness`.

The serving queue has the classic multi-tenant failure mode: one tenant's
giant grid lands first, a plain FIFO flush takes the whole queue, and
every other tenant's two-row probe waits behind minutes of someone else's
device time. `FairShare` is a flush *selector* (`repro_torch.service.scheduler
.FlushSelector`): each flush takes a bounded, weighted fair slice of the
queue and leaves the rest pending, so successive daemon flushes drain the
queue in fair-share order instead of arrival order.

The accounting is deficit round robin (DRR), the textbook O(1) fair
scheduler, with spec ROWS as the byte-equivalent cost unit (rows are what
a flush dispatches; a request's device time is roughly linear in them):

  * every round, each tenant with queued work earns ``quantum_rows × its
    weight`` of row credit (its *deficit* counter);
  * a tenant's FIFO head request is admitted when its credit covers the
    request's rows, and the rows are charged against the credit;
  * credit persists across flushes while the tenant has queued work (and
    resets when its queue drains, per standard DRR), so a GIANT request
    banks credit over several flushes and eventually gets admitted —
    bounded waiting instead of starvation in either direction: small
    tenants keep flowing past the giant, and the giant's turn provably
    arrives after ~rows/(quantum×weight) flushes.

Priority classes sit above the weights: a flush admits strictly from the
highest priority class with queued work before looking at lower ones
(weighted DRR applies WITHIN a class). A request's own ``priority`` tag
wins; tenants can carry a default class in their `TenantPolicy`.

Giant grids that are one single request cannot be split by admission
control (results are per-request atomic) — for those the serving tier
time-slices THROUGH the engine instead, running them group-by-group via
``SweepService.run_job(max_groups=…)`` between flushes (see
`repro_torch.server.daemon.ServeDaemon.submit_job`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.service.scheduler import SweepRequest


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's admission knobs.

    ``weight`` scales the tenant's per-round row credit (2.0 earns twice
    the rows per round of a 1.0 tenant in the same priority class).
    ``priority`` is the tenant's default class for requests that don't tag
    their own (higher drains first).
    """
    weight: float = 1.0
    priority: int = 0

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")


class FairShare:
    """Deficit-round-robin flush selector over tenant-tagged requests.

    ``quantum_rows`` is the per-round credit a weight-1.0 tenant earns;
    ``max_rows_per_flush`` bounds one flush's slice (None = unbounded, in
    which case the selector still orders admission fairly but takes
    everything admissible). The one exception to the bound: if NOTHING has
    been admitted yet and the next request alone exceeds it, that request
    is admitted by itself once its banked credit covers its rows — an
    oversized request gets a dedicated flush rather than waiting forever.

    Instances are thread-safe and meant to be long-lived: the deficit
    counters ARE the fairness state, persisting across flushes.
    """

    def __init__(self, *, quantum_rows: int = 16,
                 max_rows_per_flush: Optional[int] = None,
                 default: TenantPolicy = TenantPolicy()):
        if quantum_rows < 1:
            raise ValueError(f"quantum_rows must be >= 1, got {quantum_rows}")
        if max_rows_per_flush is not None and max_rows_per_flush < 1:
            raise ValueError("max_rows_per_flush must be >= 1 or None, "
                             f"got {max_rows_per_flush}")
        self.quantum_rows = quantum_rows
        self.max_rows_per_flush = max_rows_per_flush
        self._default = default
        self._policies: Dict[str, TenantPolicy] = {}  # guarded-by: _lock
        self._deficit: Dict[str, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    # ------------------------------------------------------------- registry
    def set_tenant(self, name: str, *, weight: Optional[float] = None,
                   priority: Optional[int] = None) -> TenantPolicy:
        """Register / update one tenant's policy; unset fields keep their
        current (or default) value. Unknown tenants get the default policy,
        so registration is optional."""
        with self._lock:
            cur = self._policies.get(name, self._default)
            pol = TenantPolicy(
                weight=cur.weight if weight is None else weight,
                priority=cur.priority if priority is None else priority)
            self._policies[name] = pol
            return pol

    def policy(self, name: str) -> TenantPolicy:
        with self._lock:
            return self._policies.get(name, self._default)

    def deficits(self) -> Dict[str, float]:
        """Current per-tenant banked row credit (the DRR accounting state —
        exposed for the metrics endpoint and the accounting tests)."""
        with self._lock:
            return dict(self._deficit)

    def _class_of(self, req: SweepRequest) -> int:  # holds: _lock
        """A request's own priority tag wins; 0 (the untagged default)
        falls back to the tenant's policy class."""
        if req.priority != 0:
            return req.priority
        return self._policies.get(req.tenant, self._default).priority

    # ------------------------------------------------------------- selector
    def select(self, pending: Sequence[SweepRequest],
               ) -> Tuple[List[SweepRequest], List[SweepRequest]]:
        """Partition the queue into (this flush's slice, still pending).

        Admission order: priority classes high→low; within a class,
        deficit round robin over tenants in first-appearance order, each
        tenant's own requests strictly FIFO.
        """
        with self._lock:
            budget = self.max_rows_per_flush
            take: List[SweepRequest] = []
            taken_rows = 0
            admitted_ids = set()

            by_class: Dict[int, Dict[str, List[SweepRequest]]] = {}
            for req in pending:
                by_class.setdefault(self._class_of(req), {}) \
                    .setdefault(req.tenant, []).append(req)

            for cls in sorted(by_class, reverse=True):
                queues = by_class[cls]
                order = list(queues)             # first-appearance order
                # tenants whose head can no longer fit THIS flush's budget
                # stop earning credit this select (they retry next flush);
                # every loop round either admits a row or blocks a tenant
                # or grows some deficit toward a finite head size, so the
                # rounds terminate
                blocked = set()
                while True:
                    progressed = False
                    for tenant in order:
                        queue = queues[tenant]
                        if not queue or tenant in blocked:
                            continue
                        pol = self._policies.get(tenant, self._default)
                        self._deficit[tenant] = (
                            self._deficit.get(tenant, 0.0)
                            + self.quantum_rows * pol.weight)
                        while queue:
                            head = queue[0]
                            if self._deficit[tenant] < head.rows:
                                break
                            fits = (budget is None
                                    or taken_rows + head.rows <= budget
                                    # oversized escape: alone in its flush
                                    or not take)
                            if not fits:
                                blocked.add(tenant)
                                break
                            queue.pop(0)
                            take.append(head)
                            admitted_ids.add(head.request_id)
                            taken_rows += head.rows
                            self._deficit[tenant] -= head.rows
                            progressed = True
                            if budget is not None and taken_rows >= budget:
                                blocked.update(order)    # budget exhausted
                                break
                        if not queue:
                            # standard DRR: an emptied queue forfeits its
                            # leftover credit (no banking while idle)
                            self._deficit[tenant] = 0.0
                    if not progressed:
                        admissible = [
                            t for t in order
                            if queues[t] and t not in blocked]
                        if not admissible:
                            break
                if budget is not None and taken_rows >= budget:
                    break                        # lower classes wait

            # drop zeroed entries so the deficit map stays bounded by the
            # tenants actually banking credit, not every tag ever seen
            # (tenant strings are arbitrary client input)
            for tenant in [t for t, d in self._deficit.items() if d <= 0.0]:
                del self._deficit[tenant]
            keep = [r for r in pending if r.request_id not in admitted_ids]
            return take, keep

    # a FairShare IS a FlushSelector
    __call__ = select
