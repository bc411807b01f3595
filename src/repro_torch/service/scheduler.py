"""Request coalescing: many clients' sweep specs, one group dispatch.

The port of `repro.service.scheduler`. A sweep service sees many small
requests — different tenants probing the same (engine, M̃, option,
buf_len) group shape with different seeds / steps / τ. Dispatching each
request alone wastes the engine's batching: on the card a fused group's
rows run side by side in one `sweep_epoch` launch per epoch, and a batched
group's rows share each `svrg_update` launch. This module merges
compatible rows ACROSS requests into shared groups before dispatch:

  * every pending request is planned independently (`plan_sweep` — the same
    normalization/resolution a standalone `run_sweep` performs, so what a
    request *means* never depends on its neighbours);
  * rows from all requests are pooled by the same group key the engine
    groups on;
  * each merged group runs ONCE through the persistent runner cache
    (`repro_torch.service.cache`), to the merged members' max epoch budget
    — shorter rows freeze under the masked-epoch semantics;
  * per-row results are demultiplexed back to their requests.

Why a request's demuxed `SweepResult` equals a standalone
``run_sweep(obj, request.epochs, request.specs)``: rows never mix inside
an engine, and a row run past its budget freezes (its iterate passes
through and its last live loss is re-emitted). In fused mode a row of the
sweep-epoch kernel equals itself alone by construction (its margins are
summed in an order fixed by d alone), so the results are equal bit for
bit. In batched mode a row equals itself alone within float64 rounding
(the float64 margin of `objective.sample_grad_stable`), bit for bit on
the CPU; on the card compare them with allclose.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.objective import Objective
from repro_torch.core.sweep import (
    SweepPlan,
    SweepResult,
    SweepSpec,
    _assemble_result,
    _dispatch_group,
    _write_row_history,
    plan_sweep,
)
from repro_torch.obs.trace import tracer as _tracer


@dataclasses.dataclass(frozen=True)
class SweepRequest:
    """One logical client's sweep: its spec rows + its default epoch budget
    (per-row ``SweepSpec.epochs`` overrides ride along unchanged).

    ``tenant``/``priority`` tag the request for admission control — a
    flush selector may slice flushes by them; the numeric path below
    ignores both. ``submitted_at`` is the `time.monotonic()` admission
    stamp the latency metrics read. ``trace_id`` is the
    flight-recorder id `SweepService.submit` minted (empty when tracing
    is off); the dispatch path threads it through so dispatch/demux
    spans land in every owning request's trace."""
    request_id: int
    specs: Tuple[SweepSpec, ...]
    epochs: int
    tenant: str = "default"
    priority: int = 0
    submitted_at: float = 0.0
    trace_id: str = ""

    @property
    def rows(self) -> int:
        return len(self.specs)


# A flush selector partitions the pending queue into (take, keep): `take`
# coalesces into this flush, `keep` stays queued for the next one; `None`
# means take everything.
FlushSelector = Callable[[Tuple[SweepRequest, ...]],
                         Tuple[Sequence[SweepRequest],
                               Sequence[SweepRequest]]]


class _RequestPlan(NamedTuple):
    request: SweepRequest
    plan: SweepPlan
    offset: int                 # this request's first row in the flat batch


class CoalescedBatch(NamedTuple):
    """The merged execution plan for one flush.

    ``specs``/``resolved`` are the requests' normalized rows concatenated in
    admission order; ``groups`` pools flat row indices by the engine's
    group key, ACROSS requests. The group key leads with the objective
    fingerprint, so requests targeting DIFFERENT objectives coalesce in
    one flush without ever sharing a dispatch;
    ``objectives`` maps each fingerprint to its resolved instance.
    """
    request_plans: Tuple[_RequestPlan, ...]
    specs: tuple
    resolved: tuple
    groups: Dict[tuple, List[int]]
    objectives: Dict[int, Objective]

    def group_epochs(self, key: tuple) -> int:
        """A merged group's epoch bound: max over ALL pooled rows."""
        return max(self.resolved[c].epochs for c in self.groups[key])


class DispatchInfo(NamedTuple):
    """What one flush did, for `ServiceStats` accounting."""
    groups_dispatched: int
    rows_dispatched: int
    rows_coalesced: int      # rows that shared a group with another request
    groups_merged: int       # groups holding rows from >1 request
    rows_diverged: int = 0   # rows the divergence watchdog flagged


def coalesce(obj: Optional[Objective],
             requests: Sequence[SweepRequest]) -> CoalescedBatch:
    """Plan every request independently, then pool rows by group key.

    ``obj`` backs specs with ``objective=""``; requests whose specs name a
    registered objective resolve through the registry exactly as a
    standalone `run_sweep` would (and ``obj`` may then be None)."""
    if not requests:
        raise ValueError("nothing to coalesce: no pending requests")
    request_plans: List[_RequestPlan] = []
    specs: list = []
    resolved: list = []
    groups: Dict[tuple, List[int]] = {}
    objectives: Dict[int, Objective] = {}
    offset = 0
    for req in requests:
        plan = plan_sweep(obj, req.epochs, req.specs)
        request_plans.append(_RequestPlan(req, plan, offset))
        objectives[plan.objective.fingerprint()] = plan.objective
        for key, members in plan.groups.items():
            groups.setdefault(key, []).extend(offset + c for c in members)
        specs.extend(plan.specs)
        resolved.extend(plan.resolved)
        offset += len(plan.specs)
    return CoalescedBatch(request_plans=tuple(request_plans),
                          specs=tuple(specs), resolved=tuple(resolved),
                          groups=groups, objectives=objectives)


def dispatch(obj: Optional[Objective], batch: CoalescedBatch, *, w0=None,
             drop_prob: float = 0.02, mesh=None,
             watchdog=None,
             ) -> Tuple[Dict[int, SweepResult], DispatchInfo]:
    """Run every merged group once, demux per-request `SweepResult`s.

    Returns ``({request_id: result}, DispatchInfo)``; each result equals
    a standalone `run_sweep` of that request's specs with the same
    ``w0``/``drop_prob``/``mesh`` (see the module docstring for how
    exactly). ``mesh`` is an active mesh (`core.sweep._active_mesh`) or
    None; under one every group is row-sharded over its ``data`` axis and
    the call is collective.
    Each group dispatches at its natural row count: the port's runners
    take any count without a new runner, so the JAX package's
    width-padding policy has nothing to save here.

    Each group dispatches with ITS objective (``batch.objectives``); ``w0``
    (flat or pytree) must fit every dispatched objective — leave it None
    for a mixed-objective flush (each starts from its own `init_flat`).

    ``watchdog`` (a `repro_torch.obs.watchdog.Watchdog`) inspects each
    group's returned histories; a diverging row is handled per its OWNING
    request's tenant policy. A coalesced flush mixes tenants, so the
    ``cancel_job`` policy degrades to ``cancel_row`` here (one tenant's
    divergence must never cancel another's rows); the re-dispatch a
    cancel triggers reuses the cached runner, and
    surviving rows keep their first-dispatch outputs.
    """
    specs, resolved = batch.specs, batch.resolved
    w_inits = {ofp: (o.init_flat() if w0 is None else o.as_flat(w0))
               for ofp, o in batch.objectives.items()}
    offsets = [rp.offset for rp in batch.request_plans]

    tr = _tracer()

    def _member_tids(members: Sequence[int]) -> Tuple[str, ...]:
        """The owning requests' trace ids for a group's flat row indices
        (deduped by span_all; all-empty when tracing is off)."""
        if not tr.enabled:
            return ()
        return tuple(
            batch.request_plans[bisect.bisect_right(offsets, c) - 1]
            .request.trace_id for c in members)

    # per-request output buffers at the REQUEST's own history width (its
    # rows' max epoch budget) and ITS objective's flat dim, exactly like a
    # standalone run_sweep
    buffers = []
    for rp in batch.request_plans:
        e_rows = np.asarray([r.epochs for r in rp.plan.resolved], np.int64)
        width = int(e_rows.max()) + 1
        buffers.append((np.zeros((len(rp.plan.specs), width), np.float32),
                        np.zeros((len(rp.plan.specs),
                                  rp.plan.objective.flat_dim), np.float32),
                        e_rows))

    rows_coalesced = 0
    groups_merged = 0
    diverged_flat: Dict[int, int] = {}   # flat row -> last trusted epoch
    epoch_overrides: Dict[int, int] = {}  # flat row -> truncated budget
    for key_, members in batch.groups.items():
        member_tids = _member_tids(members)
        group_epochs = batch.group_epochs(key_)
        group_obj = batch.objectives[key_[0]]
        with tr.span_all(member_tids, "dispatch", parent_name="coalesce",
                         group_rows=len(members),
                         group_epochs=int(group_epochs)):
            hist, w_fin = _dispatch_group(group_obj, specs, resolved,
                                          members, key_, group_epochs,
                                          w_inits[key_[0]], drop_prob, mesh)
        if watchdog is not None:
            from repro_torch.obs.watchdog import enforce_group

            hist, w_fin, bad, overrides = enforce_group(
                watchdog, hist, w_fin, members=members,
                resolved=resolved,
                tenant_of=lambda c: batch.request_plans[
                    bisect.bisect_right(offsets, c) - 1].request.tenant,
                redispatch=lambda amended: _dispatch_group(
                    group_obj, specs, amended, members, key_,
                    group_epochs, w_inits[key_[0]], drop_prob, mesh),
                allow_cancel_job=False)
            diverged_flat.update(bad)
            epoch_overrides.update(overrides)
        owners = {bisect.bisect_right(offsets, c) - 1 for c in members}
        if len(owners) > 1:
            groups_merged += 1
            rows_coalesced += len(members)
        for row, c in enumerate(members):
            ri = bisect.bisect_right(offsets, c) - 1
            local = c - offsets[ri]
            hists, finals, _ = buffers[ri]
            # the merged bound may exceed (or undercut) the request's own
            # history width; _write_row_history trims/pads bit-exactly
            _write_row_history(hists[local], hist[row], group_epochs)
            finals[local] = w_fin[row]

    results: Dict[int, SweepResult] = {}
    all_tids = tuple(rp.request.trace_id for rp in batch.request_plans) \
        if tr.enabled else ()
    with tr.span_all(all_tids, "demux", parent_name="coalesce"):
        for rp, (hists, finals, _) in zip(batch.request_plans, buffers):
            res_rows = rp.plan.resolved
            req_diverged = None
            if diverged_flat:
                n = len(rp.plan.specs)
                req_diverged = {c - rp.offset: e
                                for c, e in diverged_flat.items()
                                if rp.offset <= c < rp.offset + n}
                if any(rp.offset <= c < rp.offset + n
                       for c in epoch_overrides):
                    res_rows = list(res_rows)
                    for c, k in epoch_overrides.items():
                        if rp.offset <= c < rp.offset + n:
                            local = c - rp.offset
                            res_rows[local] = \
                                res_rows[local]._replace(epochs=k)
            results[rp.request.request_id] = _assemble_result(
                rp.plan.specs, res_rows, hists, finals,
                param_shapes=rp.plan.objective.param_shapes(),
                w_init=w_inits[rp.plan.objective.fingerprint()],
                diverged=req_diverged)

    info = DispatchInfo(groups_dispatched=len(batch.groups),
                        rows_dispatched=len(specs),
                        rows_coalesced=rows_coalesced,
                        groups_merged=groups_merged,
                        rows_diverged=len(diverged_flat))
    return results, info
