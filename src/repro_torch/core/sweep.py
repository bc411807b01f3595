"""Multi-algorithm sweep engine: the experiment grid as batched rows.

The port of `repro.core.sweep`. The paper's tables and figures compare
AsySVRG vs Hogwild! vs serial SVRG over (reading scheme × thread count ×
step size × seed × τ). Every configuration becomes a row of a group; a
group runs as ONE batched engine over a ``[C, d]`` iterate block with the
row's τ, scheme, delay kind, step size and epoch budget as data.

**Engine modes.** ``SweepSpec.engine_mode`` picks how a group runs:

  * ``"vmap"`` — the batched-rows engine (`asysvrg._asysvrg_epochs_core` /
    `hogwild._hogwild_epochs_core`): each inner update is one
    ``svrg_update`` launch for all C rows and each snapshot one
    ``logreg_grad`` launch;
  * ``"fused"`` — the sweep-epoch kernel
    (`repro_torch.kernels.sweep_epoch`): per epoch one ``logreg_grad``
    launch for the rows' snapshots (AsySVRG groups) and ONE
    ``sweep_epoch`` launch for every inner update of every row.
    `LogisticRegression` and `NonconvexLogistic` (the kernels take the L2
    or the clipped penalty); an `MLPObjective` group runs on its own
    kernel (`repro_torch.kernels.sweep_epoch_mlp`): per epoch one launch
    for the rows' snapshots (AsySVRG groups) and one for every inner update
    of every row, its per-sample forward and backward inside the update
    chain. Another objective raises.

``""`` inherits `default_engine_mode()`: ``$REPRO_SWEEP_ENGINE``, else
"vmap", as in the JAX package.

**Config-row sharding.** When a mesh with a ``data`` axis is active —
passed as ``run_sweep(..., mesh=...)`` or installed ambiently with
`repro_torch.sharding.context.mesh_context` (`repro_torch.launch.mesh.
make_sweep_mesh` / `make_production_mesh`) — each group's rows are padded
to a multiple of the ``data`` size by repeating row 0, rank r runs rows
``[r·C/W, (r+1)·C/W)`` through the same engine, and the row-leading
outputs are all-gathered, so every rank gets the whole result and the
padding rows are dropped. Under a mesh `run_sweep` is a collective call:
every rank of the mesh calls it with the same arguments. No collective
crosses rows inside the engine, so a sharded row equals the unsharded row
(bit for bit on the CPU). Without a mesh, or with a 1-sized ``data`` axis,
the unsharded path runs.

**Masked per-row epochs.** ``SweepSpec.epochs`` (0 = inherit `run_sweep`'s
``epochs`` argument) lets rows of one call run different budgets: the group
runs to its members' max and finished rows freeze, so a row with
``epochs=E`` equals an independent E-epoch run.

The ``algo`` axis selects the epoch engine per row:

  * ``"asysvrg"`` — Algorithm 1 (SVRG control variate under bounded-delay
    reads);
  * ``"hogwild"`` — the baseline, same read semantics, no control variate,
    γ ← decay·γ per epoch;
  * ``"svrg"`` — serial SVRG as the zero-delay degenerate case of the
    asysvrg engine (τ=0, zero delays, consistent reads). svrg specs are
    NORMALIZED on entry: ``tau != 0`` raises, and ``scheme``/``delay_kind``
    are rewritten to what executes.

Grouping: specs are grouped by (objective fingerprint, engine, M̃, option,
buf_len, fused), all pinned per row, so a row's group never depends on the
other rows of the sweep — the same group key as the JAX package. Rows never
mix inside the engine, so a row's results do not depend on the rows it is
batched with (bit for bit on the CPU).

Every group runs through the persistent runner cache
(`repro_torch.service.cache`), which the service's scheduler shares, and
each runner call is bracketed on the host by the tracer's ``execute`` span
and the performance ledger (`repro_torch.obs`), both opt-in.

Fused mode raises `NotImplementedError` for an objective no kernel
computes. It does not fall back to another path.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import prng
from repro_torch.config import SVRGConfig
from repro_torch.core.asysvrg import (
    DELAY_IDS,
    SCHEME_IDS,
    _asysvrg_epochs_core,
    _masked_epochs,
    _resolve_steps,
)
from repro_torch.core.hogwild import _hogwild_epochs_core, _resolve_hogwild_steps
from repro_torch.core.objective import (LogisticRegression, Objective,
                                        get_objective, params_from_flat)
from repro_torch.core.objectives import MLPObjective, NonconvexLogistic
from repro_torch.kernels.dispatch import mode_tags
from repro_torch.kernels.sweep_epoch import sweep_epoch
from repro_torch.kernels.sweep_epoch_mlp import (mlp_full_grad, mlp_loss,
                                                 sweep_epoch_mlp)
from repro_torch.obs import ledger as _ledger
from repro_torch.obs.trace import tracer as _tracer
from repro_torch.sharding.context import all_gather, current_mesh
from repro_torch.sharding.rules import mesh_shape

ALGOS = ("asysvrg", "hogwild", "svrg")
# svrg rows run on the asysvrg engine (τ=0 degenerate case), so two engines
_ENGINE_ASYSVRG = "asysvrg"
_ENGINE_HOGWILD = "hogwild"
ENGINE_MODES = ("vmap", "fused")
_DATA_AXIS = "data"
_ENGINE_MODE_ENV = "REPRO_SWEEP_ENGINE"


def default_engine_mode() -> str:
    """The engine mode specs with ``engine_mode=""`` resolve to:
    ``$REPRO_SWEEP_ENGINE`` when set (validated), else "vmap"."""
    mode = os.environ.get(_ENGINE_MODE_ENV, "").strip().lower()
    if mode and mode not in ENGINE_MODES:
        raise ValueError(
            f"{_ENGINE_MODE_ENV}={mode!r} — expected one of {ENGINE_MODES}")
    return mode or "vmap"


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One grid cell: the knobs Tables 2–3 / Fig. 1 vary.

    ``algo`` picks the epoch engine ("asysvrg" / "hogwild" / "svrg").
    τ conventions follow each algorithm's sequential driver:
      * asysvrg: ``tau=0`` means "derive τ = p−1" (SVRGConfig convention);
        ``num_threads``/``inner_steps`` fix M̃ = pM exactly as SVRGConfig.
      * hogwild: ``tau=-1`` derives τ = p−1 and ``tau=0`` is genuinely zero
        delay (`run_hogwild` convention); M̃ = (n // p)·p.
      * svrg: τ MUST be 0 (anything else raises) and reads execute
        consistent with zero delays; M̃ = ``inner_steps`` or 2n.
    ``decay`` is the per-epoch γ ← decay·γ factor (hogwild only).
    ``epochs`` is this row's outer-epoch budget; 0 inherits `run_sweep`'s
    ``epochs`` argument.
    ``objective`` optionally names a REGISTERED objective; "" means the
    objective the call passes in. All rows of one plan resolve to ONE
    objective.
    ``engine_mode``: "vmap" (the batched-rows engine), "fused" (the
    sweep-epoch kernel, `repro_torch.kernels.sweep_epoch`), or "" for
    `default_engine_mode()`. The mode joins the group key, so fused and
    vmap rows never share a group.
    ``telemetry`` opts the row into `repro_torch.obs.telemetry` series
    (realized staleness, update norms) on its `SweepResult`: reporting
    computed on the host from already-returned arrays, absent from the
    group key, so it never changes a row's numbers.
    """
    seed: int = 0
    scheme: str = "inconsistent"
    step_size: float = 0.1
    tau: int = 0
    delay_kind: str = "fixed"
    num_threads: int = 8
    inner_steps: int = 0
    option: int = 2
    algo: str = "asysvrg"
    decay: float = 0.9
    epochs: int = 0
    objective: str = ""
    engine_mode: str = ""
    telemetry: bool = False

    def to_config(self) -> SVRGConfig:
        return SVRGConfig(scheme=self.scheme, step_size=self.step_size,
                          num_threads=self.num_threads, tau=self.tau,
                          inner_steps=self.inner_steps, option=self.option)


class SweepResult(NamedTuple):
    """Row-aligned sweep outputs (numpy).

    ``specs`` are the NORMALIZED specs describing what executed.
    ``histories``/``effective_passes`` have the GLOBAL max-epochs width;
    rows with a shorter budget are frozen past their own epoch count — use
    :meth:`curve` for a row trimmed to its own budget.
    ``telemetry`` (a `repro_torch.obs.telemetry.SweepTelemetry`, None
    unless a spec opted in) carries realized-staleness / update-norm
    series derived from the arrays above.
    ``diverged_rows`` (None unless a watchdog ran and flagged something)
    holds, per row, -1 for healthy or the last trusted epoch for a row the
    `repro_torch.obs.watchdog` detected diverging; under ``cancel_row``
    that is also the epoch the row was frozen at (``epochs_per_row``
    reflects it).
    """
    specs: Tuple[SweepSpec, ...]
    histories: np.ndarray         # [C, max_epochs+1] loss after each epoch
    effective_passes: np.ndarray  # [C, max_epochs+1] cumulative eff. passes
    final_w: np.ndarray           # [C, flat_dim] FLAT final iterates
    total_updates: np.ndarray     # [C] updates applied over all row epochs
    epochs_per_row: np.ndarray    # [C] each row's executed epoch budget
    param_shapes: Tuple = ()      # objective's ((path, shape, dtype), ...)
    telemetry: Optional[object] = None  # SweepTelemetry when a row opted in
    diverged_rows: Optional[np.ndarray] = None  # [C] -1 or last trusted epoch

    def curve(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """(effective_passes, loss history) trimmed to row c's own budget."""
        e = int(self.epochs_per_row[c])
        return self.effective_passes[c, :e + 1], self.histories[c, :e + 1]

    def final_params(self, c: int):
        """Row c's final iterate in the objective's PYTREE form (numpy),
        rebuilt exactly from the flat row via the recorded ``param_shapes``
        (flat-vector objectives get the row back unchanged)."""
        if not self.param_shapes:
            return self.final_w[c]
        return params_from_flat(self.final_w[c], self.param_shapes)

    def row(self, c: int) -> Dict:
        """One config as a flat record (for CSV-ish reporting)."""
        s = self.specs[c]
        passes, hist = self.curve(c)
        return {**dataclasses.asdict(s),
                "history": hist,
                "effective_passes": passes,
                "total_updates": int(self.total_updates[c])}


def make_grid(schemes: Sequence[str] = ("consistent", "inconsistent", "unlock"),
              seeds: Sequence[int] = (0,),
              step_sizes: Sequence[float] = (0.1,),
              taus: Sequence[int] = (0,),
              delay_kinds: Sequence[str] = ("fixed",),
              num_threads: int = 8,
              inner_steps: int = 0,
              option: int = 2,
              algo: str = "asysvrg",
              decay: float = 0.9,
              epochs: int = 0,
              objective: str = "") -> List[SweepSpec]:
    """Cartesian grid over the paper's experiment axes, outermost-first.

    The ``taus`` axis uses ONE convention for every algo: 0 means "derive
    τ = p−1". For hogwild rows that becomes the driver's ``-1`` sentinel.
    """
    if algo == "hogwild":
        taus = [-1 if t == 0 else t for t in taus]
    return [
        SweepSpec(seed=seed, scheme=scheme, step_size=step, tau=tau,
                  delay_kind=kind, num_threads=num_threads,
                  inner_steps=inner_steps, option=option, algo=algo,
                  decay=decay, epochs=epochs, objective=objective)
        for scheme in schemes
        for seed in seeds
        for step in step_sizes
        for tau in taus
        for kind in delay_kinds
    ]


class _Resolved(NamedTuple):
    engine: str          # "asysvrg" | "hogwild" (svrg routes to asysvrg)
    total: int           # M̃, the inner-loop length
    tau: int
    scheme_id: int
    delay_id: int
    option: int          # 0 for hogwild (engine has no option switch)
    passes_per_epoch: float  # repro-lint: ignore[RL004] derived from engine+total+n (all keyed); pass-count accounting only
    buf_len: int         # ring-buffer length, pinned per-row (see _resolve)
    epochs: int          # this row's outer-epoch budget
    fused: bool          # the sweep-epoch kernel path (engine_mode "fused")


def _row_buf_len(tau: int, num_threads: int, total: int) -> int:
    """Ring-buffer length from the ROW's own fields (never the group's):
    ≥ τ+1 and padded up to the thread count, so a grid varying τ at one
    thread count shares one group. Slot arithmetic uses the row's τ, so
    the padding only moves shapes, never values."""
    return min(max(tau + 1, max(1, num_threads)), max(1, total))


def _normalize_spec(spec: SweepSpec) -> SweepSpec:
    """Entry normalization: reject contradictions and options this slice
    does not run, rewrite svrg to what runs."""
    if spec.algo not in ALGOS:
        raise ValueError(f"unknown algo {spec.algo!r}")
    if spec.scheme not in SCHEME_IDS:
        raise ValueError(f"unknown scheme {spec.scheme!r}")
    if spec.delay_kind not in DELAY_IDS:
        raise ValueError(f"unknown delay schedule {spec.delay_kind!r}")
    if spec.epochs < 0:
        raise ValueError(f"epochs must be >= 0 (0 = inherit), got {spec.epochs}")
    if spec.engine_mode and spec.engine_mode not in ENGINE_MODES:
        raise ValueError(
            f"unknown engine_mode {spec.engine_mode!r} "
            f"(expected one of {ENGINE_MODES}, or '' to inherit)")
    if spec.algo == "svrg":
        if spec.tau != 0:
            raise ValueError(
                f"algo='svrg' is the τ=0 degenerate case; tau={spec.tau} "
                "contradicts it — use algo='asysvrg' for τ>0")
        return dataclasses.replace(spec, scheme="consistent",
                                   delay_kind="zero")
    return spec


def _resolve(obj: Objective, spec: SweepSpec,
             default_epochs: int) -> _Resolved:
    """Per-spec resolution, delegating to each algorithm's own arithmetic.
    Raises for non-positive resolved totals."""
    epochs = spec.epochs or default_epochs
    if epochs < 1:
        raise ValueError(f"resolved epochs must be >= 1, got {epochs}")
    fused = (spec.engine_mode or default_engine_mode()) == "fused"

    if spec.algo == "hogwild":
        _, total, tau = _resolve_hogwild_steps(obj.n, spec.num_threads,
                                               spec.tau)
        delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[spec.delay_kind]
        res = _Resolved(_ENGINE_HOGWILD, total, tau,
                        SCHEME_IDS[spec.scheme], delay_id, 0, 1.0,
                        _row_buf_len(tau, spec.num_threads, total), epochs,
                        fused)
    elif spec.algo == "svrg":
        # the zero-delay degenerate case on the asysvrg engine (paper §3)
        total = spec.inner_steps or 2 * obj.n
        res = _Resolved(_ENGINE_ASYSVRG, total, 0,
                        SCHEME_IDS["consistent"], DELAY_IDS["zero"],
                        spec.option, 1.0 + total / obj.n,
                        _row_buf_len(0, spec.num_threads, total), epochs,
                        fused)
    else:
        _, _, total, tau = _resolve_steps(obj, spec.to_config())
        delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[spec.delay_kind]
        res = _Resolved(_ENGINE_ASYSVRG, total, tau, SCHEME_IDS[spec.scheme],
                        delay_id, spec.option, 1.0 + total / obj.n,
                        _row_buf_len(tau, spec.num_threads, total), epochs,
                        fused)
    if res.total < 1:
        raise ValueError(
            f"resolved inner-step count M̃ must be >= 1, got {res.total} "
            f"(inner_steps={spec.inner_steps}) for {spec}")
    return res


def _executed_spec(spec: SweepSpec, r: _Resolved) -> SweepSpec:
    """Rewrite convention sentinels to resolved values: the spec a
    `SweepResult` carries describes exactly what executed."""
    delay = "zero" if r.delay_id == DELAY_IDS["zero"] else spec.delay_kind
    return dataclasses.replace(spec, tau=r.tau, delay_kind=delay,
                               epochs=r.epochs,
                               engine_mode="fused" if r.fused else "vmap")


def _logistic_epoch(obj: Objective, data, w, svrg: bool, rows, kw):
    """One fused epoch of a logistic group, data ``(X, y, *penalty)``: K2
    for μ (the objective's full gradient), then K3."""
    X, y, *reg = data
    mu = obj.flat_full_grad(data, w) if svrg else None
    return sweep_epoch(X, y, tuple(reg), w, mu, *rows, **kw)


def _mlp_epoch(obj: MLPObjective, data, w, svrg: bool, rows, kw):
    """One fused epoch of an MLP group, data ``(tokens, targets)``:
    ``sweep_epoch_mlp``'s full-gradient entry for μ, then its epoch
    entry."""
    mu = mlp_full_grad(*data, w, obj.kernel_widths)[0] if svrg else None
    return sweep_epoch_mlp(*data, w, mu, *rows, widths=obj.kernel_widths,
                           **kw)


def _mlp_loss0(obj: MLPObjective, data, w0):
    return mlp_loss(*data, w0, obj.kernel_widths)


# the objectives whose math the fused kernels compute: each one's epoch
# launches and its starting loss's launch (None: the objective's own loss)
_FUSED_OBJECTIVES = {LogisticRegression: (_logistic_epoch, None),
                     NonconvexLogistic: (_logistic_epoch, None),
                     MLPObjective: (_mlp_epoch, _mlp_loss0)}

# (objective fingerprint, engine, M̃, option, buf_len, fused)
_GroupKey = Tuple[int, str, int, int, int, bool]


class SweepPlan(NamedTuple):
    """Static execution plan: which rows run together, with which bounds."""
    specs: Tuple[SweepSpec, ...]          # normalized, executed-semantics
    resolved: Tuple[_Resolved, ...]
    groups: Dict[_GroupKey, List[int]]    # group key -> member row indices
    objective: Objective                  # the ONE objective every row runs

    def group_epochs(self, key: _GroupKey) -> int:
        """A group's epoch bound: max member epoch budget."""
        return max(self.resolved[c].epochs for c in self.groups[key])


def _resolve_objective(obj: Optional[Objective],
                       specs: Sequence[SweepSpec]) -> Objective:
    """The plan's single objective: named specs resolve via the registry,
    "" means the caller's ``obj``; mixing objectives in one plan raises."""
    names = {s.objective for s in specs}
    resolved: Dict[str, Objective] = {}
    for name in sorted(names - {""}):
        resolved[name] = get_objective(name)
    if "" in names:
        if obj is None:
            raise ValueError(
                "specs with objective='' need an explicit objective argument")
        resolved[""] = obj
    fps = {o.fingerprint() for o in resolved.values()}
    if len(fps) > 1:
        raise ValueError(
            f"one sweep, one objective: specs name {sorted(names)} which "
            "resolve to different objectives — submit separate sweeps")
    return next(iter(resolved.values()))


def plan_sweep(obj: Optional[Objective], epochs: int,
               specs: Sequence[SweepSpec]) -> SweepPlan:
    """Normalize + resolve specs and group them by engine shape. ``obj``
    may be None when every spec names a registered objective."""
    specs = tuple(_normalize_spec(s) for s in specs)
    if not specs:
        raise ValueError("empty sweep")
    obj = _resolve_objective(obj, specs)
    ofp = obj.fingerprint()
    resolved = tuple(_resolve(obj, s, epochs) for s in specs)
    if any(r.fused for r in resolved) and type(obj) not in _FUSED_OBJECTIVES:
        raise NotImplementedError(
            f"engine_mode='fused' runs LogisticRegression, "
            f"NonconvexLogistic and MLPObjective, not {type(obj).__name__}: "
            "the sweep-epoch kernels compute the logistic sample gradient "
            "with an L2 or a clipped penalty and the MLP's, and another "
            "objective's per-sample gradient inside their update chain is "
            "not ported — use engine_mode='vmap'")
    specs = tuple(_executed_spec(s, r) for s, r in zip(specs, resolved))
    groups: Dict[_GroupKey, List[int]] = {}
    for c, r in enumerate(resolved):
        groups.setdefault(
            (ofp, r.engine, r.total, r.option, r.buf_len, r.fused),
            []).append(c)
    return SweepPlan(specs=specs, resolved=resolved, groups=groups,
                     objective=obj)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a `DeviceMesh` with named dims."""
    if mesh is not None and not (isinstance(mesh, DeviceMesh)
                                 and mesh.mesh_dim_names):
        raise TypeError(
            "a sweep mesh is a torch.distributed DeviceMesh with named dims "
            f"(repro_torch.launch.mesh), got {type(mesh).__name__}")


def _active_mesh(mesh: Optional[DeviceMesh]) -> Optional[DeviceMesh]:
    """The mesh whose `data` axis shards the config-row axis, if any.

    Explicit ``mesh=`` wins; otherwise the ambient `mesh_context` mesh is
    picked up, so a launcher that installed a mesh shards its sweeps with
    no call-site changes. A mesh without a >1-sized ``data`` axis degrades
    to the unsharded path."""
    if mesh is None:
        mesh = current_mesh()
    check_mesh(mesh)
    if mesh is None or mesh_shape(mesh).get(_DATA_AXIS, 1) <= 1:
        return None
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the sweep mesh "
                         f"{mesh}: every rank that calls run_sweep under a "
                         "mesh must be one of its ranks")
    return mesh


def _pad_rows(args: Tuple, pad: int) -> Tuple:
    """Pad each row-leading argument (a tensor or a list) by repeating row 0
    (a valid config: padding rows compute real, discarded work)."""
    if pad == 0:
        return args
    return tuple(torch.cat([a] + [a[:1]] * pad) if isinstance(a, torch.Tensor)
                 else list(a) + list(a[:1]) * pad for a in args)


def _shard_group_fn(fn, mesh: DeviceMesh, num_data: int):
    """Row-shard a group body over the mesh's `data` axis: the objective's
    data arguments go whole to every rank, rank r runs rows
    ``[r·C/W, (r+1)·C/W)`` of every row argument (C already a multiple of
    W, `_pad_rows`), and the two row-leading outputs are all-gathered.

    Each rank runs the same engine over its row block and NO collective
    crosses rows, which is why sharded rows equal the unsharded path's.
    Mesh axes other than `data` (`model` in the production mesh) run the
    same rows redundantly. `_dispatch_group` wraps the cache's unsharded
    runner at every sharded dispatch, so the runner cache keys no mesh and
    holds no process group: one runner serves every mesh and every world."""
    group = mesh.get_group(_DATA_AXIS)
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def sharded(*all_args):
        data, rows = all_args[:num_data], all_args[num_data:]
        per = len(rows[-1]) // world
        mine = tuple(a[rank * per:(rank + 1) * per] for a in rows)
        return tuple(torch.cat(all_gather(out, group))
                     for out in fn(*data, *mine))

    return sharded


def _asysvrg_group_fn(obj: Objective, num_data: int, epochs: int, total: int,
                      buf_len: int, option: int, drop_prob: float):
    """The batched asysvrg/svrg engine for one group: called with the data
    tuple and the row arguments, returns (w_fin [C, d], hist [C, E+1])."""

    def group(*all_args):
        data = all_args[:num_data]
        keys, etas, taus, scheme_ids, delay_ids, row_epochs, w0_rows = \
            all_args[num_data:]
        return _asysvrg_epochs_core(
            obj, data, w0_rows, keys, etas, taus, scheme_ids, delay_ids,
            epochs=epochs, total=total, buf_len=buf_len, option=option,
            drop_prob=drop_prob, row_epochs=row_epochs)

    return group


def _hogwild_group_fn(obj: Objective, num_data: int, epochs: int, total: int,
                      buf_len: int, drop_prob: float):
    """The batched Hogwild! engine for one group (see `_asysvrg_group_fn`)."""

    def group(*all_args):
        data = all_args[:num_data]
        (keys, gammas, decays, taus, scheme_ids, delay_ids, row_epochs,
         w0_rows) = all_args[num_data:]
        return _hogwild_epochs_core(
            obj, data, w0_rows, keys, gammas, decays, taus, scheme_ids,
            delay_ids, epochs=epochs, total=total, buf_len=buf_len,
            drop_prob=drop_prob, row_epochs=row_epochs)

    return group


def _fused_group_fn(obj: Objective, num_data: int, *, engine: str,
                    epochs: int, total: int, buf_len: int, option: int,
                    drop_prob: float):
    """The fused engine for one group (see `_asysvrg_group_fn`): each epoch
    is the objective's launches in `_FUSED_OBJECTIVES`, over the rows still
    live. Epochs and per-row budgets run through
    `core.asysvrg._masked_epochs`, each epoch's losses come from the
    epoch's launch; Hogwild! rows decay γ ← decay·γ after each live
    epoch, in float32."""
    hogwild = engine == _ENGINE_HOGWILD
    run_epoch, start_loss = _FUSED_OBJECTIVES[type(obj)]
    kw = dict(engine=engine, total=total, buf_len=buf_len, option=option,
              drop_prob=drop_prob)

    def group(*all_args):
        data = all_args[:num_data]
        if hogwild:
            (keys, gammas, decays, taus, scheme_ids, delay_ids, row_epochs,
             w0_rows) = all_args[num_data:]
            steps = gammas.clone()
        else:
            keys, steps, taus, scheme_ids, delay_ids, row_epochs, w0_rows = \
                all_args[num_data:]

        def epoch(live, w, sub):
            sel = torch.tensor(live, device=w.device)
            rows = (sub, steps[sel], [taus[c] for c in live],
                    [scheme_ids[c] for c in live], [delay_ids[c] for c in live])
            w_new, loss = run_epoch(obj, data, w, not hogwild, rows, kw)
            if hogwild:
                steps[sel] = steps[sel] * decays[sel]
            return w_new, loss

        loss0 = None if start_loss is None else start_loss(obj, data, w0_rows)
        return _masked_epochs(obj, data, w0_rows, keys, epochs=epochs,
                              row_epochs=row_epochs, epoch=epoch, loss0=loss0)

    return group


def _group_fn(engine: str, *, obj: Objective, num_data: int, epochs: int,
              total: int, buf_len: int, option: int, drop_prob: float,
              fused: bool):
    """The group body for an engine and mode; `repro_torch.service.cache`
    builds each at most once per key. The body closes over ``obj``'s
    methods only: the data and every per-row value are call arguments."""
    if fused:
        return _fused_group_fn(obj, num_data, engine=engine, epochs=epochs,
                               total=total, buf_len=buf_len, option=option,
                               drop_prob=drop_prob)
    if engine == _ENGINE_HOGWILD:
        return _hogwild_group_fn(obj, num_data, epochs, total, buf_len,
                                 drop_prob)
    return _asysvrg_group_fn(obj, num_data, epochs, total, buf_len, option,
                             drop_prob)


def _accumulate_passes(ppe: Sequence[float], epochs_per_row: np.ndarray,
                       max_epochs: int) -> np.ndarray:
    """[C, max_epochs+1] cumulative effective passes (float64 running sum in
    the sequential drivers' order; frozen rows add 0.0)."""
    ppe_col = np.asarray(ppe, np.float64)[:, None]
    live = np.arange(max_epochs)[None, :] < np.asarray(epochs_per_row)[:, None]
    out = np.zeros((len(epochs_per_row), max_epochs + 1), np.float64)
    out[:, 1:] = np.cumsum(np.where(live, ppe_col, 0.0), axis=1)
    return out


def _write_row_history(dst_row: np.ndarray, hist_row: np.ndarray,
                       group_epochs: int) -> None:
    """Demux ONE row's group-width history into a destination row of any
    width: beyond a row's own budget every entry is the frozen last live
    loss, so trimming and re-emitting the tail are both exact."""
    width = dst_row.shape[0]
    if width <= group_epochs + 1:
        dst_row[:] = hist_row[:width]
    else:
        dst_row[:group_epochs + 1] = hist_row
        dst_row[group_epochs + 1:] = hist_row[-1]


def _dispatch_group(obj: Objective, specs: Sequence[SweepSpec],
                    resolved: Sequence[_Resolved], members: Sequence[int],
                    key_: _GroupKey, group_epochs: int, w_init,
                    drop_prob: float, mesh: Optional[DeviceMesh]):
    """Run ONE group on the objective's device through the persistent
    runner cache; returns (histories [rows, group_epochs+1], final_w
    [rows, flat_dim]) as numpy, padding rows already sliced off.

    ``mesh`` (an active mesh, `_active_mesh`, or None) row-shards the
    group: the rows are padded to a multiple of the ``data`` size and the
    cache's runner is wrapped by `_shard_group_fn`, whose all-gather of
    the outputs sits inside the bracket below like the copy to the host.

    ``specs``/``resolved`` are row-aligned sequences indexed by ``members``
    — `run_sweep` passes a single plan's rows, the service scheduler a
    coalesced multi-request batch. The runner comes from
    `repro_torch.service.cache` (imported here: the service layer builds on
    this module), so every caller shares one runner per key.

    The tracer's ``execute`` span and the ledger's clock bracket the
    runner call AND the copy of its results to the host. A call on the
    card returns once its launches are queued; the copy waits for them,
    so the bracket covers the device's work, and the ledger's ``wall_s``
    is the group's time end to end, not the launches' enqueue.
    """
    from repro_torch.service.cache import get_group_runner

    _, engine, total, option, buf_len, fused = key_
    device = w_init.device
    f32 = dict(dtype=torch.float32, device=device)
    keys = prng.keys_from_seeds([specs[c].seed for c in members], device)
    etas = torch.tensor([specs[c].step_size for c in members], **f32)
    taus = [resolved[c].tau for c in members]
    scheme_ids = [resolved[c].scheme_id for c in members]
    delay_ids = [resolved[c].delay_id for c in members]
    row_epochs = [resolved[c].epochs for c in members]
    w0_rows = w_init[None, :].repeat(len(members), 1)

    if engine == _ENGINE_HOGWILD:
        decays = torch.tensor([specs[c].decay for c in members], **f32)
        args = (keys, etas, decays, taus, scheme_ids, delay_ids, row_epochs,
                w0_rows)
    else:
        args = (keys, etas, taus, scheme_ids, delay_ids, row_epochs, w0_rows)

    runner = get_group_runner(engine, group_epochs=group_epochs, total=total,
                              option=option, buf_len=buf_len,
                              drop_prob=drop_prob, obj=obj, fused=fused)
    data = obj.data_args()
    if mesh is not None:
        # pad the row axis to a multiple of the data-axis size; padded rows
        # repeat row 0 and are sliced off below
        args = _pad_rows(args, -len(members)
                         % mesh_shape(mesh)[_DATA_AXIS])
        runner = _shard_group_fn(runner, mesh, len(data))
    # Both brackets sit around the runner call, never inside an epoch body
    # or a kernel launcher (RL006); tags are built only with the tracer on.
    tr = _tracer()
    tags = {}
    if tr.enabled:
        tags = dict(engine=engine, rows=len(members), total=int(total),
                    group_epochs=int(group_epochs),
                    **mode_tags(fused, device))
    led_on = _ledger.ledger_enabled()
    t0 = time.perf_counter() if led_on else 0.0
    with tr.span_active("execute", **tags):
        w_fin, hist = runner(*data, *args)
        hist, w_fin = hist.cpu().numpy(), w_fin.cpu().numpy()
    if led_on:
        _ledger.ledger().record_dispatch(
            key=key_, rows=len(args[-1]), dim=int(w_init.shape[0]),
            epochs=int(group_epochs), wall_s=time.perf_counter() - t0)
    return hist[:len(members)], w_fin[:len(members)]


def group_label(key_: _GroupKey) -> str:
    """Human-readable label for one group (progress/ledger ids)."""
    _, engine, total, option, buf_len, fused = key_
    return (f"{engine}-{'fused' if fused else 'vmap'}-M{int(total)}"
            f"-opt{option}-buf{int(buf_len)}")


def _assemble_result(specs: Tuple[SweepSpec, ...],
                     resolved: Sequence[_Resolved], histories: np.ndarray,
                     final_w: np.ndarray,
                     param_shapes: Tuple = (), w_init=None,
                     diverged: Optional[Dict[int, int]] = None) -> SweepResult:
    """Derive the accounting rows (passes, totals, epoch budgets) from the
    resolved specs and build the `SweepResult` — the ONE definition all
    dispatch paths (run_sweep, service demux, checkpointed jobs) share.

    ``w_init`` (the flat start iterate) enables the opt-in telemetry:
    rows with ``SweepSpec.telemetry`` get realized-staleness / update-norm
    series derived from the already-final arrays here.

    ``diverged`` (flat row -> last trusted epoch, from the watchdog)
    becomes the optional ``diverged_rows`` marker array; callers passing
    it hand in ``resolved`` rows whose epoch budgets already reflect any
    ``cancel_row`` truncation, so the accounting below follows."""
    epochs_per_row = np.asarray([r.epochs for r in resolved], np.int64)
    passes = _accumulate_passes([r.passes_per_epoch for r in resolved],
                                epochs_per_row, histories.shape[1] - 1)
    total_updates = epochs_per_row * np.asarray(
        [r.total for r in resolved], np.int64)
    telemetry = None
    if w_init is not None and any(s.telemetry for s in specs):
        # imported here: repro_torch.obs.telemetry imports repro_torch.core
        from repro_torch.obs import telemetry as _telemetry
        telemetry = _telemetry.compute(specs, resolved, histories, final_w,
                                       w_init)
    diverged_rows = None
    if diverged:
        diverged_rows = np.full(len(specs), -1, np.int64)
        for c, e in diverged.items():
            diverged_rows[c] = e
    return SweepResult(specs=specs, histories=histories,
                       effective_passes=passes, final_w=final_w,
                       total_updates=total_updates,
                       epochs_per_row=epochs_per_row,
                       param_shapes=param_shapes, telemetry=telemetry,
                       diverged_rows=diverged_rows)


def run_sweep(obj: Optional[Objective], epochs: int,
              specs: Sequence[SweepSpec], *, w0=None,
              drop_prob: float = 0.02,
              mesh: Optional[DeviceMesh] = None) -> SweepResult:
    """Run every spec for its epoch budget, one engine run per
    (objective, engine, M̃, option, buf_len, fused) group, on the
    objective's device, row-sharded across the ``data`` axis of the mesh
    when one is active (explicit ``mesh=`` or the ambient
    `repro_torch.sharding.context` mesh; then a collective call, made by
    every rank of the mesh with the same arguments). Runners come from the
    persistent cache in `repro_torch.service.cache`: a repeated sweep with
    the same group dims and data shapes constructs no runner."""
    plan = plan_sweep(obj, epochs, specs)
    specs, resolved, obj = plan.specs, plan.resolved, plan.objective
    w_init = obj.init_flat() if w0 is None else obj.as_flat(w0)
    mesh = _active_mesh(mesh)

    C = len(specs)
    max_epochs = max(r.epochs for r in resolved)
    histories = np.zeros((C, max_epochs + 1), np.float32)
    final_w = np.zeros((C, obj.flat_dim), np.float32)

    for key_, members in plan.groups.items():
        group_epochs = plan.group_epochs(key_)
        hist, w_fin = _dispatch_group(obj, specs, resolved, members, key_,
                                      group_epochs, w_init, drop_prob, mesh)
        for row, c in enumerate(members):
            _write_row_history(histories[c], hist[row], group_epochs)
            final_w[c] = w_fin[row]

    return _assemble_result(specs, resolved, histories, final_w,
                            param_shapes=obj.param_shapes(), w_init=w_init)
