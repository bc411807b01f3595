"""Persistent group-runner cache, the port of `repro.service.cache`.

Every group dispatch — a direct `run_sweep` or a coalesced flush of the
`repro_torch.service.api.SweepService` — fetches its runner here, from a
module-level dict keyed on everything that determines the runner:

    (engine, M̃, option, buf_len, epochs-bound, drop_prob,
     objective static key, data signature, fused facet)

The JAX package's key, with three changes. It holds no mesh
fingerprint: a runner computes whatever rows it is given, and a sharded
dispatch wraps the cached runner in the row-sharding wrapper
(`core.sweep._shard_group_fn`) at every call, so every mesh and world
shares one runner per key and the cache holds no process group. The data
signature names each leaf's shape, torch dtype and device, and the fused
facet is the device type of the objective's data (the port has no
interpret mode: a CPU tensor takes the kernels' plain versions, a CUDA
tensor launches them).
The group bodies (`repro_torch.core.sweep._group_fn`) close over the
objective's methods only; the data and the rows enter as arguments, so a
same-key objective's data runs through a runner another instance built.

A "compile" in the port is a runner construction or a kernel build by
`repro_torch.kernels._build`. Both are counted where the JAX package
counts its trace-time compiles, in the `_counted` wrapper: the first call
of a newly built runner counts one, and every kernel library nvcc builds
during a call counts one more. A repeated flush with the same group
shapes fetches the SAME runners, constructs none and builds no kernel
(the warm-path contract `tests/test_torch_service.py` and
`chip_smoke.py`'s ``service`` phase pin); hit/miss counters cover the
cache itself.

The cache is process-global on purpose — many logical clients / services
in one process share runners — and LRU-BOUNDED (`_MAX_RUNNERS`, 64
runners). `clear_cache()` exists for tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from repro_torch.core import sweep as _sweep
from repro_torch.kernels import _build
from repro_torch.obs import ledger as _ledger
from repro_torch.obs.trace import tracer as _tracer


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Snapshot of the runner cache counters (monotonic since process start
    or the last `clear_cache(reset_stats=True)`)."""
    hits: int = 0
    misses: int = 0
    compiles: int = 0

    @property
    def hit_rate(self) -> float:
        lookups = self.hits + self.misses
        return self.hits / lookups if lookups else 0.0

    def since(self, base: "CacheStats") -> "CacheStats":
        """Counter deltas relative to an earlier snapshot."""
        return CacheStats(hits=self.hits - base.hits,
                          misses=self.misses - base.misses,
                          compiles=self.compiles - base.compiles)


class _Counters:
    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.compiles = 0

    def snapshot(self) -> CacheStats:
        return CacheStats(hits=self.hits, misses=self.misses,
                          compiles=self.compiles)


# Per-lookup scoped attribution: a caller (one `SweepService` dispatch
# window) installs a private _Counters sink on ITS thread; every lookup —
# and every counted construction or build, which happens while the runner
# is called on the same thread — credits the sink in addition to the
# globals, so two services flushing concurrently never pollute each
# other's counters.
_TLS = threading.local()


@contextlib.contextmanager
def scoped_counters(sink: _Counters):
    """Credit this thread's cache lookups/compiles to ``sink`` (nests:
    the previous sink is restored on exit; only the innermost one counts)."""
    prev = getattr(_TLS, "sink", None)
    _TLS.sink = sink
    try:
        yield sink
    finally:
        _TLS.sink = prev


def _credit(field: str, n: int = 1) -> None:
    """Bump one counter on the globals and the thread's scoped sink (if
    any). Caller holds _LOCK; the sink is thread-private so the same lock
    suffices."""
    setattr(_COUNTERS, field, getattr(_COUNTERS, field) + n)
    sink = getattr(_TLS, "sink", None)
    if sink is not None:
        setattr(sink, field, getattr(sink, field) + n)


_LOCK = threading.Lock()
_RUNNERS: "OrderedDict[tuple, object]" = OrderedDict()
_COUNTERS = _Counters()
# LRU bound: a long-lived multi-tenant service must not accumulate runners
# forever as tenants rotate through shapes; callers holding an evicted
# runner keep using it — eviction only drops the SHARED reference.
_MAX_RUNNERS = 64

_RunnerKey = Tuple  # (engine, M̃, option, buf_len, epochs, drop_prob,
#                     objective static key,
#                     per-data-leaf (shape, dtype, device), fused facet)


def _leaf_signature(a) -> tuple:
    """(shape, dtype, device type) of one data leaf; a Python scalar (the
    objective's λ) is ((), its type name, None)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype).replace("torch.", ""),
                a.device.type)
    return ((), type(a).__name__, None)


def _fused_mode_key(fused: bool, obj) -> Optional[str]:
    """The cache-key facet for the engine body: None for the batched path,
    else the device type the fused body runs on ("cuda": the sweep-epoch
    kernel; "cpu": its plain version)."""
    if not fused:
        return None
    return obj.device.type


def runner_key(engine: str, *, group_epochs: int, total: int, option: int,
               buf_len: int, drop_prob: float, obj,
               fused: bool = False) -> _RunnerKey:
    """Everything that determines the runner. The objective's data enters
    the runner as arguments, so only its signatures are keyed (plus
    `obj.runner_static_key()`) — two tenants sweeping same-shape datasets
    of one objective class on one device share one runner."""
    data_sig = tuple(_leaf_signature(a) for a in obj.data_args())
    return (engine, int(total), int(option), int(buf_len), int(group_epochs),
            float(drop_prob), obj.runner_static_key(), data_sig,
            _fused_mode_key(fused, obj))


def _counted(fn):
    """Count compiles where the JAX package counts its traces: the first
    call of a newly constructed runner counts one, and each kernel library
    `kernels._build` compiles during a call counts one more. Each counted
    call stamps ``compiled=True`` on the open dispatch span and tells the
    ledger that the dispatch in flight paid for it."""
    first = [True]

    def counted(*args):
        built = _build.builds()
        out = fn(*args)
        with _LOCK:
            n = int(first[0]) + _build.builds() - built
            first[0] = False
            if n:
                _credit("compiles", n)
        if n:
            _tracer().annotate(compiled=True)
            if _ledger.ledger_enabled():
                _ledger.note_compile()
        return out
    return counted


def get_group_runner(engine: str, *, group_epochs: int, total: int,
                     option: int, buf_len: int, drop_prob: float, obj,
                     fused: bool = False):
    """The runner for one (engine, M̃, option, buf_len, …) group, built at
    most once per key. ``fused=True`` keys and builds the sweep-epoch
    kernel's body instead of the batched one.

    The returned callable takes ``(*obj.data_args(), *row_args)``."""
    key = runner_key(engine, group_epochs=group_epochs, total=total,
                     option=option, buf_len=buf_len, drop_prob=drop_prob,
                     obj=obj, fused=fused)
    with _LOCK:
        runner = _RUNNERS.get(key)
        if runner is not None:
            _credit("hits")
            _tracer().annotate(cache="hit")
            _RUNNERS.move_to_end(key)            # LRU touch
            return runner
        _credit("misses")
        _tracer().annotate(cache="miss")
        fn = _sweep._group_fn(engine, obj=obj,
                              num_data=len(obj.data_args()),
                              epochs=group_epochs, total=total,
                              buf_len=buf_len, option=option,
                              drop_prob=drop_prob, fused=fused)
        runner = _counted(fn)
        _RUNNERS[key] = runner
        while len(_RUNNERS) > _MAX_RUNNERS:
            _RUNNERS.popitem(last=False)         # evict least recently used
        return runner


def cache_stats() -> CacheStats:
    """Current hit/miss/compile counters (a frozen snapshot)."""
    with _LOCK:
        return CacheStats(hits=_COUNTERS.hits, misses=_COUNTERS.misses,
                          compiles=_COUNTERS.compiles)


def cache_size() -> int:
    with _LOCK:
        return len(_RUNNERS)


def clear_cache(reset_stats: bool = True) -> None:
    """Drop every cached runner (tests)."""
    with _LOCK:
        _RUNNERS.clear()
        if reset_stats:
            _COUNTERS.hits = _COUNTERS.misses = _COUNTERS.compiles = 0

