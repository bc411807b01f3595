"""Per-group performance ledger: construction time, FLOPs, attained
fraction.

The port of `repro.obs.ledger`. Each group runner (the unit the service
caches — one per ``(objective, engine, M̃, option, buf_len, fused)``
group at a given epoch budget) gets one ledger entry per dispatched row
width recording

* how many dispatches ran through it and how many of them were the first
  call of a newly constructed runner or built a kernel (``compiles``),
* the wall clock of those dispatches (``compile_s``) and the best warm
  dispatch (``warm_wall_min_s``),
* operations and bytes from the analytic epoch model of
  :mod:`repro_torch.launch.roofline`, set when the entry is created,
* the attained-vs-roofline fraction: the roofline lower bound for the
  group's path (batched or fused) on the H100 (`config.H100_SXM`) over
  the best measured warm wall time.

The wall time a dispatch site records must cover the device's work, not
only the launches' enqueue (`repro_torch.core.sweep._dispatch_group` stops
its clock after the results reached the host).

The ledger is **opt-in** (``enable_ledger``) and entirely host-side: the
only thing it adds to a dispatch is two ``perf_counter`` reads bracketing
the runner call, gated by one bool (RL006 boundary).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Tuple

from repro_torch.launch.roofline import attained_fraction

__all__ = [
    "LedgerEntry",
    "PerfLedger",
    "ledger",
    "ledger_enabled",
    "enable_ledger",
    "disable_ledger",
    "note_compile",
]

_TLS = threading.local()


def note_compile() -> None:
    """Construction hook: ``service.cache._counted`` calls this on a
    runner's first call (or a call that built a kernel), so the in-flight
    ``record_dispatch`` on the same thread can attribute the wall time
    it measured to compilation."""
    _TLS.compiled = True


def _take_compiled() -> bool:
    c = getattr(_TLS, "compiled", False)
    _TLS.compiled = False
    return c


@dataclasses.dataclass
class LedgerEntry:
    label: str
    engine: str
    fused: bool
    rows: int
    dim: int
    total: int
    buf_len: int
    epochs: int
    dispatches: int = 0
    compiles: int = 0
    compile_s: float = 0.0        # wall of dispatches that constructed/built
    wall_s_total: float = 0.0
    warm_wall_min_s: float = 0.0  # best non-compiling dispatch (0 until one lands)
    flops: float = 0.0
    bytes: float = 0.0
    roofline_s: float = 0.0       # analytic step lower bound for this path

    def attained_frac(self) -> float:
        wall = self.warm_wall_min_s or (
            self.wall_s_total / self.dispatches if self.dispatches else 0.0)
        return self.roofline_s / wall if wall > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "engine": self.engine,
            "fused": int(self.fused),
            "rows": self.rows,
            "dim": self.dim,
            "total": self.total,
            "buf_len": self.buf_len,
            "epochs": self.epochs,
            "dispatches": self.dispatches,
            "compiles": self.compiles,
            "compile_s": self.compile_s,
            "wall_s_total": self.wall_s_total,
            "warm_wall_min_s": self.warm_wall_min_s,
            "flops": self.flops,
            "bytes": self.bytes,
            "roofline_s": self.roofline_s,
            "attained_frac": self.attained_frac(),
        }


def _roofline(entry: LedgerEntry) -> dict:
    rf = attained_fraction(rows=entry.rows, dim=entry.dim,
                           total=entry.total, epochs=entry.epochs,
                           buf_len=entry.buf_len, fused=entry.fused,
                           wall_s=0.0)
    return {"flops": float(rf["flops"]), "bytes": float(rf["bytes"]),
            "step_lower_bound_s": float(rf["roofline_s"])}


class PerfLedger:
    """Thread-safe map from group/runner identity to a ``LedgerEntry``."""

    def __init__(self, max_entries: int = 256):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, LedgerEntry] = {}  # guarded-by: _lock
        self._max = max_entries

    def record_dispatch(
        self,
        *,
        key: Tuple,
        rows: int,
        dim: int,
        epochs: int,
        wall_s: float,
    ) -> None:
        """Account one runner call.  ``key`` is the group key from
        ``plan_sweep``; ``rows`` the dispatched width.  Flops and bytes
        come from the analytic epoch model when the entry is created."""
        compiled = _take_compiled()
        _, engine, total, option, buf_len, fused = key
        ek = (key, int(rows), int(epochs))
        label = (f"{engine}-{'fused' if fused else 'vmap'}-M{int(total)}"
                 f"-opt{option}-buf{int(buf_len)}-rows{int(rows)}-E{int(epochs)}")
        with self._lock:
            entry = self._entries.get(ek)
            if entry is None:
                if len(self._entries) >= self._max:
                    return
                entry = LedgerEntry(label=label, engine=str(engine),
                                    fused=bool(fused), rows=int(rows),
                                    dim=int(dim), total=int(total),
                                    buf_len=int(buf_len), epochs=int(epochs))
                rf = _roofline(entry)
                entry.roofline_s = rf["step_lower_bound_s"]
                entry.flops = rf["flops"]
                entry.bytes = rf["bytes"]
                self._entries[ek] = entry
            entry.dispatches += 1
            entry.wall_s_total += wall_s
            if compiled:
                entry.compiles += 1
                entry.compile_s += wall_s
            elif entry.warm_wall_min_s == 0.0 or wall_s < entry.warm_wall_min_s:
                entry.warm_wall_min_s = wall_s

    def snapshot(self) -> Dict[str, dict]:
        """``label -> numeric leaves`` — the shape the Prometheus walker
        fans out under the ``group`` label and ``/ledger`` serves raw."""
        with self._lock:
            entries = list(self._entries.values())
        out: Dict[str, dict] = {}
        for e in entries:
            # the reference's snapshot names where flops came from; here
            # always the analytic model
            out[e.label] = {**e.as_dict(), "flops_source": "analytic"}
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_LEDGER = PerfLedger()
_ENABLED = False


def ledger() -> PerfLedger:
    return _LEDGER


def ledger_enabled() -> bool:
    """The one-bool fast path checked at every dispatch site."""
    return _ENABLED


def enable_ledger() -> PerfLedger:
    global _ENABLED
    _ENABLED = True
    return _LEDGER


def disable_ledger(clear: bool = False) -> None:
    global _ENABLED
    _ENABLED = False
    if clear:
        _LEDGER.clear()
