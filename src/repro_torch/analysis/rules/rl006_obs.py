"""RL006 — observability brackets kernel launches, never enters them.

The obs contract (`repro_torch.obs`): tracing spans wrap runner *calls*,
metrics observe on the host after dispatch, and telemetry is recomputed
from already-returned tensors. A timing or tracing call inside an epoch
core or a kernel launcher runs once per inner update: it stalls the
stream it measures (a CUDA event's or ``synchronize``'s wait), adds its
host cost to every launch, and changes what the measured path does — a
"span" there times the launch's enqueue, not the card's work.

Flagged inside any function named ``*_core`` (the epoch bodies, nested
functions included) and anywhere in a ``kernels/**/kernel.py`` module:

  * wall-clock reads: ``time.monotonic`` / ``perf_counter`` / ``time`` /
    ``process_time`` / ``thread_time`` (+ ``_ns`` variants);
  * torch's own timing and tracing: ``torch.cuda.Event``,
    ``torch.cuda.synchronize``, ``torch.cuda.nvtx.*``,
    ``torch.profiler.*``;
  * the tracer API: ``tracer()``, ``enable_tracing``, ``disable_tracing``
    and any ``.span`` / ``.span_all`` / ``.span_active`` / ``.annotate``
    / ``.new_trace`` / ``.record_error`` method call;
  * histogram recording: any ``.observe(...)`` call;
  * the live-progress bus: ``progress_bus`` / ``ProgressBus`` /
    ``enable_progress`` / ``disable_progress`` and ``.publish`` /
    ``.watch`` method calls;
  * the divergence watchdog: ``Watchdog`` / ``enforce_group`` /
    ``first_bad_epoch`` (host-side numpy inspection by contract);
  * the performance ledger: ``ledger`` / ``enable_ledger`` /
    ``disable_ledger`` / ``note_compile`` and ``.record_dispatch``
    method calls;
  * any reference into ``repro_torch.obs`` (or an ``obs.`` alias).

Every name of the obs API above is defined in ``src/repro_torch/obs/``.
Fix: move the measurement to the call site that dispatches the group's
runner (see `repro_torch.core.sweep._dispatch_group` for the pattern), or
recompute the quantity after the launch like `repro_torch.obs.telemetry`.
"""
from __future__ import annotations

import ast
from pathlib import PurePath
from typing import List

from repro_torch.analysis.astutil import FUNC_NODES, call_name, dotted_name
from repro_torch.analysis.diagnostics import Diagnostic

_TIMING_CALLS = {
    f"time.{fn}{suffix}"
    for fn in ("monotonic", "perf_counter", "time", "process_time",
               "thread_time")
    for suffix in ("", "_ns")
}
_TORCH_TIMING_CALLS = {"torch.cuda.Event", "torch.cuda.synchronize"}
_TORCH_TIMING_PREFIXES = ("torch.cuda.nvtx.", "torch.profiler.")
_TRACER_CALLS = {"tracer", "enable_tracing", "disable_tracing"}
# live-obs entry points: progress bus, watchdog, perf ledger — all
# host-side by contract, so any call inside an epoch core is a bug
_PROGRESS_CALLS = {"progress_bus", "ProgressBus", "enable_progress",
                   "disable_progress"}
_WATCHDOG_CALLS = {"Watchdog", "enforce_group", "first_bad_epoch"}
_LEDGER_CALLS = {"ledger", "enable_ledger", "disable_ledger",
                 "note_compile"}
_OBS_METHODS = {"span", "span_all", "span_active", "annotate", "new_trace",
                "record_error", "observe", "publish", "watch",
                "record_dispatch"}
# every obs name above, for the check that each exists in repro_torch/obs
OBS_NAMES = (_TRACER_CALLS | _PROGRESS_CALLS | _WATCHDOG_CALLS
             | _LEDGER_CALLS | _OBS_METHODS)


def _kernel_module(path: str) -> bool:
    p = PurePath(path)
    return p.name == "kernel.py" and "kernels" in p.parts


def _why(node: ast.Call) -> str:
    """Non-empty reason when this call is an obs/timing escape."""
    name = call_name(node) or ""
    if name in _TIMING_CALLS:
        return f"wall-clock read `{name}(...)`"
    if name in _TORCH_TIMING_CALLS or name.startswith(_TORCH_TIMING_PREFIXES):
        return f"torch timing/tracing call `{name}(...)`"
    last = name.rsplit(".", 1)[-1]
    if last in _TRACER_CALLS:
        return f"tracer API call `{name}(...)`"
    if last in _PROGRESS_CALLS:
        return f"progress-bus call `{name}(...)`"
    if last in _WATCHDOG_CALLS:
        return f"watchdog call `{name}(...)`"
    if last in _LEDGER_CALLS:
        return f"ledger call `{name}(...)`"
    if "." in name and last in _OBS_METHODS:
        return f"obs recording call `{name}(...)`"
    return ""


def _scan(path: str, scope: ast.AST, where: str,
          out: List[Diagnostic], seen: set) -> None:
    for node in ast.walk(scope):
        why = ""
        if isinstance(node, ast.Call):
            why = _why(node)
        elif isinstance(node, ast.Attribute):
            name = dotted_name(node) or ""
            if name.startswith(("repro_torch.obs", "obs.")):
                why = f"reference into repro_torch.obs (`{name}`)"
        if why and (node.lineno, why) not in seen:
            seen.add((node.lineno, why))
            out.append(Diagnostic(
                path, node.lineno, "RL006",
                f"{why} inside {where} — observability must bracket the "
                "launch, not run inside it (time/record at the dispatch "
                "site, or recompute afterwards like "
                "repro_torch.obs.telemetry)"))


def check(path: str, tree: ast.AST, source: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    seen: set = set()
    if _kernel_module(path):
        _scan(path, tree, "a kernel module", out, seen)
    for node in ast.walk(tree):
        if isinstance(node, FUNC_NODES) and node.name.endswith("_core"):
            _scan(path, node, f"epoch core `{node.name}`", out, seen)
    return out
