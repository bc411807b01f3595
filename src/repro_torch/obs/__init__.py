"""repro_torch.obs — observability for the sweep stack, the port of
`repro.obs`.

Four stdlib-only pieces plus four numeric ones:

  * `repro_torch.obs.trace` — the request-lifecycle flight recorder:
    bounded ring buffer of monotonic-clock span trees, one trace id per
    request, threaded submit -> plan -> coalesce -> pad -> dispatch ->
    execute -> demux -> result.
  * `repro_torch.obs.metrics` — cumulative histograms (flush/request
    latency, rows-per-flush, pad-factor) the service records on every
    flush.
  * `repro_torch.obs.prometheus` — text-exposition rendering of a stats
    snapshot dict + the histograms.
  * `repro_torch.obs.progress` — bounded live-progress bus: per-slice
    loss events published from ``run_job`` slice boundaries and completed
    flushes, consumed with cursor-based resume.
  * `repro_torch.obs.telemetry` — opt-in per-row realized-staleness and
    update-norm series, replayed on the CPU from already-returned arrays
    and the rows' seeds (imports torch; import it explicitly).
  * `repro_torch.obs.watchdog` / `repro_torch.obs.ledger` — divergence
    watchdog and per-group performance ledger against the analytic
    roofline of `repro_torch.launch.roofline` (import them explicitly).

House rule (repro-lint RL006): none of these APIs may be called inside a
``*_core`` function or a ``kernels/**/kernel.py`` module — observability
brackets runner calls on the host, it never runs inside them.
"""
from repro_torch.obs.metrics import Histogram, ServiceHistograms
from repro_torch.obs.progress import (
    ProgressBus,
    ProgressEvent,
    disable_progress,
    enable_progress,
    progress_bus,
    progress_enabled,
)
from repro_torch.obs.trace import (
    Span,
    Tracer,
    disable_tracing,
    enable_tracing,
    tracer,
)

__all__ = [
    "Histogram",
    "ServiceHistograms",
    "ProgressBus",
    "ProgressEvent",
    "Span",
    "Tracer",
    "disable_progress",
    "disable_tracing",
    "enable_progress",
    "enable_tracing",
    "progress_bus",
    "progress_enabled",
    "tracer",
]
