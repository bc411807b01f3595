"""Prometheus text exposition (format 0.0.4) over a stats snapshot.

The port of `repro.obs.prometheus`. `render(snapshot, histograms)` turns
a JSON-safe stats dict (the shape the JAX package's ``GET /stats``
serves) into the plain-text gauge lines a Prometheus scrape expects,
plus the cumulative bucket series for each
`repro_torch.obs.metrics.Histogram`. Stdlib-only — no client library is
needed: the format is lines of ``name{labels} value``. The metric prefix
stays ``repro``, so both packages expose the same series.

Mapping rules, applied recursively over the snapshot dict:

  * numeric leaves become gauges named by their dict path:
    ``{"service": {"flushes": 3}}`` -> ``repro_service_flushes 3``;
    booleans render as 0/1;
  * the per-key maps whose KEYS are identifiers, not metric names —
    ``tenants`` and ``fairness.deficits`` — render as labels:
    ``repro_tenants_rows_submitted{tenant="team-a"} 128``;
  * strings / None are skipped (``last_error`` et al. belong in ``/stats``
    and ``/trace``, not in a numeric time series);
  * every value passes through ``float()``/``int()``, so a numpy scalar
    that slipped into the snapshot could never leak its repr into the
    exposition (and the snapshot tests pin that none slips in at all).

Metric names are ``repro_``-prefixed and sanitized to the Prometheus
grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
# snapshot subtrees whose keys are arbitrary identifiers -> label name
# ("ledger" keys are per-group runner labels -> repro_ledger_* series;
# its string leaves like flops_source are skipped by _format_value)
_LABELED = {"tenants": "tenant", "deficits": "tenant", "ledger": "group"}


def _metric_name(prefix: str, parts: List[str]) -> str:
    return _NAME_OK.sub("_", "_".join([prefix] + parts))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _format_value(value) -> Optional[str]:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(int(value))
    if isinstance(value, float):
        f = float(value)
        if f != f:
            return "NaN"
        if f in (float("inf"), float("-inf")):
            return "+Inf" if f > 0 else "-Inf"
        return repr(f)
    return None          # strings, None, nested handled by the caller


def _walk(prefix: str, parts: List[str], node, labels: str,
          lines: List[str]) -> None:
    if isinstance(node, Mapping):
        for key, child in node.items():
            key = str(key)
            label_name = _LABELED.get(key)
            if label_name is not None and isinstance(child, Mapping):
                # one level of labeled fan-out: child keys become label
                # values, grandchildren become suffixed metric names
                for ident, sub in child.items():
                    lab = f'{{{label_name}="{_escape_label(str(ident))}"}}'
                    if isinstance(sub, Mapping):
                        for leaf, v in sub.items():
                            val = _format_value(v)
                            if val is not None:
                                name = _metric_name(prefix,
                                                    parts + [key, str(leaf)])
                                lines.append(f"{name}{lab} {val}")
                    else:
                        val = _format_value(sub)
                        if val is not None:
                            name = _metric_name(prefix, parts + [key])
                            lines.append(f"{name}{lab} {val}")
                continue
            _walk(prefix, parts + [key], child, labels, lines)
        return
    val = _format_value(node)
    if val is not None:
        lines.append(f"{_metric_name(prefix, parts)}{labels} {val}")


def render_histogram(name: str, histogram, lines: List[str]) -> None:
    """Classic cumulative exposition: ``_bucket{le=...}``/``_sum``/
    ``_count``, with the mandatory ``le="+Inf"`` == ``_count`` bucket."""
    cumulative, total, count = histogram.snapshot()
    lines.append(f"# TYPE {name} histogram")
    for bound, c in cumulative:
        le = _format_value(float(bound))
        lines.append(f'{name}_bucket{{le="{le}"}} {c}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {count}')
    lines.append(f"{name}_sum {repr(float(total))}")
    lines.append(f"{name}_count {count}")


def render(snapshot: dict, histograms: Optional[Dict[str, object]] = None,
           prefix: str = "repro") -> str:
    """The full ``/metrics`` payload: every numeric leaf of ``snapshot``
    as a gauge, then each histogram's bucket series. Ends with a trailing
    newline as the exposition format requires."""
    lines: List[str] = []
    _walk(prefix, [], snapshot, "", lines)
    if histograms:
        for name, histogram in sorted(histograms.items()):
            render_histogram(_metric_name(prefix, [name]), histogram,
                             lines)
    return "\n".join(lines) + "\n"
