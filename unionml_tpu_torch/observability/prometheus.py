"""Prometheus text-format exposition of the serving metrics snapshot.

A copy of ``unionml_tpu/observability/prometheus.py``: the port never imports the
JAX package.

``GET /metrics`` serves a JSON snapshot (serving/metrics.py) — convenient for
humans and the in-repo benchmarks, but real scrape-based monitoring speaks the
Prometheus text exposition format. ``GET /metrics?format=prometheus`` renders
the SAME snapshot dict through :func:`render` — no second bookkeeping path, so
the two views can never disagree.

Mapping rules (applied to the snapshot's actual shape, then generically to
anything future sections add):

- ``requests_total``/``errors_total`` -> counters;
- ``overload.<name>`` -> ``unionml_tpu_overload_total{counter="<name>"}``;
- ``routes.<route>`` -> ``unionml_tpu_route_requests_total{route=...}`` /
  ``_errors_total`` and a latency summary
  ``unionml_tpu_route_latency_ms{route=...,quantile=...}`` + ``_count``;
- ``queues.<q>`` -> ``unionml_tpu_queue_wait_ms{queue=...,quantile=...}``;
- everything else (gauges, predictor/micro_batcher/generation sections) is
  flattened recursively: dict keys join into the metric name, list elements
  label as ``index="i"``, and only int/float/bool leaves become series —
  ``None`` and strings are skipped, so a registered-but-inactive gauge can
  never emit a ``None``-valued sample the scraper chokes on.

Escaping follows the exposition-format spec: metric names reduce to
``[a-zA-Z_:][a-zA-Z0-9_:]*``; label values escape backslash, double-quote and
newline. Percentile keys like ``p99_ms`` become ``quantile="0.99"`` labels so
Grafana's summary conventions apply directly.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["render"]

#: metric-name prefix for every series this exporter emits
PREFIX = "unionml_tpu"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILE_KEY = re.compile(r"^p(\d+)(?:_ms)?$")


def _metric_name(*parts: str) -> str:
    name = "_".join(p for p in parts if p)
    name = _NAME_OK.sub("_", name)
    if not name or name[0].isdigit():
        name = f"_{name}"
    return name


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: "List[Tuple[str, str]]") -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(value: Any) -> Optional[str]:
    """A sample value, or ``None`` when this leaf must not become a series.
    bool before int: ``True`` is an ``int`` subclass."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return repr(float(value)) if isinstance(value, float) else str(value)
    return None


class _Writer:
    """Accumulates samples grouped per metric family, emitting each family's
    ``# TYPE`` line once (the exposition grammar requires grouping)."""

    def __init__(self) -> None:
        self._families: "Dict[str, Tuple[str, List[str]]]" = {}
        self._order: "List[str]" = []

    def sample(
        self, name: str, labels: "List[Tuple[str, str]]", value: Any, kind: str = "gauge"
    ) -> None:
        rendered = _fmt_value(value)
        if rendered is None:
            return
        if name not in self._families:
            self._families[name] = (kind, [])
            self._order.append(name)
        self._families[name][1].append(f"{name}{_fmt_labels(labels)} {rendered}")

    def render(self) -> str:
        lines: "List[str]" = []
        for name in self._order:
            kind, samples = self._families[name]
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(samples)
        return "\n".join(lines) + "\n" if lines else "\n"


def _quantile(key: str) -> Optional[str]:
    """``p99_ms`` -> ``"0.99"``, ``p50`` -> ``"0.5"``; None for non-percentiles."""
    match = _QUANTILE_KEY.match(key)
    if match is None:
        return None
    digits = match.group(1)
    value = int(digits) / (10 ** len(digits))
    return f"{value:g}"


def _emit_window(
    writer: _Writer, name: str, labels: "List[Tuple[str, str]]", stats: "Dict[str, Any]"
) -> None:
    """A LatencyWindow-style dict (window/mean/p50/p95/p99/max) as a summary:
    percentile keys become ``quantile`` labels, the rest become suffixed
    gauges (``_count`` for the window size, per Prometheus summary idiom)."""
    for key, value in stats.items():
        if key == "window":
            writer.sample(f"{name}_count", labels, value, "gauge")
            continue
        quantile = _quantile(key)
        if quantile is not None:
            writer.sample(name, labels + [("quantile", quantile)], value, "summary")
        else:
            suffix = key[:-3] if key.endswith("_ms") else key
            writer.sample(f"{name}_{suffix}", labels, value, "gauge")


def _looks_like_window(value: Any) -> bool:
    return isinstance(value, dict) and "window" in value and all(
        isinstance(k, str) for k in value
    )


def _flatten(
    writer: _Writer, prefix: "List[str]", labels: "List[Tuple[str, str]]", value: Any
) -> None:
    """Generic fallback for snapshot sections without a dedicated mapping."""
    if _looks_like_window(value):
        name = _metric_name(PREFIX, *prefix)
        _emit_window(writer, name[:-3] if name.endswith("_ms") else name, labels, value)
        return
    if isinstance(value, dict):
        for key, sub in value.items():
            _flatten(writer, prefix + [str(key)], labels, sub)
        return
    if isinstance(value, (list, tuple)):
        for i, sub in enumerate(value):
            _flatten(writer, prefix, labels + [("index", str(i))], sub)
        return
    writer.sample(_metric_name(PREFIX, *prefix), labels, value)


def render(snapshot: "Dict[str, Any]") -> str:
    """Render a :meth:`ServingMetrics.snapshot`-shaped dict (plus whatever
    sections the serving app merged in) as Prometheus text exposition."""
    writer = _Writer()
    consumed = {"requests_total", "errors_total", "overload", "routes", "queues"}
    writer.sample(f"{PREFIX}_requests_total", [], snapshot.get("requests_total", 0), "counter")
    writer.sample(f"{PREFIX}_errors_total", [], snapshot.get("errors_total", 0), "counter")
    for counter, value in (snapshot.get("overload") or {}).items():
        writer.sample(
            f"{PREFIX}_overload_total", [("counter", str(counter))], value, "counter"
        )
    for queue, stats in (snapshot.get("queues") or {}).items():
        labels = [("queue", str(queue))]
        if isinstance(stats, dict):
            writer.sample(f"{PREFIX}_queue_wait_ms_count", labels, stats.get("window"), "gauge")
            for key, value in stats.items():
                if key == "window":
                    continue
                quantile = _quantile(key.replace("wait_", ""))
                if quantile is not None:
                    writer.sample(
                        f"{PREFIX}_queue_wait_ms",
                        labels + [("quantile", quantile)],
                        value,
                        "summary",
                    )
    for route, entry in (snapshot.get("routes") or {}).items():
        labels = [("route", str(route))]
        if not isinstance(entry, dict):
            continue
        writer.sample(f"{PREFIX}_route_requests_total", labels, entry.get("requests"), "counter")
        writer.sample(f"{PREFIX}_route_errors_total", labels, entry.get("errors"), "counter")
        for key, value in entry.items():
            if key in ("requests", "errors"):
                continue
            if key == "window":
                writer.sample(f"{PREFIX}_route_latency_ms_count", labels, value, "gauge")
                continue
            quantile = _quantile(key)
            if quantile is not None:
                writer.sample(
                    f"{PREFIX}_route_latency_ms",
                    labels + [("quantile", quantile)],
                    value,
                    "summary",
                )
            elif key == "mean_ms":
                writer.sample(f"{PREFIX}_route_latency_ms_mean", labels, value, "gauge")
    for key, value in snapshot.items():
        if key in consumed:
            continue
        _flatten(writer, [str(key)], [], value)
    return writer.render()
