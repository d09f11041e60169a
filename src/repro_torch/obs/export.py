"""Exporters for the telemetry plane.

* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome-trace JSON
  (the ``traceEvents`` array format), loadable by Perfetto and
  ``chrome://tracing``.  Spans become complete ("X") events with the
  layer prefix as category and parent/span ids in ``args``; counters
  are appended as a final snapshot of "C" events so the metrics are
  visible on the same timeline.
* :func:`prometheus_text` / :func:`write_metrics` — Prometheus text
  exposition of counters, gauges and histogram summaries (names
  sanitised to ``[a-z0-9_]``, ``repro_`` prefix);
  :func:`parse_prometheus_text` is the matching reader used by the
  round-trip tests.
* :func:`stats_line` — the compact one-line form the serving driver
  prints periodically.

The JAX package's ``repro/obs/export.py``, names and ``repro_`` prefix
kept, so that one dashboard reads both packages: on equal planes the two
give the same text.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, Optional

from repro_torch.obs.telemetry import Telemetry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def chrome_trace(tel: Telemetry, *, pid: int = 0) -> Dict[str, Any]:
    """Render the plane as a Chrome-trace/Perfetto dict."""
    events = []
    spans = sorted(tel.spans(), key=lambda s: (s.t_start, s.span_id))
    for s in spans:
        args = {str(k): v for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        ev = {"name": s.name, "cat": s.name.split(".", 1)[0],
              "ph": "X", "ts": round(s.t_start * 1e6, 3),
              "dur": round(max(s.duration, 0.0) * 1e6, 3),
              "pid": pid, "tid": s.thread, "args": args}
        events.append(ev)
    t_last = max((s.t_end for s in spans), default=0.0)
    snap = tel.metric_snapshot()
    for name, value in sorted(snap["counters"].items()):
        events.append({"name": name, "cat": "counter", "ph": "C",
                       "ts": round(t_last * 1e6, 3), "pid": pid,
                       "tid": 0, "args": {"value": value}})
    for name, value in sorted(snap["gauges"].items()):
        events.append({"name": name, "cat": "gauge", "ph": "C",
                       "ts": round(t_last * 1e6, 3), "pid": pid,
                       "tid": 0, "args": {"value": value}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"spans_opened": tel.spans_opened,
                          "spans_dropped": tel.spans_dropped}}


def write_chrome_trace(tel: Telemetry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tel), f, indent=None,
                  separators=(",", ":"), default=str)


def prometheus_text(tel: Telemetry) -> str:
    """Prometheus text exposition of the plane's metrics."""
    snap = tel.metric_snapshot()
    lines = []
    for name, value in sorted(snap["counters"].items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {value:g}")
    for name, value in sorted(snap["gauges"].items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {value:g}")
    for name, h in sorted(snap["histograms"].items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} summary")
        lines.append(f"{m}_count {h['count']:g}")
        lines.append(f"{m}_sum {h['sum']:g}")
        lines.append(f"{m}_min {h['min']:g}")
        lines.append(f"{m}_max {h['max']:g}")
    return "\n".join(lines) + "\n"


def write_metrics(tel: Telemetry, path: str) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(tel))


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Parse the exposition format back to ``{name: value}``."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.partition(" ")
        out[name] = float(value)
    return out


def stats_line(tel: Telemetry,
               keys: Optional[Iterable[str]] = None, **extra) -> str:
    """Compact ``k=v`` one-liner over counters+gauges for periodic logs.

    ``keys`` selects metric names (missing ones render as 0); ``extra``
    appends caller-computed fields verbatim.
    """
    snap = tel.metric_snapshot()
    merged = {**snap["counters"], **snap["gauges"]}
    if keys is None:
        keys = sorted(merged)
    parts = []
    for k in keys:
        v = merged.get(k, 0)
        parts.append(f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}")
    for k, v in extra.items():
        parts.append(f"{k}={v}")
    return "obs: " + " ".join(parts)
