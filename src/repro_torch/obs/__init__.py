"""Telemetry plane: spans + metrics across the stack.

One process-global :class:`~repro_torch.obs.telemetry.Telemetry` instance
(``repro_torch.obs.TELEMETRY``, disabled by default) collects what the
instrumented layers record as one schema.

Every span and metric name is lowercase, dot-separated:
``<layer>.<noun>[.<detail>]``; the first segment is the emitting layer.

========== ==========================================================
prefix      layer
========== ==========================================================
``transfer`` `core.transfer` — staging-engine chunk windows
``timeline`` ``TenantTimeline`` entries re-expressed as spans
========== ==========================================================

Kinds: **spans** (closed ``[t_start, t_end)`` intervals on one monotonic
clock, `time.perf_counter`; retrospective spans carry ``parent_id=None``),
**events** (zero-length spans), **counters** (monotonically increasing, e.g.
``transfer.bytes``), **gauges** (last write wins) and **histograms**
(count/sum/min/max).

Cost contract: with the plane disabled (the default) every hook is one
attribute check — no span objects, no counter mutations, no allocations.
"""
from repro_torch.obs.telemetry import (NULL_SPAN, Span, Telemetry, TELEMETRY,
                                       get_telemetry, record_timeline)

__all__ = ["NULL_SPAN", "Span", "Telemetry", "TELEMETRY", "get_telemetry",
           "record_timeline"]
