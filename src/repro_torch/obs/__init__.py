"""Telemetry plane: spans + metrics across the stack.

One process-global :class:`~repro_torch.obs.telemetry.Telemetry` instance
(``repro_torch.obs.TELEMETRY``, disabled by default) collects what the
instrumented layers record as one schema.

Every span and metric name is lowercase, dot-separated:
``<layer>.<noun>[.<detail>]``; the first segment is the emitting layer.

========== ==========================================================
prefix      layer
========== ==========================================================
``sched``   `serving.multitenant` — scheduler steps, admission passes
``round``   `serving.continuous` — decode micro-round dispatch/collect
``admit``   `serving.continuous` — batched admission (plan/prefill)
``engine``  `serving.engine` — prefill, ``generate``, ``dispatch``,
            ``await``
``kv``      `serving.kvcache` — paged-pool page accounting
``heartbeat`` `distributed.fault` — liveness verdicts
``trace``   first use of a decode round key (`serving.continuous`) or
            of a decode loop key (`serving.engine`)
``admission`` `serving.multitenant` — admissions as timeline entries
``transfer`` `core.transfer` — staging-engine chunk windows
``timeline`` ``TenantTimeline`` entries re-expressed as spans (the
            scheduler's, and risk runs' device windows, `obs.fit`)
``replay``  `obs.fit` — replayed simulator runs
``power``   `obs.fit` — (busy_frac, watts) samples for the energy fit
========== ==========================================================

`obs.export` writes the plane as a Chrome trace and as Prometheus text;
`obs.fit` fits ``PerfModelInputs``/``PowerParams`` from it for
``core.planner.plan_from_telemetry``; `obs.gauge` reads the card's energy
counter.

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
