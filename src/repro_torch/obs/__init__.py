"""Telemetry plane: spans + metrics across the stack.

One process-global :class:`~repro_torch.obs.telemetry.Telemetry` instance
(``repro_torch.obs.TELEMETRY``, disabled by default) collects what the
instrumented layers record as one schema.

Every span and metric name is lowercase, dot-separated:
``<layer>.<noun>[.<detail>]``; the first segment is the emitting layer.

========== ==========================================================
prefix      layer
========== ==========================================================
``sched``   `serving.multitenant` — scheduler steps, admission passes;
            per request (``rid``) ``sched.queue`` (arrival to the
            admission pass that admits it) and ``sched.first_token``
            (that pass to its first collected token), both written
            when the request retires
``round``   `serving.continuous` — decode micro-round dispatch/collect
``admit``   `serving.continuous` — batched admission (plan/prefill);
            ``admit.prefill`` names its ``rids`` and its ``call`` in
            ``prefill_ms()``
``engine``  `serving.engine` — prefill, ``generate``, ``dispatch``,
            ``await``
``kv``      `serving.kvcache` — paged-pool page accounting
``heartbeat`` `distributed.fault` — liveness
``trace``   first use of a decode round key (`serving.continuous`) or
            of a decode loop key (`serving.engine`)
``risk``    `risk.analysis` — one analysis (``run``): ``risk.run``,
            ``risk.prepare``, ``risk.collect``; the resident step
            ``risk.step`` with ``risk.pad`` and ``risk.launch``
``pipeline`` `core.pipeline` — ``pipeline.start`` (waiter threads),
            per tenant ``pipeline.stage`` / ``pipeline.wait`` /
            ``pipeline.launch``, then ``pipeline.join``
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
clock, `time.perf_counter`; retrospective spans carry ``parent_id=None``
and ``live=False``: ``Telemetry.live_spans()`` is the host's own work),
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
