"""Fit the paper's perf/energy models from recorded telemetry.

The plane records per-tenant transfer and compute windows as spans
(``replay.*`` from simulator replays, ``timeline.*`` from the live
scheduler and from risk runs — see :func:`record_run_timeline`), each
carrying an ``nv`` attr (total virtual devices in the deployment the
sample came from).  The paper's model is linear in the observables:

* per-tenant transfer  ``t = a/nv + b`` with ``a = t_4gb * yet_mb/4000``
  (bandwidth-bound YET slice) and ``b = per_vdev_overhead`` (Eq 6);
* per-tenant compute  ``t = compute_time_1pdev / nv``       (Eq 5);
* mean device power  ``P = f*p_busy + (1-f)*p_idle_assigned`` for busy
  fraction ``f`` (the 4-state model of Eq 10 with assigned devices).

so least squares over the spans recovers ``PerfModelInputs`` and
``PowerParams`` directly.  ``power.sample`` events carry
``(busy_frac, watts)`` pairs: in a replay the watts column is synthesised
from the model; on the card it is the card's own energy counter
(:class:`repro_torch.obs.gauge.PowerGauge`), recorded by
:func:`record_power_samples`.

`plan_from_telemetry` in `core.planner` drives this end to end:
extract samples -> fit -> plan, picking the transfer mode by simulating
both under the fitted inputs.

The fits, the replay and the extraction are the JAX package's
``repro/obs/fit.py`` with the same arithmetic and error messages; the two
recorders of the card's side are this package's own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import energymodel as em
from repro_torch.core import perfmodel as pm
from repro_torch.core.simulator import SimInputs, SimResult, simulate
from repro_torch.obs.telemetry import Telemetry

TRANSFER_SPAN = "timeline.transfer"     # what samples_from_telemetry reads
COMPUTE_SPAN = "timeline.compute"


@dataclasses.dataclass(frozen=True)
class PhaseSample:
    """One tenant's observed (transfer, compute) at total-vdev count nv."""
    nv: int
    transfer_s: float
    compute_s: float


@dataclasses.dataclass(frozen=True)
class PerfFit:
    """A fitted `PerfModelInputs` plus residuals of the least squares."""
    m: pm.PerfModelInputs
    transfer_rms_s: float
    compute_rms_s: float
    n_samples: int


# -- recording ---------------------------------------------------------
def replay_sim_run(tel: Telemetry, si: SimInputs,
                   pw: Optional[em.PowerParams] = None,
                   base: Optional[float] = None,
                   power_bins: int = 32) -> SimResult:
    """Simulate ``si`` and re-express its schedule as spans on the plane.

    Each `TenantEvent` becomes a ``replay.transfer`` span with a child
    ``replay.compute`` span, tagged with the deployment's ``nv``.  When
    ``pw`` is given, ``power.sample`` events with (busy_frac, watts)
    are recorded too (watts synthesised from the 4-state model — the
    replay stand-in for a hardware power gauge).
    """
    res = simulate(si)
    nv = si.tenancy.n_vdev
    base = tel.now() if base is None else base
    for ev in res.events:
        common = dict(nv=nv, pdev=ev.pdev, vdev=ev.vdev, slot=ev.slot)
        pid = tel.record_span("replay.transfer", base + ev.transfer_start,
                              base + ev.transfer_end, **common)
        tel.record_span("replay.compute", base + ev.compute_start,
                        base + ev.compute_end, parent_id=pid, **common)
    if pw is not None:
        for frac, watts in power_samples(res, si.tenancy.n_pdev, pw,
                                         bins=power_bins):
            tel.event("power.sample", busy_frac=frac, watts=watts)
    return res


def power_samples(res: SimResult, n_pdev: int, pw: em.PowerParams,
                  bins: int = 32) -> List[Tuple[float, float]]:
    """(busy_frac, mean per-device watts) per time bin of a sim run."""
    out: List[Tuple[float, float]] = []
    edges = np.linspace(0.0, res.makespan, bins + 1)
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi <= lo:
            continue
        busy = sum(max(0.0, min(e.compute_end, hi) - max(e.compute_start, lo))
                   for e in res.events)
        frac = min(1.0, busy / (n_pdev * (hi - lo)))
        watts = frac * pw.p_busy + (1.0 - frac) * pw.p_idle_assigned
        out.append((frac, watts))
    return out


# -- recording on the card ---------------------------------------------
def entry_windows_ms(entry: Any) -> Dict[str, float]:
    """A risk run's timeline entry's copy and kernel windows, in ms after
    the run's origin (``copy_start``, ``copy_end``, ``compute_start``,
    ``compute_end``): its CUDA-event windows (``device_ms``), or its host
    stamps where it has none (the CPU)."""
    if entry.device_ms is not None:
        return entry.device_ms
    return {"copy_start": entry.transfer_start * 1e3,
            "copy_end": entry.transfer_end * 1e3,
            "compute_start": entry.compute_start * 1e3,
            "compute_end": entry.compute_end * 1e3}


def record_run_timeline(tel: Telemetry, report: Any, *, nv: int) -> int:
    """Record a risk run's ``RunReport.timeline`` as ``timeline.transfer``
    / ``timeline.compute`` spans tagged with ``nv``, as the serving
    scheduler records its entries (``record_timeline(..., nv=...)``).

    Deliberate difference from the host stamps: on a CUDA device every
    entry carries ``device_ms`` (the copy's and the kernel's windows from
    CUDA events, ms after the run's origin event), and those windows are
    what this records, shifted onto the plane's clock by the run's origin
    ``report.t0_s``.  The host stamps would bias the fit: ``compute_start``
    is the host's launch time, which comes before the copy lands, and
    ``compute_end`` is a waiter thread's wake-up.  Where ``device_ms`` is
    None (the CPU) the host stamps are all there is, and they are
    recorded (:func:`entry_windows_ms`).  Returns the number of entries
    recorded."""
    if not tel.enabled:
        return 0
    base = report.t0_s
    for entry in report.timeline:
        w = entry_windows_ms(entry)
        common = dict(vdev=entry.vdev, pdev=entry.pdev, slot=entry.slot,
                      nv=nv)
        pid = tel.record_span(TRANSFER_SPAN, base + w["copy_start"] * 1e-3,
                              base + w["copy_end"] * 1e-3, **common)
        tel.record_span(COMPUTE_SPAN, base + w["compute_start"] * 1e-3,
                        base + w["compute_end"] * 1e-3, parent_id=pid,
                        **common)
    return len(report.timeline)


def record_sweep(tel: Telemetry, engines: Mapping[int, Any], tables: Any,
                 runs: int) -> List[Tuple[int, Any]]:
    """A sweep for the fit: each engine, keyed by its deployment's ``nv``,
    runs ``tables`` ``runs`` times back to back, and each run is recorded
    by :func:`record_run_timeline`.  Returns ``(nv, report)`` for every
    run, in run order."""
    out = []
    for nv, engine in engines.items():
        for _ in range(runs):
            rep = engine.run_tenant_chunked(tables)
            record_run_timeline(tel, rep, nv=nv)
            out.append((nv, rep))
    return out


def busy_windows(report: Any) -> List[Tuple[float, float]]:
    """A risk run's kernel windows as absolute ``perf_counter`` intervals
    (:func:`entry_windows_ms` shifted by ``report.t0_s``)."""
    return [(report.t0_s + w["compute_start"] * 1e-3,
             report.t0_s + w["compute_end"] * 1e-3)
            for w in map(entry_windows_ms, report.timeline)]


def busy_seconds(busy: Sequence[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Time within ``[lo, hi)`` covered by the (non-overlapping) ``busy``
    intervals."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in busy)


def gauge_power_samples(ticks: Sequence[Tuple[float, float]],
                        busy: Sequence[Tuple[float, float]],
                        ) -> List[Tuple[float, float]]:
    """(busy_frac, watts) for each interval between consecutive energy
    counter ticks: ``ticks`` are ``(perf_counter time, joules)`` in time
    order (:meth:`PowerGauge.ticks`), ``busy`` the intervals in which the
    compute stream ran a kernel.  The watts are the counter's own energy
    over the interval; nothing is synthesised."""
    out: List[Tuple[float, float]] = []
    for (t0, e0), (t1, e1) in zip(ticks, ticks[1:]):
        if t1 <= t0:
            continue
        frac = min(1.0, busy_seconds(busy, t0, t1) / (t1 - t0))
        out.append((frac, (e1 - e0) / (t1 - t0)))
    return out


def record_power_samples(tel: Telemetry,
                         ticks: Sequence[Tuple[float, float]],
                         busy: Sequence[Tuple[float, float]],
                         **attrs) -> List[Tuple[float, float]]:
    """Record :func:`gauge_power_samples` as ``power.sample`` events, the
    schema of the replay (:func:`power_samples_from_telemetry` reads
    both); returns the samples."""
    samples = gauge_power_samples(ticks, busy)
    for frac, watts in samples:
        tel.event("power.sample", busy_frac=frac, watts=watts, **attrs)
    return samples


# -- extraction --------------------------------------------------------
def samples_from_telemetry(tel: Telemetry,
                           prefixes: Sequence[str] = ("replay", "timeline"),
                           ) -> List[PhaseSample]:
    """Pair ``<prefix>.transfer``/``.compute`` spans into `PhaseSample`s.

    Spans are grouped by (nv, pdev, vdev) and paired in start order, so
    a tenant that ran k rounds yields k samples.  Spans without an
    ``nv`` attr (live spans from a layer that doesn't know the
    deployment) are skipped.
    """
    samples: List[PhaseSample] = []
    for prefix in prefixes:
        tr: dict = {}
        cp: dict = {}
        for s in tel.spans(prefix=prefix + "."):
            nv = s.attrs.get("nv")
            if nv is None:
                continue
            key = (nv, s.attrs.get("pdev"), s.attrs.get("vdev"))
            if s.name.endswith(".transfer"):
                tr.setdefault(key, []).append(s)
            elif s.name.endswith(".compute"):
                cp.setdefault(key, []).append(s)
        for key, ts in tr.items():
            cs = cp.get(key, [])
            ts.sort(key=lambda s: (s.t_start, s.span_id))
            cs.sort(key=lambda s: (s.t_start, s.span_id))
            for a, b in zip(ts, cs):
                samples.append(PhaseSample(int(key[0]), a.duration,
                                           b.duration))
    return samples


def power_samples_from_telemetry(tel: Telemetry) -> List[Tuple[float, float]]:
    return [(float(s.attrs["busy_frac"]), float(s.attrs["watts"]))
            for s in tel.spans(name="power.sample")
            if "busy_frac" in s.attrs and "watts" in s.attrs]


# -- fitting -----------------------------------------------------------
def fit_perf_inputs(samples: Iterable[PhaseSample], *,
                    name: str = "fitted",
                    yet_mb: float = pm.YET_MB,
                    elt_mb: float = pm.ELT_MB,
                    pf_mb: float = pm.PF_MB,
                    context_mb: float = pm.CONTEXT_MB,
                    device_memory_mb: float = pm.K20_MEMORY_MB) -> PerfFit:
    """Least-squares fit of `PerfModelInputs` from phase samples.

    Transfer regresses on ``[1/nv, 1]`` giving the bandwidth-bound YET
    coefficient and the per-vdev overhead; compute regresses through
    the origin on ``1/nv``.  The recovered overhead cannot be split
    back into Table II's malloc/small/PF/ELT components, so it is
    carried whole in ``t_small`` (``per_vdev_overhead`` is what the
    model consumes).  Needs samples from >= 2 distinct nv.
    """
    samples = list(samples)
    nv = np.asarray([s.nv for s in samples], dtype=float)
    if len(np.unique(nv)) < 2:
        raise ValueError("fit_perf_inputs needs samples from >= 2 distinct"
                         f" deployments (got nv={sorted(set(nv))})")
    tr = np.asarray([s.transfer_s for s in samples], dtype=float)
    cp = np.asarray([s.compute_s for s in samples], dtype=float)

    a_tr = np.stack([1.0 / nv, np.ones_like(nv)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(a_tr, tr, rcond=None)
    slope, intercept = max(float(slope), 0.0), max(float(intercept), 0.0)
    t_4gb = slope / (yet_mb / pm.YET_MB)
    tr_rms = float(np.sqrt(np.mean(
        (a_tr @ np.array([slope, intercept]) - tr) ** 2)))

    a_cp = (1.0 / nv)[:, None]
    (c1,), *_ = np.linalg.lstsq(a_cp, cp, rcond=None)
    c1 = max(float(c1), 0.0)
    cp_rms = float(np.sqrt(np.mean((c1 / nv - cp) ** 2)))

    net = pm.NetworkParams(name, t_malloc=0.0, t_small=intercept,
                           t_4mb=0.0, t_120mb=0.0, t_4gb=t_4gb)
    m = pm.PerfModelInputs(net, compute_time_1pdev=c1, yet_mb=yet_mb,
                           elt_mb=elt_mb, pf_mb=pf_mb,
                           context_mb=context_mb,
                           device_memory_mb=device_memory_mb)
    return PerfFit(m, tr_rms, cp_rms, len(samples))


def fit_power_params(samples: Sequence[Tuple[float, float]], *,
                     name: str = "fitted",
                     p_unassigned: float = 0.0) -> em.PowerParams:
    """Least-squares fit of the 2-free-state power model.

    ``watts = f*p_busy + (1-f)*p_idle_assigned`` — needs busy-fraction
    variation across samples.  ``p_unassigned`` is unobservable from an
    assigned device's samples and passes through.
    """
    if len(samples) < 2:
        raise ValueError("fit_power_params needs >= 2 samples")
    f = np.asarray([s[0] for s in samples], dtype=float)
    w = np.asarray([s[1] for s in samples], dtype=float)
    a = np.stack([f, 1.0 - f], axis=1)
    coef, _, rank, _ = np.linalg.lstsq(a, w, rcond=None)
    if rank < 2:
        raise ValueError("power samples have no busy-fraction variation;"
                         " cannot separate p_busy from p_idle_assigned")
    p_busy, p_idle = (float(coef[0]), float(coef[1]))
    return em.PowerParams(name, p_busy=p_busy, p_idle_assigned=p_idle,
                          p_unassigned=p_unassigned)
