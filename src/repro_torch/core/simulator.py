"""Discrete-event simulator of the tenancy/transfer schedule.

Models one host link (InfiniBand in the paper) feeding ``n_pdev``
accelerators, each able to overlap DMA with compute (the paper's
multi-tenancy premise), with tenants serialised per device (the paper: a
GPU executes its tenants' kernels one after the other).

Reproduces the paper's artefacts exactly, with the same float arithmetic in
the same order as the JAX package's ``repro/core/simulator.py``:
  * Fig 8/10 — concurrent streams share the link: BW_eff(n) = BW/n
  * Fig 11b  — 4 pdev, sequential, 1 tenant: makespan = 88 x 35 ms cells
  * Fig 13a  — 2 tenants/pdev: 80 cells;  Fig 13b — 4 tenants: 76 cells
  * Fig 12/14 — utilisation & energy of each schedule

The *executable* counterpart of this simulated schedule is
:mod:`repro_torch.core.pipeline`.  The link-sharing premise is the paper's:
whether a card's copies from several streams share its link (BW/n each) or
run one after the other is a measurement (``diagnostics/risk_pairs.py``),
not something this model knows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.energymodel import K20, PowerParams
from repro_torch.core.perfmodel import (COMPUTATION_TIME_1PDEV, ELT_MB,
                                  NetworkParams, PF_MB, YET_MB, FDR,
                                  PerfModelInputs)
from repro_torch.core.tenancy import TenancyConfig, VirtualDevicePool

PAPER_STEP_S = 0.035  # one timeline cell in Figs 11/13


@dataclasses.dataclass(frozen=True)
class SimInputs:
    tenancy: TenancyConfig
    net: NetworkParams = FDR
    compute_time_1pdev: float = COMPUTATION_TIME_1PDEV
    yet_mb: float = YET_MB
    elt_mb: float = ELT_MB
    pf_mb: float = PF_MB
    power: PowerParams = K20


@dataclasses.dataclass
class TenantEvent:
    vdev: int
    pdev: int
    slot: int
    transfer_start: float
    transfer_end: float
    compute_start: float
    compute_end: float


@dataclasses.dataclass
class SimResult:
    makespan: float
    events: List[TenantEvent]
    utilization: float          # mean busy fraction across pdevs
    energy_ws: float            # 4-state model integrated over the timeline

    def steps(self, step: float = PAPER_STEP_S) -> int:
        return int(math.ceil(self.makespan / step - 1e-9))


def effective_bandwidth(n_streams: int, link_bw_mb_s: float) -> float:
    """Fig 8/10: n concurrent streams on one link each attain BW/n."""
    return link_bw_mb_s / max(n_streams, 1)


def _per_tenant_times(si: SimInputs) -> Tuple[float, float]:
    """(transfer_seconds, compute_seconds) for one tenant."""
    nv = si.tenancy.n_vdev
    # bandwidth-equivalent of Table II: YET body time scales with slice size;
    # ELT/PF/small/malloc overheads are per tenant
    transfer = (si.net.t_4gb * (si.yet_mb / YET_MB) / nv
                + si.net.per_vdev_overhead
                * (si.elt_mb / ELT_MB * 0 + 1))  # overheads are per-vdev consts
    compute = si.compute_time_1pdev / nv
    return transfer, compute


def simulate(si: SimInputs) -> SimResult:
    """Continuous-time simulation; returns the schedule and its metrics."""
    tc = si.tenancy
    pool = VirtualDevicePool(tc)
    tasks = pool.plan(tc.n_vdev)          # unit work per vdev; sizes equal
    t_tr, t_cp = _per_tenant_times(si)

    events: List[TenantEvent] = []
    if tc.transfer_mode == "sequential":
        # staging order = slot-major (pool.plan order): every pdev's first
        # tenant before any second tenant (paper Fig 13)
        link_free = 0.0
        for t in tasks:
            ts, te = link_free, link_free + t_tr
            link_free = te
            events.append(TenantEvent(t.vdev, t.pdev, t.slot, ts, te, 0.0, 0.0))
    else:  # concurrent: all streams share the link; equal sizes finish together
        total = t_tr * len(tasks)
        for t in tasks:
            events.append(TenantEvent(t.vdev, t.pdev, t.slot, 0.0, total,
                                      0.0, 0.0))

    # compute: tenants serialised per pdev, start when data ready & pdev free
    pdev_free = [0.0] * tc.n_pdev
    for ev in sorted(events, key=lambda e: (e.slot, e.pdev)):
        start = max(ev.transfer_end, pdev_free[ev.pdev])
        ev.compute_start = start
        ev.compute_end = start + t_cp
        pdev_free[ev.pdev] = ev.compute_end

    makespan = max(e.compute_end for e in events)
    busy = sum(e.compute_end - e.compute_start for e in events)
    util = busy / (tc.n_pdev * makespan)
    energy = (busy * si.power.p_busy +
              (tc.n_pdev * makespan - busy) * si.power.p_idle_assigned)
    return SimResult(makespan, events, util, energy)


def simulate_cells(si: SimInputs, step: float = PAPER_STEP_S) -> SimResult:
    """Cell-quantized simulation matching the paper's Fig 11/13 timelines.

    The figures draw each activity as whole 35 ms cells: per-tenant transfer
    = YET slice + the 120 MB ELT copy (sub-cell malloc/small overheads are
    invisible at this resolution), rounded to the nearest cell; per-tenant
    compute likewise.  With Table II FDR constants this reproduces the
    paper's cell counts exactly: 88 / 80 / 76 for 1 / 2 / 4 tenants on
    4 pdevs, with "all data by step 20" (Fig 11b), "first four by 12, all
    by 24" (Fig 13a) and "first round by 8" (Fig 13b).
    """
    tc = si.tenancy
    nv = tc.n_vdev
    tr_cells = round((si.net.t_4gb * (si.yet_mb / YET_MB) / nv
                      + si.net.t_120mb * (si.elt_mb / ELT_MB)) / step)
    cp_cells = round(si.compute_time_1pdev / nv / step)
    pool = VirtualDevicePool(tc)
    tasks = pool.plan(nv)

    events: List[TenantEvent] = []
    if tc.transfer_mode == "sequential":
        link = 0
        for t in tasks:
            events.append(TenantEvent(t.vdev, t.pdev, t.slot,
                                      link * step, (link + tr_cells) * step,
                                      0.0, 0.0))
            link += tr_cells
    else:
        total = tr_cells * nv
        for t in tasks:
            events.append(TenantEvent(t.vdev, t.pdev, t.slot, 0.0,
                                      total * step, 0.0, 0.0))

    pdev_free = [0.0] * tc.n_pdev
    for ev in sorted(events, key=lambda e: (e.slot, e.pdev)):
        start = max(ev.transfer_end, pdev_free[ev.pdev])
        ev.compute_start = start
        ev.compute_end = start + cp_cells * step
        pdev_free[ev.pdev] = ev.compute_end

    makespan = max(e.compute_end for e in events)
    busy = sum(e.compute_end - e.compute_start for e in events)
    util = busy / (tc.n_pdev * makespan)
    energy = (busy * si.power.p_busy +
              (tc.n_pdev * makespan - busy) * si.power.p_idle_assigned)
    return SimResult(makespan, events, util, energy)


def makespan_steps(n_pdev: int, tenants: int, mode: str = "sequential",
                   si: Optional[SimInputs] = None,
                   step: float = PAPER_STEP_S, cells: bool = True) -> int:
    si = si or SimInputs(TenancyConfig(n_pdev, tenants, mode))
    si = dataclasses.replace(si, tenancy=TenancyConfig(n_pdev, tenants, mode))
    res = simulate_cells(si, step) if cells else simulate(si)
    return res.steps(step)


def concurrent_vs_sequential(n_pdev: int = 4,
                             si: Optional[SimInputs] = None,
                             ) -> Dict[str, SimResult]:
    """Fig 11 + Fig 12: both transfer modes for the same hardware."""
    base = si or SimInputs(TenancyConfig(n_pdev, 1))
    out = {}
    for mode in ("concurrent", "sequential"):
        s = dataclasses.replace(base, tenancy=TenancyConfig(n_pdev, 1, mode))
        out[mode] = simulate(s)
    return out
