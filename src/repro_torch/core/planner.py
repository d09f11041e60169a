"""Deployment planner (paper §V-F): pick (#pdev, tenants) for an objective.

Objectives: "time" (Figs 17/18), "energy" (Figs 19/20), "edp" = energy x time
(Figs 21/22).  The planner also serves elastic scaling: given any chip budget
it emits the best feasible deployment.  Its default inputs are the paper's
own constants (see :mod:`repro_torch.core.perfmodel`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import energymodel as em
from repro_torch.core import perfmodel as pm


@dataclasses.dataclass(frozen=True)
class Deployment:
    n_pdev: int
    tenants_per_pdev: int
    exec_time_s: float
    energy_ws: float
    memory_per_pdev_mb: float

    @property
    def n_vdev(self) -> int:
        return self.n_pdev * self.tenants_per_pdev

    @property
    def edp(self) -> float:
        return self.exec_time_s * self.energy_ws


def evaluate(n_pdev: int, tenants: int, m: pm.PerfModelInputs,
             pw: em.PowerParams = em.K20) -> Deployment:
    return Deployment(
        n_pdev, tenants,
        exec_time_s=pm.exec_time_multitenancy(n_pdev, tenants, m),
        energy_ws=em.total_energy(n_pdev, tenants, m, pw),
        memory_per_pdev_mb=pm.memory_per_pdev_mb(n_pdev, tenants, m,
                                                 with_context=True))


def plan(m: pm.PerfModelInputs, objective: str = "time",
         max_pdev: int = pm.MAX_PDEV_PLATFORM, max_tenants: int = 12,
         pw: em.PowerParams = em.K20,
         budget_pdev: Optional[int] = None) -> Deployment:
    """Best feasible deployment under the objective (and chip budget)."""
    assert objective in ("time", "energy", "edp")
    best: Optional[Deployment] = None
    limit = min(max_pdev, budget_pdev) if budget_pdev else max_pdev
    for p in range(1, limit + 1):
        for v in range(1, max_tenants + 1):
            if not pm.feasible(p, v, m):
                continue
            d = evaluate(p, v, m, pw)
            key = {"time": d.exec_time_s, "energy": d.energy_ws,
                   "edp": d.edp}[objective]
            bkey = (None if best is None else
                    {"time": best.exec_time_s, "energy": best.energy_ws,
                     "edp": best.edp}[objective])
            if best is None or key < bkey - 1e-12:
                best = d
    assert best is not None, "no feasible deployment"
    return best


@dataclasses.dataclass(frozen=True)
class TelemetryPlan:
    """`plan_from_telemetry` result: the deployment plus its provenance."""
    deployment: Deployment
    transfer_mode: str           # "sequential" | "concurrent", sim-compared
    m: pm.PerfModelInputs        # fitted perf-model inputs
    pw: em.PowerParams           # fitted (or fallback) power params
    transfer_rms_s: float        # fit residuals, for falsifiability
    compute_rms_s: float


def plan_from_telemetry(tel, objective: str = "time",
                        max_pdev: int = pm.MAX_PDEV_PLATFORM,
                        max_tenants: int = 12,
                        pw: Optional[em.PowerParams] = None,
                        budget_pdev: Optional[int] = None,
                        **fit_kw) -> TelemetryPlan:
    """Plan from recorded telemetry instead of static Table II constants.

    Fits `PerfModelInputs` by least squares over the per-round
    transfer/compute spans on the plane (``replay.*`` and
    ``timeline.*`` — see `repro_torch.obs.fit`), fits `PowerParams` from any
    recorded ``power.sample`` events (falling back to ``pw`` or the
    paper's K20 set when none were recorded), runs the same search as
    `plan`, then picks the transfer mode by simulating both under the
    fitted inputs at the chosen deployment (ties go to sequential, the
    paper's winner).
    """
    from repro_torch.core.simulator import SimInputs, simulate
    from repro_torch.core.tenancy import TenancyConfig
    from repro_torch.obs import fit as obs_fit

    pf = obs_fit.fit_perf_inputs(obs_fit.samples_from_telemetry(tel),
                                 **fit_kw)
    if pw is None:
        psamples = obs_fit.power_samples_from_telemetry(tel)
        pw = (obs_fit.fit_power_params(psamples) if len(psamples) >= 2
              else em.K20)
    d = plan(pf.m, objective=objective, max_pdev=max_pdev,
             max_tenants=max_tenants, pw=pw, budget_pdev=budget_pdev)
    makespans = {}
    for mode in ("sequential", "concurrent"):
        si = SimInputs(TenancyConfig(d.n_pdev, d.tenants_per_pdev, mode),
                       net=pf.m.net,
                       compute_time_1pdev=pf.m.compute_time_1pdev,
                       yet_mb=pf.m.yet_mb, elt_mb=pf.m.elt_mb,
                       pf_mb=pf.m.pf_mb, power=pw)
        makespans[mode] = simulate(si).makespan
    mode = ("sequential"
            if makespans["sequential"] <= makespans["concurrent"] + 1e-12
            else "concurrent")
    return TelemetryPlan(d, mode, pf.m, pw, pf.transfer_rms_s,
                         pf.compute_rms_s)


def full_surface(m: pm.PerfModelInputs, pw: em.PowerParams = em.K20,
                 max_pdev: int = 16, max_tenants: int = 12,
                 ) -> Dict[Tuple[int, int], Deployment]:
    out = {}
    for p in range(1, max_pdev + 1):
        for v in range(1, max_tenants + 1):
            if pm.feasible(p, v, m):
                out[(p, v)] = evaluate(p, v, m, pw)
    return out
