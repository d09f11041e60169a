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


def full_surface(m: pm.PerfModelInputs, pw: em.PowerParams = em.K20,
                 max_pdev: int = 16, max_tenants: int = 12,
                 ) -> Dict[Tuple[int, int], Deployment]:
    out = {}
    for p in range(1, max_pdev + 1):
        for v in range(1, max_tenants + 1):
            if pm.feasible(p, v, m):
                out[(p, v)] = evaluate(p, v, m, pw)
    return out
