"""Energy model — paper Equation 10 and the 4-state power model (§V-F2).

GPU states: (1) idle-assigned, (2) receiving data, (3) receive+compute,
(4) compute.  States 1-2 draw P_idle_assigned; states 3-4 draw P_busy.
The K20 constants are the paper's nvidia-smi measurements: model inputs, not
measurements of the card this package runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core import perfmodel as pm


@dataclasses.dataclass(frozen=True)
class PowerParams:
    name: str
    p_busy: float            # W, computing (with or without concurrent DMA)
    p_idle_assigned: float   # W, initialised & waiting / receiving only
    p_unassigned: float      # W, not assigned to any application


K20 = PowerParams("K20", p_busy=102.0, p_idle_assigned=47.0, p_unassigned=25.0)


def total_energy(n_pdev: int, tenants_per_pdev: int, m: pm.PerfModelInputs,
                 pw: PowerParams = K20) -> float:
    """Eq 10: every pdev computes for tenants*T_comp(#v) = T_comp(#p) seconds
    at P_busy and idles (assigned) the rest of the makespan."""
    exec_time = pm.exec_time_multitenancy(n_pdev, tenants_per_pdev, m)
    compute_time = pm.t_computation(n_pdev, m)
    return n_pdev * (compute_time * pw.p_busy +
                     (exec_time - compute_time) * pw.p_idle_assigned)


def energy_surface(m: pm.PerfModelInputs, pw: PowerParams = K20,
                   max_pdev: int = pm.MAX_PDEV_PLATFORM, max_tenants: int = 12,
                   ) -> Dict[Tuple[int, int], float]:
    out = {}
    for p in range(1, max_pdev + 1):
        for v in range(1, max_tenants + 1):
            if pm.feasible(p, v, m):
                out[(p, v)] = total_energy(p, v, m, pw)
    return out


def edp_surface(m: pm.PerfModelInputs, pw: PowerParams = K20,
                max_pdev: int = pm.MAX_PDEV_PLATFORM, max_tenants: int = 12,
                ) -> Dict[Tuple[int, int], float]:
    """energy * execution-time space (Figs 21/22)."""
    t = pm.surface(m, max_pdev, max_tenants)
    e = energy_surface(m, pw, max_pdev, max_tenants)
    return {k: t[k] * e[k] for k in t}
