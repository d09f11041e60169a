"""Performance model — paper Equations 4-9 with Table II constants.

The model predicts total execution time for any (#pdev, tenants_per_pdev)
deployment, for a given network.  Every constant below is the paper's own
(measured there on NVIDIA K20 cards behind rCUDA over InfiniBand): they are
the model's inputs, not measurements of the card this package runs on.  The
model reproduces the paper's optimal deployments 7x2 (QDR) and 9x2 (FDR).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    """Per-vdev staging cost constants (Table II, seconds)."""
    name: str
    t_malloc: float
    t_small: float            # all <100 B structures together
    t_4mb: float              # PF
    t_120mb: float            # ELT
    t_4gb: float              # the full YET (bandwidth-bound part)

    @property
    def per_vdev_overhead(self) -> float:
        return self.t_malloc + self.t_small + self.t_4mb + self.t_120mb


# --- Table II ---------------------------------------------------------------
QDR = NetworkParams("QDR-IB", t_malloc=0.00267, t_small=0.0048,
                    t_4mb=0.00133, t_120mb=0.036, t_4gb=1.171)
FDR = NetworkParams("FDR-IB", t_malloc=0.0027, t_small=0.0028,
                    t_4mb=0.00079, t_120mb=0.0205, t_4gb=0.67)

COMPUTATION_TIME_1PDEV = 9.55   # s, paper §V-F1 Table II (NVIDIA K20)
K20_MEMORY_MB = 4799            # nvidia-smi total memory
YET_MB, ELT_MB, PF_MB = 4000.0, 120.0, 1.0
CONTEXT_MB = 75.0               # per-tenant GPU-context overhead: reproduces
                                # the paper's ">4 vGPUs exhaust the K20" cap
MAX_PDEV_PLATFORM = 12          # paper §V-E: "Up to 12 pGPUs will be used"


@dataclasses.dataclass(frozen=True)
class PerfModelInputs:
    net: NetworkParams
    compute_time_1pdev: float = COMPUTATION_TIME_1PDEV
    yet_mb: float = YET_MB
    elt_mb: float = ELT_MB
    pf_mb: float = PF_MB
    context_mb: float = CONTEXT_MB
    device_memory_mb: float = K20_MEMORY_MB


def t_computation(n_dev: int, m: PerfModelInputs) -> float:
    """Eq 5 — perfect compute scalability (paper §V-B/V-C)."""
    return m.compute_time_1pdev / n_dev


def t_transfer(n_dev: int, m: PerfModelInputs) -> float:
    """Eq 6 — per-vdev overheads scale with #devices; the YET body is
    bandwidth-bound and its total is constant."""
    return n_dev * m.net.per_vdev_overhead + m.net.t_4gb


def exec_time_no_mt(n_pdev: int, m: PerfModelInputs) -> float:
    """Eq 4 — sequential transfers, single tenancy, no same-device overlap."""
    return t_transfer(n_pdev, m) + t_computation(n_pdev, m)


def exec_time_multitenancy(n_pdev: int, tenants_per_pdev: int,
                           m: PerfModelInputs) -> float:
    """Eq 9 = max(Eq 7, Eq 8)."""
    nv = n_pdev * tenants_per_pdev
    fully = (t_transfer(nv, m) / tenants_per_pdev
             + tenants_per_pdev * t_computation(nv, m))       # Eq 7
    not_fully = t_transfer(nv, m) + t_computation(nv, m)       # Eq 8
    return max(fully, not_fully)


def memory_per_pdev_mb(n_pdev: int, tenants_per_pdev: int,
                       m: PerfModelInputs, with_context: bool = False) -> float:
    nv = n_pdev * tenants_per_pdev
    ctx = m.context_mb if with_context else 0.0
    return tenants_per_pdev * (m.yet_mb / nv + m.elt_mb + m.pf_mb + ctx)


def feasible(n_pdev: int, tenants_per_pdev: int, m: PerfModelInputs) -> bool:
    return memory_per_pdev_mb(n_pdev, tenants_per_pdev, m,
                              with_context=True) <= m.device_memory_mb


def surface(m: PerfModelInputs, max_pdev: int = MAX_PDEV_PLATFORM,
            max_tenants: int = 12) -> Dict[Tuple[int, int], float]:
    """Execution-time surface over the deployment space (Figs 17/18)."""
    out = {}
    for p in range(1, max_pdev + 1):
        for v in range(1, max_tenants + 1):
            if feasible(p, v, m):
                out[(p, v)] = exec_time_multitenancy(p, v, m)
    return out
