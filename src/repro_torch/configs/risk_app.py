"""The paper's own workload: Aggregate Risk Analysis (Section IV).

Paper-scale inputs: YET = 1M trials x 1000 (event, timestamp) pairs (~4 GB
int32 pairs when packed), 15 ELTs covered by one layer (ELT total ~120 MB),
PF ~4 MB of financial terms.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class RiskAppConfig:
    name: str = "risk-analysis"
    family: str = "risk"
    num_trials: int = 1_000_000
    events_per_trial: int = 1000
    num_elts: int = 15              # ELTs covered by the layer (3..30 per paper)
    event_catalog: int = 2_000_000  # direct-access table size per ELT
    num_programs: int = 1
    num_layers: int = 1
    chunk_events: int = 128         # paper's "chunking" of the event axis
    tenants_per_device: int = 2     # vGPUs per pGPU
    transfer_mode: str = "sequential"  # sequential | concurrent
    dtype: str = "float32"

    def reduced(self) -> "RiskAppConfig":
        return RiskAppConfig(
            name="risk-analysis-reduced",
            num_trials=64,
            events_per_trial=32,
            num_elts=3,
            event_catalog=512,
            chunk_events=16,
            tenants_per_device=2,
        )


CONFIG = RiskAppConfig()

# Shape cells for the risk app (trials x tenancy).
RISK_SHAPES: Tuple[Tuple[str, int, int], ...] = (
    # (name, num_trials, tenants_per_device)
    ("risk_1m_t1", 1_000_000, 1),
    ("risk_1m_t2", 1_000_000, 2),
    ("risk_1m_t4", 1_000_000, 4),
)
