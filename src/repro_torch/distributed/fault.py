"""Fault tolerance pieces the serving path uses: a heartbeat watchdog and a
straggler detector.

The JAX package's ``repro/distributed/fault.py`` in part:

* HeartbeatMonitor -- wall-clock watchdog; the continuous serving scheduler
  (:mod:`repro_torch.serving.multitenant`) beats it once per collected
  decode round, so a wedged round surfaces as a suspect count instead of a
  silent hang.
* StragglerDetector -- per-tenant EWMA of step times; the scheduler feeds it
  each retired request's busy share.

``FaultPlane`` / ``InjectedFault`` (fault injection) and
``run_with_recovery`` come with slice 3 of the port.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

from repro_torch.obs.telemetry import get_telemetry


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 300.0
    last_beat: float = dataclasses.field(default_factory=time.monotonic)
    missed: int = 0

    def beat(self) -> None:
        self.last_beat = time.monotonic()

    def suspect(self) -> bool:
        """One watchdog verdict; True marks the worker suspect.  Verdicts
        are mirrored onto the telemetry plane (``heartbeat.verdicts`` /
        ``heartbeat.suspect`` — the serving scheduler additionally keeps
        the ``heartbeat.suspects`` gauge)."""
        tel = get_telemetry(None)
        tel.count("heartbeat.verdicts")
        if time.monotonic() - self.last_beat > self.timeout_s:
            self.missed += 1
            if tel.enabled:
                tel.event("heartbeat.suspect", missed=self.missed)
            return True
        return False


class StragglerDetector:
    """EWMA + variance tracking of per-tenant step times (DESIGN.md §7)."""

    def __init__(self, alpha: float = 0.2, z_threshold: float = 3.0):
        self.alpha = alpha
        self.z = z_threshold
        self.mean: Dict[int, float] = {}
        self.var: Dict[int, float] = {}

    def update(self, times: Dict[int, float]) -> List[int]:
        """Feed per-tenant step times; returns currently-flagged stragglers."""
        flagged = []
        for k, t in times.items():
            m = self.mean.get(k, t)
            v = self.var.get(k, 0.0)
            d = t - m
            m += self.alpha * d
            v = (1 - self.alpha) * (v + self.alpha * d * d)
            self.mean[k], self.var[k] = m, v
        pop = list(self.mean.values())
        if len(pop) >= 2:
            mu = sum(pop) / len(pop)
            sd = math.sqrt(sum((x - mu) ** 2 for x in pop) / len(pop)) or 1e-9
            flagged = [k for k, m in self.mean.items()
                       if (m - mu) / sd > self.z]
        return flagged

    def staging_priority(self) -> Dict[int, float]:
        """For core.transfer.reorder_for_stragglers: slowest staged first."""
        return dict(self.mean)
