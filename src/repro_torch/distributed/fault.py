"""Fault tolerance pieces the serving path uses: a heartbeat watchdog, a
straggler detector and a deterministic fault injector.

The JAX package's ``repro/distributed/fault.py`` in part:

* HeartbeatMonitor -- wall-clock watchdog; the continuous serving scheduler
  (:mod:`repro_torch.serving.multitenant`) beats it once per collected
  decode round, so a wedged round surfaces as a suspect count instead of a
  silent hang.
* StragglerDetector -- per-tenant EWMA of step times; the scheduler feeds it
  each retired request's busy share.
* FaultPlane / InjectedFault -- deterministic every-k fault injection for the
  serving overload tests: drop a decode round, stall an admission batch,
  poison a swap-store read, or SIGKILL the process at an exact round or
  swap-out.  A transient injection *raises* before the state mutation it
  guards, so the caller's retry/limit policy decides whether the request
  survives; a crash gives the process no chance to unwind.

* run_with_recovery / RecoveryReport -- the supervised training loop:
  checkpoint every ``save_every`` steps through
  :mod:`repro_torch.distributed.checkpoint`, and on a failed step restore
  the latest checkpoint and go on from there.
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.obs.telemetry import get_telemetry


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 300.0
    last_beat: float = dataclasses.field(default_factory=time.monotonic)
    missed: int = 0

    def beat(self) -> None:
        self.last_beat = time.monotonic()

    def suspect(self) -> bool:
        """One watchdog verdict; True marks the worker suspect.  A suspect
        verdict is mirrored onto the telemetry plane as a
        ``heartbeat.suspect`` event (the serving scheduler additionally
        keeps the ``heartbeat.suspects`` gauge)."""
        if time.monotonic() - self.last_beat > self.timeout_s:
            self.missed += 1
            tel = get_telemetry(None)
            if tel.enabled:
                tel.event("heartbeat.suspect", missed=self.missed)
            return True
        return False


class InjectedFault(RuntimeError):
    """A fault raised by :class:`FaultPlane`.  Always transient from the
    injector's point of view -- whether it becomes terminal is the caller's
    retry/limit policy, never the engine's."""


@dataclasses.dataclass
class FaultPlane:
    """Deterministic every-k fault injection for the serving stack.

    Each knob is a period: ``0`` disables that fault, ``k`` fires it on
    every k-th event of its kind (events counted from 1).  Every injection
    raises *before* the mutation it guards:

    * ``drop_round_every`` -- :meth:`round_fault` raises at the top of
      ``dispatch_round`` (before the copy-on-write scan), so a dropped round
      leaves the slot table as it was and a bare re-dispatch is sound;
    * ``stall_admission_every`` -- :meth:`admission_fault` raises at the top
      of ``try_admit_batch`` (before any prefill or page allocation);
    * ``poison_swap_every`` -- :meth:`swap_read_fault` raises inside the
      swap store's read, before the staged copy is handed to the restore;
      the host record is untouched, so a retry re-reads the intact copy.

    Crash injection is exact-once: ``crash_at_round=k`` SIGKILLs the process
    at the k-th dispatched round, ``crash_at_swap=k`` at the k-th swap-store
    put (mid-preemption).  Counters are process-local, so the restarted
    process starts at zero and does not crash again.
    """
    drop_round_every: int = 0
    stall_admission_every: int = 0
    poison_swap_every: int = 0
    crash_at_round: int = 0
    crash_at_swap: int = 0
    rounds: int = 0
    admissions: int = 0
    swap_reads: int = 0
    swap_puts: int = 0
    injected: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"round": 0, "admission": 0, "swap": 0})

    def _fire(self, every: int, count: int) -> bool:
        return every > 0 and count % every == 0

    def _record(self, kind: str) -> None:
        tel = get_telemetry(None)
        if tel.enabled:
            tel.count(f"fault.{kind}")
            tel.event("fault.injected", kind=kind, n=self.injected[kind])

    def _maybe_crash(self, at: int, count: int) -> None:
        if at > 0 and count == at:
            os.kill(os.getpid(), signal.SIGKILL)   # no unwind, no flush

    def round_fault(self) -> None:
        self.rounds += 1
        self._maybe_crash(self.crash_at_round, self.rounds)
        if self._fire(self.drop_round_every, self.rounds):
            self.injected["round"] += 1
            self._record("round")
            raise InjectedFault("injected fault: decode round dropped")

    def admission_fault(self) -> None:
        self.admissions += 1
        if self._fire(self.stall_admission_every, self.admissions):
            self.injected["admission"] += 1
            self._record("admission")
            raise InjectedFault("injected fault: admission stalled")

    def swap_read_fault(self) -> None:
        self.swap_reads += 1
        if self._fire(self.poison_swap_every, self.swap_reads):
            self.injected["swap"] += 1
            self._record("swap")
            raise InjectedFault("injected fault: swap read poisoned")

    def swap_put_crash(self) -> None:
        """Mid-preemption crash point (the swap store's put): SIGKILL
        between the victim's host gather and its journal and ledger
        bookkeeping; never raises, never returns when it fires."""
        self.swap_puts += 1
        self._maybe_crash(self.crash_at_swap, self.swap_puts)

    def total_injected(self) -> int:
        return sum(self.injected.values())


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


@dataclasses.dataclass
class RecoveryReport:
    steps_done: int
    failures: int
    restarts: List[int]


def run_with_recovery(step_fn: Callable[[Any, int], Any], state: Any,
                      num_steps: int, ckpt_dir, save_every: int = 50,
                      max_failures: int = 3,
                      state_template: Optional[Any] = None, device=None,
                      monitor: Optional[HeartbeatMonitor] = None,
                      ) -> RecoveryReport:
    """Supervised loop: ``step_fn(state, i) -> state``; a checkpoint every
    ``save_every`` steps and at the end; a step that raises restores the
    latest checkpoint (its leaves onto ``device``, default the host) and
    the loop goes on from its step, up to ``max_failures`` times.  A
    checkpoint already in ``ckpt_dir`` is resumed from."""
    template = state_template if state_template is not None else state
    failures = 0
    restarts: List[int] = []
    start = ckpt.latest_step(ckpt_dir)
    i = 0
    if start is not None:
        state = ckpt.restore(ckpt_dir, start, template, device)
        i = start
    while i < num_steps:
        try:
            state = step_fn(state, i)
            if monitor is not None:
                monitor.beat()
            i += 1
            if i % save_every == 0 or i == num_steps:
                ckpt.save(ckpt_dir, i, state)
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            last = ckpt.latest_step(ckpt_dir)
            if last is None:
                raise
            restarts.append(i)
            state = ckpt.restore(ckpt_dir, last, template, device)
            i = last
    return RecoveryReport(i, failures, restarts)
