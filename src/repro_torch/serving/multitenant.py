"""Multi-tenant serving scheduler, continuous schedule (the paper's second
multi-tenancy reading: several applications share one physical accelerator).

The JAX package's ``repro/serving/multitenant.py`` in ``mode="continuous"``:
each tenant owns a request queue, and every scheduling step

1. admits queued requests into free slots of a
   :class:`repro_torch.serving.continuous.ContinuousBatchingEngine` --
   picked round-robin or straggler-first across tenants, or, when queue
   heads span priority tiers, a tenant is over its fair share of the paged
   pool, or a head is in admission backoff, by ``(priority, over-share,
   deadline, row-steps consumed)`` -- all picks admitted as one batch;
2. dispatches one masked decode micro-round over all slots while the
   previous round may still occupy the device (when that round has already
   landed it is collected first, so its finished rows free their slots and
   pages for this step's admissions);
3. collects the previous round, retires finished rows and splits the
   round's device window across tenants by live row-steps.

Per-round :class:`repro_torch.core.pipeline.TenantTimeline` entries
(transfer window = admission + dispatch on the host, compute window =
dispatch -> device-ready, stamped by a
:class:`repro_torch.core.pipeline.CompletionWaiter` on the round's CUDA
event) keep :func:`repro_torch.core.pipeline.timeline_overlaps` falsifiable
round to round.  An admission the pool refuses re-queues; when nothing is in
flight it counts against a bounded retry budget with exponential backoff and
ends in a terminal ``REJECTED`` response past it, and a queued request past
its deadline is shed the same way -- ``drain()`` returns one response per
request.  A :class:`repro_torch.distributed.fault.HeartbeatMonitor` is
beaten per collected round.

Priorities order admission but never preempt: swap preemption, load
shedding by backlog (``max_backlog``), fault injection, the request journal
and engine checkpoints come with slice 3 of the port; the ``overlapped`` and
``blocking`` schedules with a later slice.  Asking for any of them raises
``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.pipeline import CompletionWaiter, TenantTimeline
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.distributed.fault import HeartbeatMonitor, StragglerDetector
from repro_torch.obs.telemetry import Telemetry, get_telemetry, record_timeline
from repro_torch.serving.engine import ServingEngine

MODES = ("continuous", "overlapped", "blocking")


@dataclasses.dataclass
class Request:
    tenant: str
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    # per-request sampling: None temperature inherits the engine default;
    # top_k=0 disables truncation
    temperature: Optional[float] = None
    top_k: int = 0
    seed: int = 0
    arrival_s: float = dataclasses.field(default_factory=time.perf_counter)
    # priority tier (0 = highest; lower tiers are admitted first) and an
    # optional absolute-deadline hint used to order same-tier admissions
    priority: int = 1
    deadline_s: Optional[float] = None
    extra_inputs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class Response:
    tenant: str
    tokens: np.ndarray
    latency_s: float
    batch_size: int
    # terminal outcome: "completed" (tokens valid) or "rejected" (admission
    # retry budget or deadline shed; tokens empty)
    outcome: str = "completed"
    ttft_s: Optional[float] = None   # first collected token minus arrival
    priority: int = 1


@dataclasses.dataclass
class _InflightRound:
    """One dispatched continuous-batching micro-round."""
    handle: Any                      # continuous.RoundHandle
    entry: TenantTimeline
    stamped: Any


def _later_slice(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with {slice_} of the port "
                               "(ROADMAP.md)")


class MultiTenantScheduler:
    """Tenant admission over one shared continuous-batching engine
    (round-robin or straggler-priority; see the module docstring)."""

    def __init__(self, engine: ServingEngine,
                 tenancy: Optional[TenancyConfig] = None,
                 straggler_priority: bool = False,
                 mode: str = "continuous",
                 continuous: Optional[Dict[str, Any]] = None,
                 continuous_engine: Optional[Any] = None,
                 preemption: bool = False,
                 max_backlog: Optional[int] = None,
                 admission_retry_limit: int = 8,
                 heartbeat_timeout_s: float = 300.0,
                 telemetry: Optional[Telemetry] = None,
                 device=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if mode != "continuous":
            raise _later_slice(f"the {mode!r} schedule", "a later slice")
        if preemption:
            raise _later_slice("swap preemption", "slice 3")
        if max_backlog is not None:
            raise _later_slice("backlog shedding (max_backlog)", "slice 3")
        self.engine = engine
        self.tel = get_telemetry(telemetry)
        self.tenancy = tenancy or TenancyConfig(1, 2)
        self.straggler_priority = straggler_priority
        self.mode = mode
        self.queues: Dict[str, Deque[Request]] = collections.defaultdict(
            collections.deque)
        self.detector = StragglerDetector()
        self.stats: Dict[str, Dict[str, float]] = collections.defaultdict(
            lambda: {"requests": 0, "tokens": 0, "busy_s": 0.0,
                     "rejected": 0, "shed": 0})
        self.timeline: List[TenantTimeline] = []
        self._order: List[str] = []
        self._slot_of: Dict[str, int] = {}
        self._waiter: Optional[CompletionWaiter] = None
        self._last_ready = 0.0           # previous round's compute_end
        self._round_served: set = set()
        self._recent: Dict[str, float] = {}   # EWMA per-request seconds
        self._t0 = time.perf_counter()
        if continuous_engine is not None:
            self._ceng = continuous_engine
        else:
            from repro_torch.serving.continuous import \
                ContinuousBatchingEngine
            ckw = dict(continuous or {})
            ckw.setdefault("telemetry", telemetry)
            if device is not None:
                ckw.setdefault("device", device)
            self._ceng = ContinuousBatchingEngine(engine, **ckw)
        self._cont_inflight: Optional[_InflightRound] = None
        self._cont_rounds = 0
        self._row_busy: Dict[int, float] = collections.defaultdict(float)
        self.admission_retry_limit = int(admission_retry_limit)
        self.heartbeat = HeartbeatMonitor(timeout_s=heartbeat_timeout_s)
        self.heartbeat_suspects = 0
        self.rejected: List[Request] = []
        self._terminal: List[Response] = []   # awaiting emission via step()
        self._adm_clock = 0             # admission passes (backoff clock)
        self._attempts: Dict[int, int] = {}       # id(req) -> failed admits
        self._backoff: Dict[int, int] = {}        # id(req) -> eligible clock
        self._tenant_steps: Dict[str, int] = collections.defaultdict(int)
        # one entry per admitted request (transfer window = its admission
        # batch's host window), kept apart from the round timeline
        self.admission_timeline: List[TenantTimeline] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._register_tenant(req.tenant)
        self.queues[req.tenant].append(req)

    def _register_tenant(self, tenant: str) -> None:
        if tenant not in self._order:
            self._slot_of[tenant] = len(self._order)
            self._order.append(tenant)

    def pending(self) -> int:
        n = sum(len(q) for q in self.queues.values())
        n += self._ceng.active_count()   # admitted, not yet retired rows
        n += len(self._terminal)         # terminal responses to emit
        return n

    def close(self) -> None:
        """Reap the completion-waiter thread (daemon, so optional)."""
        if self._waiter is not None:
            self._waiter.close()
            self._waiter = None

    def _get_waiter(self) -> CompletionWaiter:
        if self._waiter is None:
            self._waiter = CompletionWaiter(
                lambda: time.perf_counter() - self._t0,
                name="serving-waiter")
        return self._waiter

    # ------------------------------------------------------------------
    # EWMA weight for per-tenant recent latency (straggler-priority pick)
    _RECENT_ALPHA = 0.5

    def _recent_s(self, tenant: str) -> float:
        return self._recent.get(tenant, 0.0)

    def _note_batch_time(self, tenant: str, per_req_s: float) -> None:
        """EWMA of per-request time: tracks *recent* speed."""
        prev = self._recent.get(tenant)
        a = self._RECENT_ALPHA
        self._recent[tenant] = (per_req_s if prev is None
                                else a * per_req_s + (1 - a) * prev)

    def _next_tenant(self) -> Optional[str]:
        if self.straggler_priority:
            backlog = [t for t in self._order if self.queues[t]]
            if not backlog:
                return None
            # slowest recent tenant first *within a round*: every tenant
            # with backlog is served once before any tenant repeats
            fresh = [t for t in backlog if t not in self._round_served]
            if not fresh:
                self._round_served.clear()
                fresh = backlog
            pick = max(fresh, key=self._recent_s)
            self._round_served.add(pick)
            return pick
        for _ in range(len(self._order)):
            t = self._order.pop(0)
            self._order.append(t)
            if self.queues[t]:
                return t
        return None

    # ------------------------------------------------------------------
    @staticmethod
    def _prio(req: Any) -> int:
        return int(getattr(req, "priority", 1))

    @staticmethod
    def _deadline(req: Any) -> float:
        d = getattr(req, "deadline_s", None)
        return float("inf") if d is None else float(d)

    def _reject(self, req: Request, shed: bool = False) -> None:
        """Terminal REJECTED outcome: an empty response surfaced through
        :meth:`step` (and counted per tenant), never a silent drop."""
        self.rejected.append(req)
        st = self.stats[req.tenant]
        st["rejected"] += 1
        self.tel.count("sched.rejected")
        if shed:
            st["shed"] += 1
            self.tel.count("sched.shed")
        self._attempts.pop(id(req), None)
        self._backoff.pop(id(req), None)
        self._terminal.append(Response(
            req.tenant, np.zeros((0,), np.int32),
            time.perf_counter() - req.arrival_s, 0, outcome="rejected",
            priority=self._prio(req)))

    def _pop_terminal(self, responses: Optional[List[Response]] = None
                      ) -> List[Response]:
        out = list(responses or [])
        if self._terminal:
            out.extend(self._terminal)
            self._terminal.clear()
        return out

    def _tenant_pages(self) -> Dict[str, int]:
        """Pages currently held per tenant (fair-share accounting input)."""
        held: Dict[str, int] = collections.defaultdict(int)
        eng = self._ceng
        for c, s in enumerate(eng._slots):
            if s is not None:
                held[s.req.tenant] += len(eng.kv.owned_pages(c))
        return held

    def _over_share(self, held: Dict[str, int]) -> Dict[str, bool]:
        """Per-tenant fair-share check: over-share means holding strictly
        more pages than usable_pages / active_tenants."""
        eng = self._ceng
        active = {t for t, q in self.queues.items() if q} | set(held)
        if not active:
            return {}
        share = (eng.kv.num_pages - eng.kv.RESERVED) / len(active)
        return {t: held.get(t, 0) > share for t in active}

    def _pick_continuous(self, budget: int) -> List[Request]:
        """Pick up to ``budget`` queue heads for this admission batch: plain
        rotation / straggler order when every head shares one priority
        tier, nobody is in backoff and no fair-share conflict exists;
        otherwise by (priority tier, page over-share, deadline, row-steps
        consumed, tenant order).  Queued requests already past their
        deadline are shed first (terminal REJECTED)."""
        now = time.perf_counter()
        for q in self.queues.values():
            for req in [r for r in q if self._deadline(r) < now]:
                q.remove(req)
                self._reject(req, shed=True)
        picked: List[Request] = []
        while len(picked) < budget:
            heads = [(t, q[0]) for t, q in self.queues.items()
                     if q and self._adm_clock >= self._backoff.get(
                         id(q[0]), 0)]
            if not heads:
                break
            backoff_free = not any(id(q[0]) in self._backoff
                                   for q in self.queues.values() if q)
            over = self._over_share(self._tenant_pages())
            flags = [over.get(t, False) for t, _ in heads]
            conflict = any(flags) and not all(flags)
            if (backoff_free and not conflict
                    and len({self._prio(r) for _, r in heads}) == 1):
                tenant = self._next_tenant()
                if tenant is None:
                    break
                picked.append(self.queues[tenant].popleft())
                continue
            tenant, _ = min(heads, key=lambda tr: (
                self._prio(tr[1]), over.get(tr[0], False),
                self._deadline(tr[1]), self._tenant_steps[tr[0]],
                self._order.index(tr[0])))
            picked.append(self.queues[tenant].popleft())
        return picked

    def _admit_continuous(self) -> int:
        """Admit queued requests into free slots as one batch.  Rejected
        picks are requeued at the front of their tenant's queue; when
        nothing is in flight and nothing was admitted (so no retirement can
        free pages), failed picks count against the bounded retry budget
        and reject terminally past it."""
        with self.tel.span("sched.admit",
                           backlog=sum(len(q) for q in
                                       self.queues.values())) as sp:
            n = self._admit_continuous_inner()
            sp.note(admitted=n)
            return n

    def _admit_continuous_inner(self) -> int:
        eng = self._ceng
        self._adm_clock += 1
        admitted = 0
        picked = self._pick_continuous(eng.free_slot_count())
        if not picked:
            return 0
        t0 = time.perf_counter() - self._t0
        flags = eng.try_admit_batch(picked)
        t1 = time.perf_counter() - self._t0
        failures: List[Request] = []
        for req, ok in zip(picked, flags):
            if ok:
                admitted += 1
                self._attempts.pop(id(req), None)
                self._backoff.pop(id(req), None)
                slot = self._slot_of[req.tenant]
                entry = TenantTimeline(
                    vdev=slot, pdev=eng.pdev, slot=slot,
                    transfer_start=t0, transfer_end=t1,
                    compute_start=t1, compute_end=t1)
                self.admission_timeline.append(entry)
                record_timeline(self.tel, entry, base=self._t0,
                                prefix="admission", tenant=req.tenant,
                                nv=self.tenancy.n_vdev)
            else:
                failures.append(req)
        hopeless = (admitted == 0 and eng.active_count() == 0
                    and self._cont_inflight is None)
        still: List[Request] = []
        for req in failures:
            if not hopeless:
                still.append(req)
                continue
            n = self._attempts.get(id(req), 0) + 1
            if n > self.admission_retry_limit:
                self._reject(req)
                continue
            self._attempts[id(req)] = n
            self._backoff[id(req)] = self._adm_clock + min(1 << (n - 1), 16)
            still.append(req)
        for req in reversed(still):
            self.queues[req.tenant].appendleft(req)
            # the pick didn't result in service: keep the tenant's place
            self._round_served.discard(req.tenant)
        return admitted

    def _dispatch_round(self, asm_start: float) -> _InflightRound:
        handle = self._ceng.dispatch_round()
        te = time.perf_counter() - self._t0
        idx = self._cont_rounds
        self._cont_rounds += 1
        entry = TenantTimeline(vdev=idx, pdev=self._ceng.pdev, slot=idx,
                               transfer_start=asm_start, transfer_end=te,
                               compute_start=te, compute_end=0.0)
        stamped = self._get_waiter().submit(handle.done, entry)
        return _InflightRound(handle, entry, stamped)

    def _step_continuous(self) -> Optional[List[Response]]:
        eng = self._ceng
        if self.heartbeat.suspect():
            self.heartbeat_suspects += 1
            if self.tel.enabled:
                self.tel.count("heartbeat.missed")
                self.tel.gauge("heartbeat.suspects", self.heartbeat_suspects)
        if self._cont_inflight is None:
            asm0 = time.perf_counter() - self._t0
            admitted = self._admit_continuous()
            if admitted == 0 and eng.active_count() == 0:
                # nothing in flight and nothing admitted: queued heads are
                # in bounded retry/backoff, so drain() still progresses
                return self._pop_terminal() or None
            self._cont_inflight = self._dispatch_round(asm0)
        cur = self._cont_inflight
        # retire-before-dispatch: when round k has already landed, retire
        # its finished rows now so this step's admissions can use them
        res = eng.collect(cur.handle) if cur.handle.ready() else None
        # overlap point: the next round's admissions and its dispatch land
        # here, while round k may still occupy the device
        asm0 = time.perf_counter() - self._t0
        admitted = self._admit_continuous()
        live = eng.live_after(0 if res is not None else eng.inner_steps)
        self._cont_inflight = (self._dispatch_round(asm0)
                               if admitted or live else None)
        if res is None:
            res = eng.collect(cur.handle)
        self.heartbeat.beat()                    # round k landed
        self.tel.count("heartbeat.beats")
        cur.stamped.wait()
        cur.entry.compute_start = max(cur.entry.compute_start,
                                      min(self._last_ready,
                                          cur.entry.compute_end))
        self._last_ready = cur.entry.compute_end
        self.timeline.append(cur.entry)
        record_timeline(self.tel, cur.entry, base=self._t0,
                        nv=self.tenancy.n_vdev)
        # busy attribution: the round's window split across tenants by
        # live row-steps (masked lanes bill nobody)
        busy = cur.entry.compute_end - cur.entry.compute_start
        total_steps = int(res.active_steps.sum())
        if total_steps > 0:
            for c, req in enumerate(res.slot_reqs):
                if req is None or res.active_steps[c] == 0:
                    continue
                share = busy * float(res.active_steps[c]) / total_steps
                self.stats[req.tenant]["busy_s"] += share
                self._row_busy[c] += share
                self._tenant_steps[req.tenant] += int(res.active_steps[c])
        done_abs = self._t0 + cur.entry.compute_end
        responses: List[Response] = []
        for (req, tokens, c), srec in zip(res.finished, res.retired):
            st = self.stats[req.tenant]
            st["requests"] += 1
            st["tokens"] += tokens.size
            row_busy = self._row_busy.pop(c, 0.0)
            self._note_batch_time(req.tenant, row_busy)
            self.detector.update({self._slot_of[req.tenant]: row_busy})
            ttft = (None if srec.t_first is None
                    else srec.t_first - req.arrival_s)
            responses.append(Response(
                req.tenant, tokens, done_abs - req.arrival_s, 1,
                ttft_s=ttft, priority=self._prio(req)))
        return self._pop_terminal(responses)

    # ------------------------------------------------------------------
    def step(self) -> Optional[List[Response]]:
        """Serve one scheduling step: one decode micro-round; returns the
        rows that retired in it (None if idle)."""
        with self.tel.span("sched.step", mode=self.mode) as sp:
            r = self._step_continuous()
            sp.note(responses=0 if r is None else len(r))
            return r

    def drain(self) -> List[Response]:
        out: List[Response] = []
        while self.pending():
            r = self.step()
            if r:
                out.extend(r)
        self._ceng.kv.assert_conserved()
        self.close()
        return out

    @property
    def continuous_engine(self):
        """The scheduler's ContinuousBatchingEngine."""
        return self._ceng

    def utilization_report(self) -> Dict[str, Dict[str, float]]:
        total_busy = sum(s["busy_s"] for s in self.stats.values())
        return {t: dict(s, busy_share=(s["busy_s"] / total_busy
                                       if total_busy else 0.0))
                for t, s in self.stats.items()}
