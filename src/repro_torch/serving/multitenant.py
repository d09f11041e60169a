"""Multi-tenant serving scheduler (the paper's second multi-tenancy reading:
several applications share one physical accelerator).

The JAX package's ``repro/serving/multitenant.py``.  Each tenant owns a
request queue; the scheduler serves them on one shared engine under one of
three schedules (``mode=``):

* ``"overlapped"`` (the default) -- tenant-slot batching on the engine's
  split ``dispatch``/``await_result`` halves: while tenant k's decode loop
  occupies the device, the host assembles, stages and dispatches up to
  ``stage_depth`` further tenant batches (a batch is up to ``max_batch`` of
  one tenant's requests, prompts right-aligned to the longest).  Tenants
  are time-sharing virtual GPUs of one device.
* ``"blocking"`` -- ``engine.generate`` per slot, stage-ahead limited to
  the host-side assembly of the next batch: the A/B baseline.
* ``"continuous"`` -- continuous batching over the persistent slot table of
  a :class:`repro_torch.serving.continuous.ContinuousBatchingEngine`.
  Every scheduling step

  1. admits queued requests into free slots -- picked round-robin or
     straggler-first across tenants, or, when queue heads span priority
     tiers, a tenant is over its fair share of the paged pool, or a head is
     in admission backoff, by ``(priority, over-share, deadline, row-steps
     consumed)`` -- all picks admitted as one batch;
  2. dispatches one masked decode micro-round over all slots while the
     previous round may still occupy the device (when that round has
     already landed it is collected first, so its finished rows free their
     slots and pages for this step's admissions);
  3. collects the previous round, retires finished rows and splits the
     round's device window across tenants by live row-steps.

  An admission the pool refuses re-queues; when nothing is in flight it
  counts against a bounded retry budget with exponential backoff and ends
  in a terminal ``REJECTED`` response past it, and a queued request past
  its deadline is shed the same way -- ``drain()`` returns one response per
  request.  A :class:`repro_torch.distributed.fault.HeartbeatMonitor` is
  beaten per collected round.

Slot selection is straggler-aware: with ``straggler_priority=True`` the
tenant with the slowest recent per-request time is served first, every
backlogged tenant once per round.  In the overlapped schedule the EWMA is
stamped as soon as a completion has landed, before the next pick
(:meth:`MultiTenantScheduler._harvest_ready`).

Per-slot (or per-round) :class:`repro_torch.core.pipeline.TenantTimeline`
entries -- transfer window = batch assembly or admission through dispatch
on the host, compute window = dispatch -> device-ready, stamped by a
:class:`repro_torch.core.pipeline.CompletionWaiter` on the CUDA event --
keep :func:`repro_torch.core.pipeline.timeline_overlaps` falsifiable.  A
slot's compute window opens no earlier than the previous slot's end: a
slot enqueued behind another's decode on the one stream is not billed for
that wait.

Priorities order continuous admission but never preempt: swap preemption,
load shedding by backlog (``max_backlog``), fault injection, the request
journal and engine checkpoints come with slice 3 of the port and raise
``NotImplementedError``.  A batch's extra inputs -- patch embeddings,
encoder frames (zero frames for a whisper request that carries none) --
are stacked per row (``_batch_extras``), in both slot schedules.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import CompletionWaiter, TenantTimeline
from repro_torch.core.tenancy import TenancyConfig, resolve_devices
from repro_torch.distributed.fault import HeartbeatMonitor, StragglerDetector
from repro_torch.obs.telemetry import Telemetry, get_telemetry, record_timeline
from repro_torch.serving.engine import (GenerationResult, PendingGeneration,
                                        ServingEngine, resolve_extra_inputs)

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
class _Inflight:
    """One dispatched tenant slot: requests + handle + its timeline entry
    (compute_end stamped by the CompletionWaiter at device readiness)."""
    tenant: str
    reqs: List[Request]
    handle: PendingGeneration
    entry: TenantTimeline
    stamped: Any                     # threading.Event from the waiter
    accounted: bool = False          # EWMA/busy already stamped (harvest)


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
    """Tenant batching over one shared engine (round-robin or
    straggler-priority) under an overlapped, blocking or continuous
    schedule (see the module docstring).  ``mode=None`` is
    ``"overlapped"`` unless ``overlapped=False``."""

    def __init__(self, engine: ServingEngine, max_batch: int = 8,
                 tenancy: Optional[TenancyConfig] = None,
                 straggler_priority: bool = False,
                 overlapped: bool = True,
                 mode: Optional[str] = None,
                 stage_depth: int = 1,
                 continuous: Optional[Dict[str, Any]] = None,
                 continuous_engine: Optional[Any] = None,
                 preemption: bool = False,
                 max_backlog: Optional[int] = None,
                 admission_retry_limit: int = 8,
                 heartbeat_timeout_s: float = 300.0,
                 telemetry: Optional[Telemetry] = None,
                 device=None):
        self.mode = mode or ("overlapped" if overlapped else "blocking")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if preemption:
            raise _later_slice("swap preemption", "slice 3")
        if max_backlog is not None:
            raise _later_slice("backlog shedding (max_backlog)", "slice 3")
        if device is not None:
            dev = resolve_devices(1, device)[0]        # raises: no card
            if dev != engine.device:
                raise ValueError(f"device {dev}: the engine's parameters "
                                 f"live on {engine.device}")
        self.engine = engine
        self.tel = get_telemetry(telemetry)
        self.max_batch = max_batch
        self.tenancy = tenancy or TenancyConfig(1, 2)
        self.straggler_priority = straggler_priority
        self.overlapped = self.mode == "overlapped"
        self.stage_depth = max(int(stage_depth), 1)
        self.queues: Dict[str, Deque[Request]] = collections.defaultdict(
            collections.deque)
        self.detector = StragglerDetector()
        self.stats: Dict[str, Dict[str, float]] = collections.defaultdict(
            lambda: {"requests": 0, "tokens": 0, "busy_s": 0.0,
                     "rejected": 0, "shed": 0})
        self.timeline: List[TenantTimeline] = []
        self._order: List[str] = []
        self._slot_of: Dict[str, int] = {}
        # blocking: the next slot's batch (tenant, reqs, prompts, steps),
        # assembled while the previous slot's responses were finalised
        self._prepared: Optional[Tuple[str, List[Request], np.ndarray,
                                       int]] = None
        self._asm_window = (0.0, 0.0)
        # overlapped: dispatched, not yet awaited slots, oldest first; at
        # most 1 + stage_depth (the one awaited and the staged-ahead ones)
        self._inflight: Deque[_Inflight] = collections.deque()
        self._waiter: Optional[CompletionWaiter] = None
        self._last_ready = 0.0           # previous slot's or round's end
        self._round_served: set = set()
        self._recent: Dict[str, float] = {}   # EWMA per-request seconds
        self._t0 = time.perf_counter()
        self._ceng = None
        if self.mode == "continuous":
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
        # continuous: one entry per admitted request (transfer window = its
        # admission batch's host window), kept apart from the round timeline
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
        if self._prepared is not None:   # staged-ahead batch not yet served
            n += len(self._prepared[1])
        n += sum(len(fl.reqs) for fl in self._inflight)   # dispatched slots
        if self._ceng is not None:       # admitted, not yet retired rows
            n += self._ceng.active_count()
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
    # batches of one tenant (the slot schedules)
    # ------------------------------------------------------------------
    def _assemble(self, tenant: str) -> List[Request]:
        q = self.queues[tenant]
        batch = []
        while q and len(batch) < self.max_batch:
            batch.append(q.popleft())
        return batch

    def _build_batch(self, tenant: str
                     ) -> Optional[Tuple[str, List[Request], np.ndarray, int]]:
        reqs = self._assemble(tenant)
        if not reqs:
            return None
        # pad prompts to a common length (right-aligned batch)
        s_max = max(r.prompt.size for r in reqs)
        prompts = np.zeros((len(reqs), s_max), np.int32)
        for i, r in enumerate(reqs):
            prompts[i, s_max - r.prompt.size:] = r.prompt
        return tenant, reqs, prompts, max(r.max_new_tokens for r in reqs)

    def _batch_extras(self, reqs: List[Request]
                      ) -> Optional[Dict[str, np.ndarray]]:
        """Stack the batch's per-request non-token prefill inputs (None when
        no request carries any).  A key missing from some rows is zero-
        filled, so a tenant's extras should be uniform: a text-only row in
        a vision batch gets zero patches merged in (the continuous schedule
        groups by extra names instead and has no such caveat)."""
        cfg = getattr(self.engine, "cfg", None)
        if cfg is None:      # engine test-doubles: no per-arch defaults
            per_req = [dict(getattr(r, "extra_inputs", None) or {})
                       for r in reqs]
        else:
            per_req = [resolve_extra_inputs(cfg, r) for r in reqs]
        names = sorted({k for ex in per_req for k in ex})
        if not names:
            return None
        out = {}
        for name in names:
            proto = next(np.asarray(ex[name]) for ex in per_req
                         if name in ex)
            out[name] = np.stack([np.asarray(ex[name]) if name in ex
                                  else np.zeros_like(proto)
                                  for ex in per_req])
        return out

    def _sampling_kwargs(self, reqs: List[Request]) -> Dict[str, Any]:
        """Per-request sampling arrays for dispatch(); empty when every row
        uses engine defaults so the scalar (token-exact) path keeps
        running."""
        if not any(r.temperature is not None or r.top_k or r.seed
                   for r in reqs):
            return {}
        return {
            "temperatures": [self.engine.temperature if r.temperature is None
                             else r.temperature for r in reqs],
            "top_ks": [r.top_k for r in reqs],
            "seeds": [r.seed for r in reqs],
        }

    # ------------------------------------------------------------------
    # accounting of the slot schedules
    # ------------------------------------------------------------------
    def _account_busy(self, tenant: str, n_reqs: int, busy_s: float) -> None:
        st = self.stats[tenant]
        st["requests"] += n_reqs
        st["busy_s"] += busy_s
        per_req = busy_s / max(n_reqs, 1)
        self._note_batch_time(tenant, per_req)
        # keyed by the stable tenant slot, not a (salted) string hash
        self.detector.update({self._slot_of[tenant]: per_req})

    def _finalise_windows(self, fl: _Inflight) -> None:
        """Open the slot's compute window at device occupancy and stamp the
        tenant's EWMA/busy accounting; idempotent via ``fl.accounted``,
        callable once the waiter has stamped ``compute_end``.

        The slot was enqueued behind the previous slot's decode on the one
        stream, and that wait must not be billed to this tenant.  Slots
        complete in dispatch order, so the previous ``compute_end`` is
        known here, and the clamp can only move ``compute_start`` earlier
        than the next slot's ``transfer_start``, never past it (the overlap
        predicate stays falsifiable)."""
        fl.entry.compute_start = max(fl.entry.compute_start,
                                     min(self._last_ready,
                                         fl.entry.compute_end))
        self._last_ready = fl.entry.compute_end
        self._account_busy(fl.tenant, len(fl.reqs),
                           fl.entry.compute_end - fl.entry.compute_start)
        fl.accounted = True

    def _harvest_ready(self) -> None:
        """Stamp the accounting of in-flight slots whose decode has landed
        (in dispatch order, up to the first unstamped one) before a pick,
        so a straggler-priority pick sees the freshest latency."""
        for fl in self._inflight:
            if not fl.stamped.is_set():
                break
            if not fl.accounted:
                self._finalise_windows(fl)

    # ------------------------------------------------------------------
    # overlapped schedule: depth-N staging under the head slot's decode
    # ------------------------------------------------------------------
    def _launch_next(self) -> Optional[_Inflight]:
        """Assemble, stage and dispatch the next tenant slot (no waiting).
        Transfer window: batch assembly through dispatch return; compute
        window: dispatch return until the waiter sees the slot's event."""
        self._harvest_ready()
        tenant = self._next_tenant()
        if tenant is None:
            return None
        asm_start = time.perf_counter() - self._t0
        # _next_tenant only returns tenants with backlog
        tenant, reqs, prompts, steps = self._build_batch(tenant)
        handle = self.engine.dispatch(prompts, steps,
                                      extra_inputs=self._batch_extras(reqs),
                                      **self._sampling_kwargs(reqs))
        te = time.perf_counter() - self._t0
        slot = self._slot_of[tenant]
        entry = TenantTimeline(vdev=slot, pdev=0, slot=slot,
                               transfer_start=asm_start, transfer_end=te,
                               compute_start=te, compute_end=0.0)
        stamped = self._get_waiter().submit(handle.done, entry)
        return _Inflight(tenant, reqs, handle, entry, stamped)

    def _fill_inflight(self) -> None:
        """Top the dispatch queue up to 1 + stage_depth slots: the head (next
        to be awaited) and stage_depth batches staged under its decode."""
        while len(self._inflight) < 1 + self.stage_depth:
            nxt = self._launch_next()
            if nxt is None:
                return
            self._inflight.append(nxt)

    def _step_overlapped(self) -> Optional[List[Response]]:
        # overlap point: everything beyond the head is assembled and
        # dispatched here, while the head's decode loop runs on the device
        self._fill_inflight()
        if not self._inflight:
            return None
        cur = self._inflight.popleft()
        result = self.engine.await_result(cur.handle)
        cur.stamped.wait()           # compute_end stamped at device-ready
        if not cur.accounted:        # else already stamped by a harvest
            self._finalise_windows(cur)
        self.stats[cur.tenant]["tokens"] += result.tokens.size
        self.timeline.append(cur.entry)
        record_timeline(self.tel, cur.entry, base=self._t0,
                        tenant=cur.tenant, nv=self.tenancy.n_vdev)
        done_abs = self._t0 + cur.entry.compute_end
        return [Response(cur.tenant, result.tokens[i],
                         done_abs - r.arrival_s, len(cur.reqs))
                for i, r in enumerate(cur.reqs)]

    # ------------------------------------------------------------------
    # blocking schedule (the A/B baseline): generate() per slot
    # ------------------------------------------------------------------
    def _stage_next(self) -> None:
        if self._prepared is None:
            tenant = self._next_tenant()
            if tenant is not None:
                asm_start = time.perf_counter() - self._t0
                self._prepared = self._build_batch(tenant)
                self._asm_window = (asm_start,
                                    time.perf_counter() - self._t0)

    def _step_blocking(self) -> Optional[List[Response]]:
        self._stage_next()
        if self._prepared is None:
            return None
        tenant, reqs, prompts, steps = self._prepared
        self._prepared = None
        asm_start, asm_end = self._asm_window
        t0 = time.perf_counter()
        result: GenerationResult = self.engine.generate(
            prompts, steps, extra_inputs=self._batch_extras(reqs))
        # service completion: before the stage-ahead below, so the compute
        # window and latencies do not absorb the next slot's assembly (and
        # the stage-ahead pick sees this batch's latency)
        done = time.perf_counter()
        self._account_busy(tenant, len(reqs), done - t0)
        self.stats[tenant]["tokens"] += result.tokens.size
        # stage-ahead: the next slot's batch, before this slot's responses
        self._stage_next()
        entry = TenantTimeline(
            vdev=self._slot_of[tenant], pdev=0, slot=self._slot_of[tenant],
            transfer_start=asm_start, transfer_end=asm_end,
            compute_start=t0 - self._t0, compute_end=done - self._t0)
        self.timeline.append(entry)
        record_timeline(self.tel, entry, base=self._t0, tenant=tenant,
                        nv=self.tenancy.n_vdev)
        return [Response(tenant, result.tokens[i], done - r.arrival_s,
                         len(reqs)) for i, r in enumerate(reqs)]

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
        """Serve one scheduling step; returns responses (None if idle).
        Overlapped/blocking: one tenant slot.  Continuous: one decode
        micro-round (responses are the rows that retired in it)."""
        with self.tel.span("sched.step", mode=self.mode) as sp:
            r = self._step_inner()
            sp.note(responses=0 if r is None else len(r))
            return r

    def _step_inner(self) -> Optional[List[Response]]:
        if self.mode == "continuous":
            return self._step_continuous()
        if self.mode == "overlapped":
            return self._step_overlapped()
        return self._step_blocking()

    def drain(self) -> List[Response]:
        out: List[Response] = []
        while self.pending():
            r = self.step()
            if r:
                out.extend(r)
        if self._ceng is not None:
            self._ceng.kv.assert_conserved()
        self.close()
        return out

    @property
    def continuous_engine(self):
        """The scheduler's ContinuousBatchingEngine (None outside
        ``mode="continuous"``)."""
        return self._ceng

    def utilization_report(self) -> Dict[str, Dict[str, float]]:
        total_busy = sum(s["busy_s"] for s in self.stats.values())
        return {t: dict(s, busy_share=(s["busy_s"] / total_busy
                                       if total_busy else 0.0))
                for t, s in self.stats.items()}
