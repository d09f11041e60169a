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

Overload (continuous mode), as the reference's:

* **priority + fair share** -- a :class:`Request` carries a ``priority``
  tier (0 highest) and an optional ``deadline_s``; admission orders by
  them when the heads span tiers (above).  Past ``max_backlog`` queued
  requests, the lowest-priority, furthest-deadline, newest queued work is
  shed (``REJECTED``, counted in ``shed``).
* **preemption via KV tiering** -- when a higher-priority request cannot
  admit and a strictly lower-priority row is live, the scheduler collects
  the round in flight (preemption needs a quiesced engine) and swaps the
  victim out (:meth:`repro_torch.serving.continuous.
  ContinuousBatchingEngine.preempt`).  Swapped requests wait in a restore
  queue served before fresh picks of their own or lower tiers, their
  records prefetched ``restore_prefetch`` at a time, and resume
  token-exactly.  Every state kind swaps.
* **faults** -- a :class:`repro_torch.distributed.fault.FaultPlane` drops
  rounds, stalls admissions and poisons swap reads; each injection raises
  before state changes and feeds a retry/limit policy
  (``round_fault_limit``): past it requests end ``FAILED``.

Every request ends in exactly one outcome -- ``completed``, ``rejected`` or
``failed`` -- and ``drain()`` returns a response for each, with its
``ttft_s`` and ``preemptions``.

Crash safety (continuous mode): ``journal=`` (a path or a
:class:`repro_torch.serving.journal.JournalWriter`) writes every submission,
admission, collected round, retirement, rejection, failure, preemption,
restore and checkpoint ahead of the mutation; with ``checkpoint_dir`` and
``checkpoint_every=K`` the whole serving state -- every live slot's record,
the host swap tier, the queues, the restore queue -- is saved every K
collected rounds (the engine quiesced: one pipeline bubble a checkpoint).
:meth:`MultiTenantScheduler.recover` rebuilds a fresh scheduler and engine
from the (journal, latest checkpoint) pair and replays the rounds past it.

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

A batch's extra inputs -- patch embeddings,
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
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.distributed.fault import (HeartbeatMonitor, InjectedFault,
                                           StragglerDetector)
from repro_torch.obs.telemetry import Telemetry, get_telemetry, record_timeline
from repro_torch.serving import journal as journal_mod
from repro_torch.serving.engine import (GenerationResult, PendingGeneration,
                                        ServingEngine, resolve_extra_inputs)
from repro_torch.serving.journal import JournalWriter, RecoverySummary
from repro_torch.serving.swap import (swap_record_from_payload,
                                      swap_record_to_payload)

MODES = ("continuous", "overlapped", "blocking")
OUTCOMES = ("completed", "rejected", "failed")


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
    # priority tier (0 = highest; lower tiers are admitted first, shed
    # last, and preempt higher numbers) and an optional absolute-deadline
    # hint used to order same-tier admissions and pick shedding victims
    priority: int = 1
    deadline_s: Optional[float] = None
    extra_inputs: Optional[Dict[str, Any]] = None
    # the scheduler's id for it, set at submit (the journal's rid)
    rid: int = -1
    # perf_counter start of the admission pass that admitted it
    admitted_s: Optional[float] = None


@dataclasses.dataclass
class Response:
    tenant: str
    tokens: np.ndarray
    latency_s: float
    batch_size: int
    # terminal outcome: "completed" (tokens valid), "rejected" (admission
    # retry budget or load shed; tokens empty) or "failed" (fault-injection
    # limit exceeded; tokens empty)
    outcome: str = "completed"
    ttft_s: Optional[float] = None   # first collected token minus arrival
    priority: int = 1
    preemptions: int = 0             # times the row was swapped out
    rid: int = -1                    # the request's id (its spans carry it)


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


def _remove(q: Deque[Request], req: Request) -> None:
    """Remove ``req`` itself from ``q``.  ``deque.remove`` compares by
    ``==``, which on two requests of one tenant compares their prompt
    arrays and raises (the reference sheds only queue heads safely)."""
    for i, r in enumerate(q):
        if r is req:
            del q[i]
            return


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
                 preemption: bool = True,
                 max_backlog: Optional[int] = None,
                 admission_retry_limit: int = 8,
                 round_fault_limit: int = 3,
                 fault_plane: Optional[Any] = None,
                 heartbeat_timeout_s: float = 300.0,
                 restore_prefetch: int = 4,
                 telemetry: Optional[Telemetry] = None,
                 journal: Optional[Any] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 checkpoint_keep: int = 3,
                 device=None):
        self.mode = mode or ("overlapped" if overlapped else "blocking")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if self.mode != "continuous" and (journal is not None
                                          or checkpoint_dir is not None):
            # only the continuous collect loop journals ROUND_COMMIT and
            # RETIRE: a journal of another mode would replay every
            # completed request as pending
            raise ValueError(
                "journal/checkpoint_dir require mode='continuous' "
                f"(got mode={self.mode!r})")
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
                     "rejected": 0, "failed": 0, "preempted": 0, "shed": 0})
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
                if fault_plane is not None:
                    ckw.setdefault("fault_plane", fault_plane)
                ckw.setdefault("telemetry", telemetry)
                if device is not None:
                    ckw.setdefault("device", device)
                self._ceng = ContinuousBatchingEngine(engine, **ckw)
        self._cont_inflight: Optional[_InflightRound] = None
        self._cont_rounds = 0
        self._row_busy: Dict[int, float] = collections.defaultdict(float)
        # ---- overload survival (continuous mode) ----
        self.preemption = preemption
        self.max_backlog = max_backlog
        self.admission_retry_limit = int(admission_retry_limit)
        self.round_fault_limit = int(round_fault_limit)
        self.restore_prefetch = max(int(restore_prefetch), 1)
        self.fault_plane = fault_plane or getattr(self._ceng, "fault_plane",
                                                  None)
        self.heartbeat = HeartbeatMonitor(timeout_s=heartbeat_timeout_s)
        self.heartbeat_suspects = 0
        self.faults_survived = 0        # injected faults retried past
        self.rejected: List[Request] = []
        self.failed: List[Request] = []
        self._terminal: List[Response] = []   # awaiting emission via step()
        self._adm_clock = 0             # admission passes (backoff clock)
        self._attempts: Dict[int, int] = {}       # id(req) -> failed admits
        self._backoff: Dict[int, int] = {}        # id(req) -> eligible clock
        self._restore_q: List[int] = []           # swap tickets to re-admit
        self._ticket_attempts: Dict[int, int] = {}
        self._ticket_backoff: Dict[int, int] = {}
        self._tenant_steps: Dict[str, int] = collections.defaultdict(int)
        self._round_fault_streak = 0
        self._admission_blocked = False
        # continuous: one entry per admitted request (transfer window = its
        # admission batch's host window), kept apart from the round timeline
        self.admission_timeline: List[TenantTimeline] = []
        # ---- crash safety (continuous mode) ----
        self.journal: Optional[JournalWriter] = None
        if journal is not None:
            self.journal = (journal if isinstance(journal, JournalWriter)
                            else JournalWriter(str(journal),
                                               telemetry=telemetry))
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_keep = int(checkpoint_keep)
        self.checkpoints_taken = 0
        self._next_rid = 0                    # the next submitted request's rid
        self._committed_rounds = 0            # collected decode rounds
        self._last_ckpt_round = 0
        self._ckpt_step = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.rid = self._next_rid
        self._next_rid += 1
        # write-ahead: the SUBMIT record is on disk before the queue
        # mutation, so a crash between the two re-queues the request
        if self.journal is not None:
            self.journal.append(
                "SUBMIT", **journal_mod.request_to_record(req.rid, req))
        self._enqueue(req)

    def _register_tenant(self, tenant: str) -> None:
        if tenant not in self._order:
            self._slot_of[tenant] = len(self._order)
            self._order.append(tenant)

    def _enqueue(self, req: Request) -> None:
        self._register_tenant(req.tenant)
        self.queues[req.tenant].append(req)

    # ------------------------------------------------------------------
    # crash safety: journal hooks (no-ops without a journal)
    # ------------------------------------------------------------------
    @staticmethod
    def _rid(req: Any) -> int:
        return getattr(req, "rid", -1)

    def _journal(self, kind: str, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.append(kind, **fields)

    def _journal_admits(self, reqs: List[Request]) -> None:
        """ADMIT records for freshly admitted picks (the slot-table rows
        these request objects landed in)."""
        if self.journal is None or not reqs:
            return
        want = {id(r) for r in reqs}
        for c, s in enumerate(self._ceng._slots):
            if s is not None and id(s.req) in want:
                self.journal.append(
                    "ADMIT", rid=self._rid(s.req), slot=int(c),
                    bucket=int(s.bucket), ring=int(s.ring))

    def _journal_round(self, res: Any) -> None:
        """One collected round: cumulative emitted token counts of every
        row live in it (retired rows their final count)."""
        self._committed_rounds += 1
        if self.journal is None:
            return
        emitted: Dict[str, int] = {}
        for (req, tokens, _c), _srec in zip(res.finished, res.retired):
            emitted[str(self._rid(req))] = int(tokens.size)
        for s in self._ceng._slots:
            if s is not None:
                emitted[str(self._rid(s.req))] = len(s.tokens)
        self.journal.append("ROUND_COMMIT", rnd=self._committed_rounds,
                            emitted=emitted)

    # ------------------------------------------------------------------
    # crash safety: engine checkpoint + recovery (continuous mode)
    # ------------------------------------------------------------------
    def _checkpoint_due(self, pending: int = 0) -> bool:
        """``pending`` counts rounds collected but not yet journalled at the
        call site (the dispatch-suppression check runs before the current
        round's ROUND_COMMIT), so a checkpoint lands every K rounds, not
        K+1."""
        return (self.checkpoint_dir is not None
                and self.checkpoint_every > 0
                and self._committed_rounds + pending - self._last_ckpt_round
                >= self.checkpoint_every)

    def save_checkpoint(self) -> int:
        """Save the whole serving state (engine quiesced: no round in
        flight): one :class:`~repro_torch.serving.swap.SwapRecord` payload
        per live slot (the preemption snapshot, vacating nothing) and the
        host tier's records under their tickets, plus the queued requests in
        admission order, the restore queue, ticket retry budgets and the
        trie's chain keys; written atomically by
        :func:`repro_torch.distributed.checkpoint.save_engine_checkpoint`,
        then journalled as a CHECKPOINT record (the recovery baseline)."""
        eng = self._ceng
        assert eng is not None and self._cont_inflight is None, \
            "engine checkpoint requires a quiesced continuous engine"
        step = self._ckpt_step
        self._ckpt_step += 1
        arrays: Dict[str, Any] = {}

        def payload(rec, key: str, prefix: str) -> Dict[str, Any]:
            m, arrs = swap_record_to_payload(
                rec, journal_mod.request_to_record(self._rid(rec.req),
                                                   rec.req))
            for k, v in arrs.items():
                arrays[f"{prefix}/{k}"] = v
            return {key: int(prefix.split("/")[1]),
                    "rid": self._rid(rec.req), "rec": m}

        live_meta = [payload(rec, "slot", f"live/{c}")
                     for c, rec in eng.snapshot_live()]
        swapped_meta = []
        if eng.swap_store is not None:
            swapped_meta = [payload(eng.swap_store.record(t), "ticket",
                                    f"swapped/{t}")
                            for t in eng.swap_store.tickets()]
        queued = [journal_mod.request_to_record(self._rid(r), r)
                  for t in self._order for r in self.queues[t]]
        meta = {
            "step": int(step),
            "rounds": int(self._committed_rounds),
            "next_rid": int(self._next_rid),
            "live": live_meta,
            "swapped": swapped_meta,
            "queued": queued,
            "restore_q": [int(t) for t in self._restore_q],
            "ticket_attempts": {str(k): int(v) for k, v in
                                self._ticket_attempts.items()},
            "trie": [k.hex() for k in eng.kv.trie_keys()],
        }
        ckpt_mod.save_engine_checkpoint(self.checkpoint_dir, step, meta,
                                        arrays,
                                        keep_last=self.checkpoint_keep)
        self._last_ckpt_round = self._committed_rounds
        self.checkpoints_taken += 1
        self._journal("CHECKPOINT", step=int(step),
                      rnd=int(self._committed_rounds))
        if self.tel.enabled:
            self.tel.count("recovery.checkpoints")
        return step

    def recover(self) -> RecoverySummary:
        """Rebuild serving state on a *fresh* scheduler and engine from the
        (journal, latest checkpoint) pair after a crash: checkpointed live
        slots re-enter through the ordinary swap restore, host-tier records
        re-park under their tickets, queued requests re-queue in admission
        order, journalled rids neither terminal nor checkpointed re-queue
        (never lost), and rounds committed after the checkpoint are
        replayed -- seeded sampling regenerates their tokens bit for bit on
        non-MoE archs, and the post-checkpoint RETIRE records become the
        ``replay_check`` oracle.  Wall clocks are process-relative: every
        rebuilt request is stamped with the recovery time."""
        assert self.mode == "continuous", "recover() is continuous-only"
        assert self.journal is not None, "recover() needs a journal"
        eng = self._ceng
        assert eng.active_count() == 0 and not any(
            len(q) for q in self.queues.values()), \
            "recover() must run on a fresh scheduler"
        with self.tel.span("recovery.replay") as sp:
            js = journal_mod.replay(journal_mod.read_journal(
                self.journal.path))
            step = (ckpt_mod.latest_engine_step(self.checkpoint_dir)
                    if self.checkpoint_dir is not None else None)
            meta, arrays = ((None, None) if step is None else
                            ckpt_mod.load_engine_checkpoint(
                                self.checkpoint_dir, step))
            now = time.perf_counter()
            accounted: set = set()
            live_recs: List[Any] = []
            swapped_recs: Dict[int, Any] = {}
            tokens_preserved = 0

            def rebuild(ent: Dict[str, Any], prefix: str):
                sub = {k[len(prefix):]: v for k, v in arrays.items()
                       if k.startswith(prefix)}
                req = journal_mod.request_from_record(ent["rec"]["req"])
                req.arrival_s = now
                self._register_tenant(req.tenant)
                rec = swap_record_from_payload(ent["rec"], sub, req)
                rec.t_first = None
                req.rid = int(ent["rid"])
                accounted.add(int(ent["rid"]))
                return rec

            if meta is not None:
                for ent in meta["live"]:
                    rec = rebuild(ent, f"live/{ent['slot']}/")
                    live_recs.append(rec)
                    tokens_preserved += len(rec.tokens)
                for ent in meta["swapped"]:
                    rec = rebuild(ent, f"swapped/{ent['ticket']}/")
                    swapped_recs[int(ent["ticket"])] = rec
                    tokens_preserved += len(rec.tokens)
            eng.restore_from(live_recs, swapped_recs)
            if meta is not None:
                self._restore_q = [int(t) for t in meta["restore_q"]]
                self._ticket_attempts = {
                    int(k): int(v)
                    for k, v in meta["ticket_attempts"].items()}
                for qrec in meta["queued"]:
                    req = journal_mod.request_from_record(qrec)
                    req.arrival_s = now
                    req.rid = int(qrec["rid"])
                    accounted.add(int(qrec["rid"]))
                    self._enqueue(req)
                self._committed_rounds = max(int(meta["rounds"]),
                                             js.last_round)
                self._ckpt_step = int(meta["step"]) + 1
            else:
                self._committed_rounds = js.last_round
            self._last_ckpt_round = self._committed_rounds
            # journalled but neither terminal nor checkpointed: SUBMIT hit
            # the disk before the crash, so the request re-queues
            requeued = 0
            for rid in js.pending():
                if rid in accounted:
                    continue
                req = journal_mod.request_from_record(js.submitted[rid])
                req.arrival_s = now
                req.rid = rid
                self._enqueue(req)
                requeued += 1
            self._next_rid = max(js.next_rid,
                                 0 if meta is None else int(
                                     meta["next_rid"]))
            already, oracle = {}, {}
            for rid, toks in js.retired_tokens.items():
                (oracle if rid in accounted else already)[rid] = toks
            summary = RecoverySummary(
                checkpoint_step=step,
                restored_live=len(live_recs),
                restored_swapped=len(swapped_recs),
                requeued=requeued,
                already_complete=already,
                replay_check=oracle,
                rounds_replayed=js.rounds_after_checkpoint,
                tokens_preserved=tokens_preserved,
                tokens_replayed=js.tokens_after_checkpoint)
            sp.note(step=-1 if step is None else int(step),
                    restored_live=summary.restored_live,
                    restored_swapped=summary.restored_swapped,
                    requeued=summary.requeued,
                    rounds_replayed=summary.rounds_replayed)
        self._journal("RECOVER", step=-1 if step is None else int(step),
                      restored_live=summary.restored_live,
                      restored_swapped=summary.restored_swapped,
                      requeued=summary.requeued,
                      rounds_replayed=summary.rounds_replayed)
        self.heartbeat.beat()
        return summary

    def pending(self) -> int:
        n = sum(len(q) for q in self.queues.values())
        if self._prepared is not None:   # staged-ahead batch not yet served
            n += len(self._prepared[1])
        n += sum(len(fl.reqs) for fl in self._inflight)   # dispatched slots
        if self._ceng is not None:       # admitted, not yet retired rows
            n += self._ceng.active_count()
        n += len(self._restore_q)        # swapped out, awaiting re-admission
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
                         done_abs - r.arrival_s, len(cur.reqs),
                         rid=self._rid(r))
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
                         len(reqs), rid=self._rid(r))
                for i, r in enumerate(reqs)]

    def _request_spans(self, req: Any, srec: Any) -> None:
        """A retired request's ``sched.queue`` (arrival -> the admission
        pass that admitted it) and ``sched.first_token`` (-> its first
        collected token), written from the stamps it carried."""
        t_adm = getattr(req, "admitted_s", None)
        if t_adm is None or srec.t_first is None:
            return
        attrs = dict(rid=self._rid(req), tenant=req.tenant,
                     prompt=int(np.asarray(req.prompt).size),
                     bucket=srec.bucket)
        self.tel.record_span("sched.queue", req.arrival_s, t_adm, **attrs)
        self.tel.record_span("sched.first_token", t_adm, srec.t_first,
                             **attrs)

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
        self._journal("REJECT", rid=self._rid(req), shed=bool(shed))
        self._attempts.pop(id(req), None)
        self._backoff.pop(id(req), None)
        self._terminal.append(Response(
            req.tenant, np.zeros((0,), np.int32),
            time.perf_counter() - req.arrival_s, 0, outcome="rejected",
            priority=self._prio(req), rid=self._rid(req)))

    def _fail(self, req: Any, preemptions: int = 0) -> None:
        """Terminal FAILED outcome (a fault-injection retry limit was
        exceeded for this request)."""
        self.failed.append(req)
        self.stats[req.tenant]["failed"] += 1
        self.tel.count("sched.failed")
        self._journal("FAIL", rid=self._rid(req),
                      preemptions=int(preemptions))
        self._attempts.pop(id(req), None)
        self._backoff.pop(id(req), None)
        self._terminal.append(Response(
            req.tenant, np.zeros((0,), np.int32),
            time.perf_counter() - req.arrival_s, 0, outcome="failed",
            priority=self._prio(req), preemptions=preemptions,
            rid=self._rid(req)))

    def _pop_terminal(self, responses: Optional[List[Response]] = None
                      ) -> List[Response]:
        out = list(responses or [])
        if self._terminal:
            out.extend(self._terminal)
            self._terminal.clear()
        return out

    def _shed_backlog(self) -> None:
        """Load-shed above the SLO bound: while the queued backlog exceeds
        ``max_backlog``, the lowest-priority, furthest-deadline, newest
        queued request ends REJECTED."""
        if self.max_backlog is None:
            return
        backlog = sum(len(q) for q in self.queues.values())
        while backlog > self.max_backlog:
            victim = None
            for t, q in self.queues.items():
                for r in q:
                    key = (self._prio(r), self._deadline(r), r.arrival_s)
                    if victim is None or key > victim[0]:
                        victim = (key, t, r)
            _, tenant, req = victim
            _remove(self.queues[tenant], req)
            self._reject(req, shed=True)
            backlog -= 1

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
                _remove(q, req)
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

    def _victim_slot(self, prio: int) -> Optional[int]:
        """Preemption victim: the live row with the *largest* priority
        number strictly above ``prio``, ties broken toward the most decode
        budget left.  None when nobody is preemptable."""
        eng = self._ceng
        best = None
        for c, s in enumerate(eng._slots):
            if s is None or s.priority <= prio:
                continue
            key = (-s.priority, -(s.target - len(s.tokens)), c)
            if best is None or key < best[0]:
                best = (key, c)
        return None if best is None else best[1]

    def _preempt_slot(self, victim: int) -> int:
        """Swap one victim row out and queue its restore ticket
        (journalled: PREEMPT names the ticket)."""
        eng = self._ceng
        req = eng._slots[victim].req
        self.stats[req.tenant]["preempted"] += 1
        # the victim's busy share must not leak onto the slot's next row
        self._row_busy.pop(victim, None)
        ticket = eng.preempt(victim)
        self._journal("PREEMPT", rid=self._rid(req), ticket=int(ticket))
        self._restore_q.append(ticket)
        return ticket

    def _preempt_for(self, reqs: List[Request]
                     ) -> Tuple[int, List[Request]]:
        """Admit failed picks by swapping strictly-lower-priority victims
        out (the caller quiesced the engine).  Returns (newly admitted,
        still failed)."""
        eng = self._ceng
        admitted, remaining = 0, []
        for req in sorted(reqs, key=self._prio):
            ok = False
            while not ok:
                victim = self._victim_slot(self._prio(req))
                if victim is None:
                    break
                self._preempt_slot(victim)
                t_adm = time.perf_counter()
                try:
                    ok = eng.try_admit_batch([req])[0]
                except InjectedFault:
                    self.faults_survived += 1
                    break
            if ok:
                admitted += 1
                self._attempts.pop(id(req), None)
                self._backoff.pop(id(req), None)
                self._journal_admits([req])
                req.admitted_s = t_adm
            else:
                remaining.append(req)
        return admitted, remaining

    def _drain_restores(self, allow_preempt: bool) -> int:
        """Re-admit swapped-out requests, highest tier first.  A restore
        beats fresh picks of its own or lower tiers but never takes a free
        slot a strictly-higher-priority queued arrival is waiting for.  A
        restore blocked on pool pressure with an otherwise idle engine, or
        a poisoned swap read past the retry budget, fails terminally, so the
        drain never hangs on an unrestorable ticket.  A window of
        ``restore_prefetch`` tickets at the head of the queue is staged
        ahead of its re-admission."""
        eng = self._ceng
        if not self._restore_q or eng.swap_store is None:
            return 0
        pending = sorted(self._restore_q,
                         key=lambda t: eng.swap_store.record(t).priority)
        self._restore_q = []
        done = 0
        for ticket in pending:
            if self._adm_clock < self._ticket_backoff.get(ticket, 0):
                self._restore_q.append(ticket)
                continue
            rec = eng.swap_store.record(ticket)
            hi_wait = sum(1 for q in self.queues.values() for r in q
                          if self._prio(r) < rec.priority)
            if hi_wait and eng.free_slot_count() <= hi_wait:
                self._restore_q.append(ticket)
                continue
            try:
                ok = eng.try_restore(ticket)
                if not ok and allow_preempt and self.preemption:
                    victim = self._victim_slot(rec.priority)
                    if victim is not None:
                        self._preempt_slot(victim)
                        ok = eng.try_restore(ticket)
            except InjectedFault:
                self.faults_survived += 1
                n = self._ticket_attempts.get(ticket, 0) + 1
                if n > self.round_fault_limit:
                    self._drop_ticket(ticket)
                    continue
                self._ticket_attempts[ticket] = n
                self._ticket_backoff[ticket] = self._adm_clock + min(
                    1 << (n - 1), 16)
                self._restore_q.append(ticket)
                continue
            if ok:
                done += 1
                self._ticket_attempts.pop(ticket, None)
                self._ticket_backoff.pop(ticket, None)
                self._journal("RESTORE", rid=self._rid(rec.req),
                              ticket=int(ticket))
                continue
            if eng.active_count() == 0 and self._cont_inflight is None:
                # nothing live can ever free more pages: bound the spin
                n = self._ticket_attempts.get(ticket, 0) + 1
                self._ticket_attempts[ticket] = n
                if n > self.admission_retry_limit:
                    self._drop_ticket(ticket)
                    continue
            self._restore_q.append(ticket)
        for ticket in self._restore_q[:self.restore_prefetch]:
            eng.swap_store.prefetch(ticket)
        return done

    def _drop_ticket(self, ticket: int) -> None:
        """Fail a swapped-out request terminally: its record leaves the
        store and the ledger, and both ticket maps forget it."""
        rec = self._ceng.drop_swapped(ticket)
        self._ticket_attempts.pop(ticket, None)
        self._ticket_backoff.pop(ticket, None)
        self._fail(rec.req, preemptions=rec.preemptions)

    def _admit_continuous(self, allow_preempt: bool = False) -> int:
        """Admit queued requests into free slots: restores of preempted
        work first, then one queue head per pick (the rotation or the
        priority order, :meth:`_pick_continuous`), admitted as one batch.
        Rejected picks are requeued at the front of their tenant's queue;
        when nothing is in flight, nothing was admitted and nothing is
        restorable (so no retirement can free pages), failed picks count
        against the bounded retry budget and reject terminally past it."""
        with self.tel.span("sched.admit",
                           backlog=sum(len(q) for q in
                                       self.queues.values())) as sp:
            n = self._admit_continuous_inner(allow_preempt)
            sp.note(admitted=n)
            return n

    def _admit_continuous_inner(self, allow_preempt: bool) -> int:
        eng = self._ceng
        self._adm_clock += 1
        self._shed_backlog()
        admitted = self._drain_restores(allow_preempt)
        picked = self._pick_continuous(eng.free_slot_count())
        failures: List[Request] = []
        can_preempt = (allow_preempt and self.preemption
                       and eng.can_preempt)
        if picked:
            t0 = time.perf_counter() - self._t0
            try:
                flags = eng.try_admit_batch(picked)
            except InjectedFault:
                self.faults_survived += 1
                flags = [False] * len(picked)
            t1 = time.perf_counter() - self._t0
            self._journal_admits([r for r, ok in zip(picked, flags) if ok])
            for req, ok in zip(picked, flags):
                if not ok:
                    failures.append(req)
                    continue
                admitted += 1
                self._attempts.pop(id(req), None)
                self._backoff.pop(id(req), None)
                slot = self._slot_of[req.tenant]
                self.admission_timeline.append(TenantTimeline(
                    vdev=slot, pdev=eng.pdev, slot=slot,
                    transfer_start=t0, transfer_end=t1,
                    compute_start=t1, compute_end=t1))
                req.admitted_s = self._t0 + t0
            if failures and can_preempt:
                extra, failures = self._preempt_for(failures)
                admitted += extra
            hopeless = (admitted == 0 and eng.active_count() == 0
                        and self._cont_inflight is None
                        and not self._restore_q)
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
                self._backoff[id(req)] = self._adm_clock + min(
                    1 << (n - 1), 16)
                still.append(req)
            for req in reversed(still):
                self.queues[req.tenant].appendleft(req)
                # the pick didn't result in service: keep the tenant's place
                self._round_served.discard(req.tenant)
        elif can_preempt and eng.free_slot_count() == 0:
            # slot exhaustion (nothing pickable): a waiting request of a
            # strictly higher tier than some live row still preempts
            heads = [q[0] for q in self.queues.values() if q]
            if heads:
                best = min(heads, key=lambda r: (
                    self._prio(r), self._deadline(r), r.arrival_s))
                if self._victim_slot(self._prio(best)) is not None:
                    self.queues[best.tenant].popleft()
                    extra, remaining = self._preempt_for([best])
                    admitted += extra
                    for req in remaining:
                        self.queues[req.tenant].appendleft(req)
        starved = (eng.free_slot_count() == 0
                   and any(self.queues.values()))
        self._admission_blocked = bool(failures or self._restore_q
                                       or starved)
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

    def _try_dispatch_round(self, asm0: float) -> Optional[_InflightRound]:
        """Dispatch under the round-fault retry/limit policy: a dropped
        round raises before any state changes, so it is simply dispatched
        again next step; a streak past ``round_fault_limit`` fails every
        live row terminally, so the drain always finishes."""
        try:
            fl = self._dispatch_round(asm0)
        except InjectedFault:
            self.faults_survived += 1
            self._round_fault_streak += 1
            if self._round_fault_streak > self.round_fault_limit:
                for req in self._ceng.fail_live():
                    self._fail(req)
                self._round_fault_streak = 0
            return None
        self._round_fault_streak = 0
        return fl

    def _preemption_pressure(self) -> bool:
        """True when the round in flight should be collected now so that a
        preemption can run on a quiesced engine: admission is blocked, a
        strictly higher-priority request waits (queued or swapped), and a
        lower-priority victim is live."""
        eng = self._ceng
        if not (self.preemption and eng.can_preempt
                and self._admission_blocked):
            return False
        prios = [self._prio(q[0]) for q in self.queues.values() if q]
        if eng.swap_store is not None:
            prios += [eng.swap_store.record(t).priority
                      for t in self._restore_q]
        if not prios:
            return False
        p = min(prios)
        return any(lp > p for lp in eng.live_priorities())

    def _step_continuous(self) -> Optional[List[Response]]:
        eng = self._ceng
        if self.heartbeat.suspect():
            self.heartbeat_suspects += 1
            if self.tel.enabled:
                self.tel.count("heartbeat.missed")
                self.tel.gauge("heartbeat.suspects", self.heartbeat_suspects)
        if self._cont_inflight is None:
            # engine quiesced: the only sound window for a checkpoint
            if self._checkpoint_due():
                self.save_checkpoint()
            asm0 = time.perf_counter() - self._t0
            admitted = self._admit_continuous(allow_preempt=self.preemption)
            if admitted == 0 and eng.active_count() == 0:
                # nothing in flight and nothing admitted: queued heads are
                # in bounded retry/backoff, so drain() still progresses
                return self._pop_terminal() or None
            self._cont_inflight = self._try_dispatch_round(asm0)
            if self._cont_inflight is None:      # injected round drop
                return self._pop_terminal() or None
        cur = self._cont_inflight
        # retire-before-dispatch: when round k has already landed, retire
        # its finished rows now so this step's admissions can use them
        res = eng.collect(cur.handle) if cur.handle.ready() else None
        if res is None and self._preemption_pressure():
            # preemption runs on a quiesced engine: collect round k now,
            # trading one round of pipelining for the higher tier
            res = eng.collect(cur.handle)
        # overlap point: the next round's admissions and its dispatch land
        # here, while round k may still occupy the device
        asm0 = time.perf_counter() - self._t0
        admitted = self._admit_continuous(
            allow_preempt=self.preemption and res is not None)
        # a due checkpoint holds the next dispatch back, so the next step
        # starts quiesced (pending=1: round k commits below)
        live = eng.live_after(0 if res is not None else eng.inner_steps)
        self._cont_inflight = (self._try_dispatch_round(asm0)
                               if (admitted or live)
                               and not self._checkpoint_due(pending=1)
                               else None)
        if res is None:
            res = eng.collect(cur.handle)
        self._journal_round(res)
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
            self._journal("RETIRE", rid=self._rid(req),
                          tokens=[int(t) for t in tokens])
            if self.tel.enabled:
                self._request_spans(req, srec)
            responses.append(Response(
                req.tenant, tokens, done_abs - req.arrival_s, 1,
                ttft_s=ttft, priority=self._prio(req),
                preemptions=srec.preemptions, rid=self._rid(req)))
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
            # two-tier audit: every request is terminal, so the host tier's
            # ledgers must agree with the store and no ticket bookkeeping
            # may outlive its record
            eng = self._ceng
            eng.kv.assert_conserved(
                None if eng.swap_store is None
                else eng.swap_store.pages_by_kind())
            leaked = set(self._ticket_attempts) | set(self._ticket_backoff)
            assert not leaked, \
                f"drain: ticket bookkeeping leaked for {sorted(leaked)}"
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
