"""Overlapped multi-tenant execution pipeline (paper Figs 11/13, executable).

With sequential transfers, tenant k+1's host->device staging rides the link
while tenant k's compute occupies its pdev, so the makespan is
``max(transfer chain, compute chains)`` instead of their sum.
:class:`PipelineExecutor` is the executable form of that schedule:

* sequential mode — chunks are staged one at a time (each transfer owns the
  full link, paper Fig 10); the moment chunk k is device-resident its compute
  is *launched* (asynchronously, on the pdev's compute stream) and the
  executor immediately starts staging chunk k+1.  Transfer(k+1) therefore
  overlaps compute(k).
* concurrent mode — every transfer is enqueued up front (copy streams share
  the link, BW/n each, Fig 8); each tenant's compute is launched as soon as
  its chunk lands, in staging order.
* per-pdev serialisation — **one compute stream per pdev**, distinct from the
  copy stream(s) and from the default stream; tenants of one pdev are
  launched on it in slot order and the stream serialises them (as the paper
  observes of tenants sharing a GPU).  The compute stream waits
  on the chunk's copy event (:func:`launch_after_copy`) even though the host
  already did, and the chunk's tensors are marked as used by it
  (``record_stream``), so the caching allocator cannot hand their memory to
  the next chunk while a kernel still reads it.
* straggler reordering — the previous step's slowest tenant is staged first
  (:func:`repro_torch.core.transfer.reorder_for_stragglers`).

Every run returns a :class:`PipelineReport` whose :class:`TenantTimeline`
entries carry per-tenant ``transfer_start/transfer_end/compute_start/
compute_end`` host-clock timestamps (relative to run start).  A dedicated
waiter thread blocks on each tenant's completion event *concurrently with the
staging loop* and stamps ``compute_end`` the moment it fires, so the
realised-overlap signal used by :meth:`PipelineReport.overlaps` —

    ``compute_start(k) <= transfer_start(k+1) < compute_end(k)``

(transfer k+1 began inside compute k's execution window) — is falsifiable in
both directions: a blocking stage-everything schedule fails the left
inequality (every transfer precedes every compute; this rejection is
structural, independent of timing noise), and a launch whose compute drained
before the next chunk was staged fails the right one.  ``compute_end`` is
stamped at waiter-thread wakeup, so gaps shorter than a thread wakeup are not
resolved.  Host clocks are the contract; on a CUDA device each entry also
carries ``device_ms`` — the copy's and the compute's start and end read from
CUDA events, in milliseconds after the run's origin event — which is the
measurement.
"""
from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.tenancy import TenantTask, VirtualDevicePool
from repro_torch.core.transfer import (DeviceStreams, StagedChunk,
                                       StagingEngine, reorder_for_stragglers,
                                       tree_leaves)
from repro_torch.obs.telemetry import Telemetry, get_telemetry

StageFn = Callable[[TenantTask], Any]           # task -> host tree
ComputeFn = Callable[[TenantTask, Any], Any]    # (task, device tree) -> out


@dataclasses.dataclass
class TenantTimeline:
    """Activity windows of one tenant, relative to run start."""
    vdev: int
    pdev: int
    slot: int
    transfer_start: float
    transfer_end: float
    compute_start: float      # host time of the (asynchronous) launch
    compute_end: float        # host time the completion event was seen
    # CUDA only: copy_start/copy_end/compute_start/compute_end by CUDA events,
    # ms after the run's origin event
    device_ms: Optional[Dict[str, float]] = None

    @property
    def transfer_s(self) -> float:
        return self.transfer_end - self.transfer_start

    @property
    def compute_s(self) -> float:
        return self.compute_end - self.compute_start


def timeline_overlaps(timeline: Sequence[TenantTimeline]) -> List[bool]:
    """For each consecutive staged pair (k, k+1): did tenant k+1's transfer
    start *inside* tenant k's compute window?  All-True on a multi-tenant
    sequential run means the paper's overlap is realised (see the module
    docstring for why this predicate is falsifiable)."""
    return [a.compute_start <= b.transfer_start < a.compute_end
            for a, b in zip(timeline, timeline[1:])]


@dataclasses.dataclass
class PipelineReport:
    results: Dict[int, Any]            # vdev -> device output
    timeline: List[TenantTimeline]     # in staging order
    wall_s: float
    mode: str
    t0_s: float = 0.0                  # perf_counter() origin of the timeline

    def per_tenant_s(self) -> Dict[int, float]:
        return {tl.vdev: tl.compute_s for tl in self.timeline}

    def overlaps(self) -> List[bool]:
        return timeline_overlaps(self.timeline)

    def overlap_realised(self) -> bool:
        # majority-of-pairs: noise on a shared host can legitimately drain
        # isolated pairs early, while a blocking schedule structurally scores
        # zero pairs
        ov = self.overlaps()
        return sum(ov) > len(ov) // 2 if ov else False


# ---------------------------------------------------------------------------
# compute streams and launches
# ---------------------------------------------------------------------------
def _timing_event(stream) -> Any:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def record_origins(devices: Sequence[torch.device]) -> Dict[int, Any]:
    """pdev -> a timing event recorded now on the pdev's current stream (None
    for a CPU pdev): the origin that ``device_ms`` times are read against."""
    return {p: (_timing_event(torch.cuda.current_stream(d))
                if d.type == "cuda" else None)
            for p, d in enumerate(devices)}


def launch_after_copy(chunk: StagedChunk, compute_fn: ComputeFn,
                      stream) -> Tuple[Any, Any, Any]:
    """Launch ``compute_fn(task, arrays)`` on the pdev's compute ``stream``
    behind the chunk's copy; returns ``(out, start_event, done_event)``.

    On the CPU (``stream is None``) the call simply runs and both events are
    None.  ``compute_fn`` must only enqueue work on the current stream."""
    if stream is None:
        return compute_fn(chunk.task, chunk.arrays), None, None
    with torch.cuda.stream(stream):
        if chunk.event is not None:
            stream.wait_event(chunk.event)
        for leaf in tree_leaves(chunk.arrays):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(stream)
        start = _timing_event(stream)
        out = compute_fn(chunk.task, chunk.arrays)
        return out, start, _timing_event(stream)


def device_times_ms(origin, chunk: StagedChunk, start, done
                    ) -> Optional[Dict[str, float]]:
    """CUDA-event times of one tenant, ms after ``origin``; call only once
    ``done`` has completed.  None on the CPU."""
    if origin is None or done is None:
        return None
    return {"copy_start": origin.elapsed_time(chunk.start_event),
            "copy_end": origin.elapsed_time(chunk.event),
            "compute_start": origin.elapsed_time(start),
            "compute_end": origin.elapsed_time(done)}


class CompletionWaiter:
    """Daemon thread that stamps ``TenantTimeline.compute_end`` the moment a
    launched tenant's completion event fires.

    The dispatching thread records ``transfer_*``/``compute_start`` and
    submits ``(event, timeline_entry)``; the waiter blocks in
    ``event.synchronize()`` (which releases the interpreter lock)
    *concurrently with whatever the dispatcher does next* and stamps
    ``compute_end`` when it returns, which is what makes the
    :func:`timeline_overlaps` predicate falsifiable on the right inequality.
    ``event`` is anything with a ``synchronize()`` method — a
    ``torch.cuda.Event`` recorded right after the launch — or None for work
    that completed synchronously (the CPU).

    ``submit`` returns a :class:`threading.Event` set once the entry is
    stamped (or the wait raised), so callers can join a single item without
    closing the waiter.  Device errors surfacing on the blocking wait are
    recorded in :attr:`errors` — the thread keeps serving later items so a
    poisoned launch can neither hang subsequent tickets nor leak the thread.
    """

    def __init__(self, clock: Callable[[], float],
                 name: str = "completion-waiter"):
        self._clock = clock
        self._q: "queue.Queue" = queue.Queue()
        self.errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, event: Any, entry: TenantTimeline,
               on_ready: Optional[Callable[[], None]] = None
               ) -> threading.Event:
        """Stamp ``entry.compute_end`` when ``event`` completes; returns a
        flag set after the stamp (and optional ``on_ready()``) ran."""
        stamped = threading.Event()
        self._q.put((event, entry, on_ready, stamped))
        return stamped

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            event, entry, on_ready, stamped = item
            try:
                if event is not None:
                    event.synchronize()
                entry.compute_end = self._clock()
                if on_ready is not None:
                    on_ready()
            except BaseException as e:   # device errors surface on the wait
                self.errors.append(e)    # re-raised by the owner
            finally:
                stamped.set()

    def close(self) -> None:
        """Drain remaining items, then stop and join the thread."""
        self._q.put(None)
        self._thread.join()


class PipelineExecutor:
    """Event-driven executor: stage chunk k+1 while chunk k computes.

    The executor owns a :class:`StagingEngine` (for placement + the staging
    log) but drives its non-blocking ``put``/``wait`` primitives instead of
    the stage-everything entry point, interleaving compute launches with the
    transfer chain.  Placement follows the engine: the pool's devices, else
    ``device`` (default CUDA; raises when there is none).  An owner that runs
    repeatedly passes its :class:`DeviceStreams` so that runs share streams.

    On the ``telemetry`` plane (and its staging engine's) a run records
    ``pipeline.start`` (the waiter threads and origin events), per tenant
    ``pipeline.stage`` (``stage_fn`` and the copy's enqueue),
    ``pipeline.wait`` (the host's block until the chunk is resident) and
    ``pipeline.launch`` (the compute's enqueue), each with ``vdev`` and
    ``bytes``, then ``pipeline.join`` (the waiters drained).
    """

    def __init__(self, pool: VirtualDevicePool, mode: Optional[str] = None,
                 device: Union[None, str, torch.device] = None,
                 streams: Optional[DeviceStreams] = None,
                 telemetry: Optional[Telemetry] = None):
        self.pool = pool
        self.mode = mode or pool.cfg.transfer_mode
        assert self.mode in ("sequential", "concurrent")
        self.tel = get_telemetry(telemetry)
        self.engine = StagingEngine(pool, self.mode, device=device,
                                    streams=streams, telemetry=self.tel)
        self.streams = self.engine.streams

    # ------------------------------------------------------------------
    def run(self, tasks: Sequence[TenantTask], stage_fn: StageFn,
            compute_fn: ComputeFn,
            straggler_hist: Optional[Dict[int, float]] = None,
            **attrs: Any) -> PipelineReport:
        """Execute every tenant task; returns results + per-tenant timeline.

        ``stage_fn(task)`` builds the host tree for one tenant (a cheap slice
        of pinned host data); ``compute_fn(task, device_tree)`` must only
        *enqueue* work on the current CUDA stream — the pipeline blocks on
        completion events only after every tenant has been launched.
        ``attrs`` (an analysis' ``run`` id) go on every span of the run.
        """
        tel = self.tel
        with tel.span("pipeline.start", **attrs):
            t0 = time.perf_counter()
            now = lambda: time.perf_counter() - t0
            order = reorder_for_stragglers(tasks, straggler_hist)
            timeline: Dict[int, TenantTimeline] = {}
            results: Dict[int, Any] = {}
            launched: Dict[int, Tuple[StagedChunk, Any, Any]] = {}
            origins = record_origins(self.engine.devices)

            # CompletionWaiter per pdev: blocks on each launched tenant's
            # completion event concurrently with the staging loop and stamps
            # compute_end the moment it fires.  The main thread only writes
            # a tenant's timeline entry before submitting it, the waiter only
            # stamps compute_end after.  One waiter per pdev: tenants of a
            # pdev complete in launch order anyway (the compute stream
            # serialises them), so within-pdev blocking in launch order
            # stamps *exact* completion times, and a slow pdev cannot inflate
            # another pdev's compute_end (the per-tenant times steer the next
            # run's staging order).
            waiters: Dict[int, CompletionWaiter] = {
                p: CompletionWaiter(now, name="pipeline-waiter")
                for p in {t.pdev for t in order}}

        def stage(task: TenantTask) -> StagedChunk:
            with tel.span("pipeline.stage", vdev=task.vdev, **attrs) as sp:
                chunk = self.engine.put(task, stage_fn(task), t0)
                sp.note(bytes=chunk.nbytes)
            return chunk

        def dispatch(task: TenantTask, chunk: StagedChunk) -> None:
            with tel.span("pipeline.wait", vdev=task.vdev,
                          bytes=chunk.nbytes, **attrs):
                # overlap point: compute of already launched tenants keeps
                # running
                self.engine.wait(chunk, t0, **attrs)
            te = now()
            with tel.span("pipeline.launch", vdev=task.vdev,
                          bytes=chunk.nbytes, **attrs):
                out, start, done = launch_after_copy(
                    chunk, compute_fn, self.streams.compute(task.pdev))
                timeline[task.vdev] = TenantTimeline(
                    task.vdev, task.pdev, task.slot,
                    chunk.enqueue_s, te, now(), 0.0)
                launched[task.vdev] = (chunk, start, done)
                waiters[task.pdev].submit(
                    done, timeline[task.vdev],
                    on_ready=functools.partial(results.__setitem__,
                                               task.vdev, out))

        try:
            if self.mode == "sequential":
                # one transfer on the link at a time; compute(k) is already
                # in flight while put+wait stages chunk k+1 (double buffering)
                for task in order:
                    dispatch(task, stage(task))
            else:
                # all transfers share the link from t~0; launch each
                # tenant's compute as its chunk lands, in staging order
                chunks = [stage(task) for task in order]
                for task, chunk in zip(order, chunks):
                    dispatch(task, chunk)
        finally:
            # always drain + reap the waiters, even when staging raises
            with tel.span("pipeline.join", **attrs):
                for w in waiters.values():
                    w.close()
        waiter_err = [e for w in waiters.values() for e in w.errors]
        if waiter_err:
            raise waiter_err[0]
        for vdev, (chunk, start, done) in launched.items():
            timeline[vdev].device_ms = device_times_ms(
                origins[chunk.task.pdev], chunk, start, done)
        return PipelineReport(results, [timeline[t.vdev] for t in order],
                              now(), self.mode, t0)
