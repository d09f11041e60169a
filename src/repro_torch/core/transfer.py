"""Host -> accelerator staging engines (paper §V-D1).

Two modes:
  * CONCURRENT — enqueue every tenant chunk at once, each on its own copy
    stream; all transfers share the host link (each attains ~BW/n, Fig 8/10).
  * SEQUENTIAL — enqueue chunks one at a time in slot-major tenant order on
    one copy stream per device; each transfer gets full link bandwidth and
    tenant k's compute overlaps tenant k+1's staging (the paper's winning
    strategy).

On a CUDA device a chunk is copied with ``non_blocking=True`` on a *copy
stream* (never the default stream, never a compute stream) and a
``torch.cuda.Event`` recorded on that stream rides in the
:class:`StagedChunk`; :meth:`StagingEngine.wait` synchronises on it.  The copy
is asynchronous only from **pinned** host memory: from pageable memory it
still works but holds the calling thread for the length of the copy, which
silently removes the overlap this module exists for — the log records
``pinned`` per chunk so a caller can check.  On the CPU a chunk is staged by
reference (no copy) and is ready at once.

:class:`MeshStagingLanes` stages for a device mesh: one sequential engine
per mesh position, each leaf sliced by its placement, each slice on its
position's lane.

The engine exposes two levels of API: non-blocking :meth:`StagingEngine.put`
/ :meth:`StagingEngine.wait` primitives that the overlapped executor in
:mod:`repro_torch.core.pipeline` interleaves with compute dispatch, and the
stage-everything :meth:`StagingEngine.stage` entry point (the blocking
schedule, kept for A/B measurements).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.tenancy import (TenancyConfig, TenantTask,
                                      VirtualDevicePool, resolve_devices)
from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.obs.telemetry import Telemetry, get_telemetry


@dataclasses.dataclass
class PaddedRows:
    """A host leaf staged with ``pad`` zero rows appended **on the device**:
    the device tensor is allocated at the padded size, the real rows are
    copied and the tail is zeroed there, so no padded copy is ever built on
    the host."""
    rows: Union[np.ndarray, torch.Tensor]
    pad: int


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict / list / tuple nest."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _tree_bytes(tree: Any) -> int:
    """Total payload bytes of a staged tree."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree)
               if isinstance(a, torch.Tensor))


def _as_tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


class DeviceStreams:
    """The CUDA streams of one deployment, created on first use and kept for
    the owner's life: copy streams (one per device, or one per tenant — see
    :class:`StagingEngine`) and one compute stream per pdev, all distinct
    from the default stream.

    Keep one instance across runs: PyTorch's caching allocator pools freed
    memory per stream, so a run on fresh streams cannot reuse the previous
    run's chunk buffers and pays a device allocation per chunk, in the
    middle of the transfer chain."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._copy: Dict[Any, Any] = {}
        self._compute: Dict[int, Any] = {}

    def copy(self, pdev: int, lane: Any = None):
        """The copy stream of ``(pdev, lane)``; CUDA pdevs only."""
        key = (pdev, lane)
        if key not in self._copy:
            self._copy[key] = torch.cuda.Stream(self.devices[pdev])
        return self._copy[key]

    def compute(self, pdev: int):
        """The compute stream of ``pdev``; None for a CPU pdev."""
        if self.devices[pdev].type != "cuda":
            return None
        if pdev not in self._compute:
            self._compute[pdev] = torch.cuda.Stream(self.devices[pdev])
        return self._compute[pdev]


@dataclasses.dataclass
class StagedChunk:
    task: TenantTask
    arrays: Any                   # device-resident tree of tensors
    enqueue_s: float
    ready_s: Optional[float] = None
    base_s: float = 0.0           # perf_counter() origin of the timestamps
    # CUDA only: the events bracketing the copy on its copy stream
    start_event: Optional[Any] = None
    event: Optional[Any] = None
    pinned: bool = True           # every host leaf was page-locked
    nbytes: int = 0               # payload bytes of ``arrays``


class StagingEngine:
    def __init__(self, pool: VirtualDevicePool, mode: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None,
                 device: Union[None, str, torch.device] = None,
                 streams: Optional[DeviceStreams] = None):
        """``pool.devices`` name the target of each pdev; a pool without
        devices is placed by ``device`` (default: the CUDA devices — raises
        when there are none; the CPU only when named).  ``streams`` lets an
        owner that runs repeatedly share one :class:`DeviceStreams`."""
        self.pool = pool
        self.mode = mode or pool.cfg.transfer_mode
        assert self.mode in ("sequential", "concurrent")
        self.devices: List[torch.device] = (
            [torch.device(d) for d in pool.devices]
            if pool.devices is not None
            else resolve_devices(pool.cfg.n_pdev, device))
        if any(d.type == "cuda" for d in self.devices) \
                and not torch.cuda.is_available():
            raise RuntimeError("the pool names CUDA devices but "
                               "torch.cuda.is_available() is false")
        self.log: List[Dict[str, Any]] = []
        self.tel = get_telemetry(telemetry)
        self.streams = streams or DeviceStreams(self.devices)

    # ------------------------------------------------------------------
    def device_of(self, task: TenantTask) -> torch.device:
        return self.devices[task.pdev]

    def _copy_stream(self, task: TenantTask):
        """Sequential: one copy stream per device, so transfers queue behind
        each other.  Concurrent: one per tenant, so they share the link."""
        return self.streams.copy(
            task.pdev, None if self.mode == "sequential" else task.vdev)

    @staticmethod
    def _put_leaf(leaf: Any, device: torch.device) -> torch.Tensor:
        pad = leaf.pad if isinstance(leaf, PaddedRows) else 0
        host = _as_tensor(leaf.rows if isinstance(leaf, PaddedRows) else leaf)
        if not pad:
            if device.type == "cpu":
                return host                     # staged by reference
            return host.to(device, non_blocking=True)
        n = host.shape[0]
        dev = torch.empty((n + pad, *host.shape[1:]), dtype=host.dtype,
                          device=device)
        dev[:n].copy_(host, non_blocking=True)
        dev[n:].zero_()
        return dev

    # -- non-blocking primitives (used by core.pipeline) ----------------
    def put(self, task: TenantTask, host_tree: Any,
            t0: Optional[float] = None) -> StagedChunk:
        """Enqueue one tenant chunk's host->device transfer and return at
        once.  ``t0`` anchors the chunk's timestamps; without it the enqueue
        instant is the origin."""
        base = t0 if t0 is not None else time.perf_counter()
        device = self.device_of(task)
        if device.type != "cuda":
            arrays = tree_map(lambda a: self._put_leaf(a, device), host_tree)
            return StagedChunk(task, arrays, time.perf_counter() - base,
                               base_s=base, nbytes=_tree_bytes(arrays))
        pinned = all(
            _as_tensor(a.rows if isinstance(a, PaddedRows) else a).is_pinned()
            for a in tree_leaves(host_tree))
        stream = self._copy_stream(task)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            arrays = tree_map(lambda a: self._put_leaf(a, device), host_tree)
            done.record(stream)
        return StagedChunk(task, arrays, time.perf_counter() - base,
                           base_s=base, start_event=start, event=done,
                           pinned=pinned, nbytes=_tree_bytes(arrays))

    def wait(self, chunk: StagedChunk, t0: Optional[float] = None,
             **attrs: Any) -> StagedChunk:
        """Block until the chunk is device-resident; records the ready time
        against the same origin ``put`` used (or an explicit ``t0``).
        While the caller blocks here, previously dispatched compute keeps
        running on its device — this is the pipeline's overlap point.
        ``attrs`` go on the chunk's ``transfer.stage`` span."""
        if chunk.event is not None:
            chunk.event.synchronize()
        base = t0 if t0 is not None else chunk.base_s
        chunk.ready_s = time.perf_counter() - base
        nbytes = chunk.nbytes
        self.log.append({"vdev": chunk.task.vdev, "ready_s": chunk.ready_s,
                         "mode": self.mode, "bytes": nbytes,
                         "pinned": chunk.pinned})
        if self.tel.enabled:
            # the staging-lane span: enqueue -> device-resident, stamped
            # against the same origin the chunk's log times use
            self.tel.record_span("transfer.stage", base + chunk.enqueue_s,
                                 base + chunk.ready_s, vdev=chunk.task.vdev,
                                 pdev=chunk.task.pdev, slot=chunk.task.slot,
                                 mode=self.mode, bytes=nbytes, **attrs)
            self.tel.count("transfer.bytes", nbytes)
            self.tel.count("transfer.chunks")
        return chunk

    def stage(self, tasks: Sequence[TenantTask],
              chunk_of: Callable[[TenantTask], Any],
              block: bool = False) -> List[StagedChunk]:
        """Stage every tenant chunk per the configured mode.

        ``chunk_of(task)`` returns the host tree for that tenant.  In
        sequential mode each chunk blocks until on-device before the next is
        enqueued (full-bandwidth transfers); concurrent mode enqueues all and
        only then (optionally) waits.

        This is the *stage-everything* entry point (the blocking schedule,
        kept for A/B measurements); the overlapped executor in
        :mod:`repro_torch.core.pipeline` drives :meth:`put`/:meth:`wait`
        directly so compute dispatch can interleave with staging.
        """
        t0 = time.perf_counter()
        out: List[StagedChunk] = []
        if self.mode == "sequential":
            for t in tasks:
                c = self.put(t, chunk_of(t), t0)
                self.wait(c, t0)
                out.append(c)
        else:
            for t in tasks:
                out.append(self.put(t, chunk_of(t), t0))
            if block:
                for c in out:
                    self.wait(c, t0)
        return out


@dataclasses.dataclass
class MeshStagedChunk:
    """One logical host-to-device transfer split across per-position
    lanes."""
    chunks: List[StagedChunk]           # mesh position -> its slices' chunk
    host_tree: Any                      # the host tree (for assembly)
    logical_of: Callable[[Any], Sequence[Optional[str]]]


class MeshStagingLanes:
    """Per-mesh-position staging: one sequential :class:`StagingEngine` per
    position of ``sharder``'s mesh, each with its own copy stream -- two
    positions on one device are still two lanes.

    A host tree bound for a split placement is sliced per position by
    :meth:`repro_torch.distributed.sharding.Sharder.index_map` of each
    leaf's logical axes (``logical_of(leaf)``) and each slice rides its
    own lane, so slices of different lanes overlap; a replicated leaf is
    staged whole on every lane.  :meth:`wait` assembles the staged slices
    into :class:`repro_torch.distributed.sharding.ShardedTensor` leaves."""

    def __init__(self, sharder, telemetry: Optional[Telemetry] = None):
        self.sharder = sharder
        self.tel = get_telemetry(telemetry)
        devs = sharder.mesh.position_devices()
        # lane p stages to position p's device (pdev p in its spans)
        self.engines = [StagingEngine(VirtualDevicePool(
            TenancyConfig(1, 1, "sequential"), devices=devs),
            telemetry=self.tel) for _ in devs]

    @property
    def n_lanes(self) -> int:
        return len(self.engines)

    def retarget_telemetry(self, tel: Telemetry) -> None:
        self.tel = tel
        for eng in self.engines:
            eng.tel = tel

    def put(self, host_tree: Any,
            logical_of: Callable[[Any], Sequence[Optional[str]]],
            slot: int = 0) -> MeshStagedChunk:
        """Enqueue every lane's slices and return at once.  A slice that is
        not contiguous (heads of a pinned block) is packed first into a
        pinned buffer, so its copy stays asynchronous."""
        chunks = []
        for lane, eng in enumerate(self.engines):
            def slice_leaf(a, _lane=lane):
                a = _as_tensor(a)
                sl = self.sharder.index_map(logical_of(a), a.shape)[_lane]
                h = a[sl]
                if h.is_contiguous():
                    return h
                return torch.empty(h.shape, dtype=h.dtype,
                                   pin_memory=a.is_pinned()).copy_(h)
            task = TenantTask(vdev=0, pdev=lane, slot=slot, start=0, stop=1)
            chunks.append(eng.put(task, tree_map(slice_leaf, host_tree)))
        return MeshStagedChunk(chunks, host_tree, logical_of)

    def wait(self, staged: MeshStagedChunk) -> Any:
        """Every lane's slices ordered before the work its device's current
        stream enqueues next -- the stream waits on the lane's copy event,
        with no host synchronisation (on the CPU a slice is ready at once)
        -- then the tree of :class:`ShardedTensor` leaves."""
        with self.tel.span("transfer.assemble", lanes=len(staged.chunks)):
            for eng, chunk in zip(self.engines, staged.chunks):
                if chunk.event is None:
                    eng.wait(chunk)
                    continue
                stream = torch.cuda.current_stream(eng.device_of(chunk.task))
                stream.wait_event(chunk.event)
                tree_map(lambda t: t.record_stream(stream), chunk.arrays)
                eng.log.append({"vdev": chunk.task.vdev, "ready_s": None,
                                "mode": eng.mode, "bytes": chunk.nbytes,
                                "pinned": chunk.pinned})
        mesh = self.sharder.mesh

        def assemble(host, *shards):
            if isinstance(host, dict):
                return {k: assemble(host[k], *(s[k] for s in shards))
                        for k in host}
            if isinstance(host, (list, tuple)):
                return type(host)(assemble(h, *(s[i] for s in shards))
                                  for i, h in enumerate(host))
            host = _as_tensor(host)
            spec = self.sharder.spec(staged.logical_of(host), host.shape)
            return ShardedTensor.from_locals(mesh, spec, list(shards))

        return assemble(staged.host_tree, *(c.arrays for c in staged.chunks))


def reorder_for_stragglers(tasks: Sequence[TenantTask],
                           last_step_times: Optional[Dict[int, float]],
                           ) -> List[TenantTask]:
    """Straggler mitigation: stage the slowest tenant of the previous step
    first so its data is ready earliest."""
    if not last_step_times:
        return list(tasks)
    return sorted(tasks, key=lambda t: -last_step_times.get(t.vdev, 0.0))
