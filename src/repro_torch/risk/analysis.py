"""Aggregate Risk Analysis engine (paper Algorithm 1-3) with multi-tenancy.

Two execution paths over the same numerics (kernels/ops.aggregate_loss):

* ``run_single`` — one call over all trials (baseline, Algorithm 1 with N=1).
* ``run_tenant_chunked`` — the paper's deployment: the trial axis splits over
  ``n_pdev x tenants_per_pdev`` virtual devices and runs on the overlapped
  :class:`repro_torch.core.pipeline.PipelineExecutor`: tenant k's kernel is
  launched the moment its chunk is device-resident, so tenant k+1's staging
  overlaps tenant k's compute (the paper's winning schedule, Fig 13) and each
  pdev's compute stream serialises its tenants.  ``overlapped=False`` keeps
  the stage-everything-then-compute schedule for A/B measurements.

The engine runs on the CUDA devices unless the caller names the CPU
(``device="cpu"``); without a CUDA device the default raises.

Hot-path overhead control (all observable):

* **One launch shape per deployment** — tenant plans are uniform-padded
  (``VirtualDevicePool.plan(..., uniform=True)``), so ragged trial remainders
  share one chunk shape; ``launch_shape_count`` counts the distinct shapes
  the step has been launched with (the counterpart of the JAX engine's
  ``trace_count``).  The pad rows are zeroed on the device, never
  concatenated on the host.
* **Resident tables** — the un-splittable ELT + occurrence-term tables (the
  cause of the paper's §V-B sub-linear scaling) are uploaded to each pdev
  once, column-padded there once for the kernel's aligned row reads, and
  cached on the engine keyed by table identity, so repeated runs stop
  re-staging them; ``table_uploads`` counts actual uploads.  Layer aggregate
  terms stay dynamic scalars handed to the kernel by value — what-if pricing
  perturbs them without touching the cache and without a device sync.
* **Pinned YET** — on a CUDA device the YET is staged from page-locked
  memory, or the copies would hold the host and the overlap would vanish.
  A YET that is not pinned yet (see ``RiskTables.pinned``) is pinned once
  and cached by identity like the resident tables.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core.pipeline import (PipelineExecutor, TenantTimeline,
                                       device_times_ms, launch_after_copy,
                                       record_origins)
from repro_torch.core.tenancy import (TenancyConfig, TenantTask,
                                      VirtualDevicePool, resolve_devices)
from repro_torch.core.transfer import (DeviceStreams, PaddedRows,
                                       StagingEngine, reorder_for_stragglers)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.aggregate_loss import pad_elt_columns
from repro_torch.risk.tables import RiskTables

# resident per-pdev table sets kept per engine (LRU on table identity)
_TABLE_CACHE_SLOTS = 4


@dataclasses.dataclass
class RunReport:
    ylt: np.ndarray
    wall_s: float
    per_tenant_s: Dict[int, float]
    staging_log: List[Dict[str, Any]]
    timeline: Optional[List[TenantTimeline]] = None


class AggregateRiskAnalysis:
    def __init__(self, cfg: RiskAppConfig,
                 tenancy: Optional[TenancyConfig] = None,
                 device: Union[None, str, torch.device] = None):
        self.cfg = cfg
        on_cpu = device is not None and torch.device(device).type == "cpu"
        self.tenancy = tenancy or TenancyConfig(
            n_pdev=1 if on_cpu else max(1, torch.cuda.device_count()),
            tenants_per_pdev=cfg.tenants_per_device,
            transfer_mode=cfg.transfer_mode)
        self.devices = resolve_devices(self.tenancy.n_pdev, device)
        self.pool = VirtualDevicePool(self.tenancy, self.devices)
        # one set of streams for the engine's life: runs reuse chunk buffers
        self.streams = DeviceStreams(self.devices)
        self.launch_shapes: Set[Tuple] = set()
        self.table_uploads = 0        # host->device ELT/term table stagings
        # key -> (host refs pinning the key's id()s, {pdev: device tensors},
        #         fingerprint)
        self._table_cache: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()
        # the last YET pinned here (one: each copy is the size of the YET):
        # (host array, fingerprint, pinned tensor)
        self._pinned_yet: Optional[Tuple] = None

    # ------------------------------------------------------------------
    @property
    def launch_shape_count(self) -> int:
        """Distinct argument shapes the step has been launched with — one
        per deployment thanks to uniform plans."""
        return len(self.launch_shapes)

    def _step(self, yet, elt, occ_ret, occ_lim, agg_ret: float,
              agg_lim: float, chunk: int) -> torch.Tensor:
        self.launch_shapes.add((tuple(yet.shape), tuple(elt.shape), chunk))
        return kops.aggregate_loss(yet, elt, occ_ret, occ_lim, agg_ret,
                                   agg_lim, chunk=chunk)

    # ------------------------------------------------------------------
    # sampled elements per large array in the cache-staleness tripwire
    _FP_SAMPLES = 256

    @classmethod
    def _table_fingerprint(cls, host: Tuple[np.ndarray, ...]) -> Tuple:
        """Cheap content check guarding the id()-keyed caches against
        in-place mutation.  Small arrays (the per-ELT occurrence terms) are
        fingerprinted in full; large ones by shape/dtype plus a strided
        ``_FP_SAMPLES``-element sample, staying O(1) in table size.  This is
        a *tripwire*, not a guarantee: a sparse in-place edit of a big table
        can slip past the sample (see the cache contract in
        :meth:`_resident_tables`)."""
        out = []
        for a in host:
            flat = a.reshape(-1)
            if flat.size <= 4 * cls._FP_SAMPLES:
                out.append((a.shape, str(a.dtype), flat.tobytes()))
            else:
                step = max(1, flat.size // cls._FP_SAMPLES)
                out.append((a.shape, str(a.dtype),
                            flat[::step][:cls._FP_SAMPLES].tobytes()))
        return tuple(out)

    def _resident_tables(self, tables: RiskTables) -> Dict[int, Tuple]:
        """Per-pdev device copies of the un-splittable ELT + occurrence
        terms, cached across runs; LRU-capped at ``_TABLE_CACHE_SLOTS``
        table sets.  The ELT copy is column-padded on the device
        (:func:`pad_elt_columns`) here, once, not per call.

        Cache contract: tables handed to the engine are treated as
        **immutable** — derive what-if variants with ``dataclasses.replace``
        and fresh arrays rather than mutating in place.  The cache is keyed
        by host-array identity (the entry pins the arrays, so ids cannot be
        recycled) and revalidated against :meth:`_table_fingerprint`: full
        content for the small term arrays, a strided sample of the big ELT.
        Whole-table and term mutations therefore trigger a re-upload, but a
        sparse in-place edit of the ELT that misses every sampled element can
        still serve stale device copies — honour the contract."""
        host = (tables.elt_losses, tables.occ_ret, tables.occ_lim)
        key = tuple(id(a) for a in host)
        fp = self._table_fingerprint(host)
        if key in self._table_cache:
            if self._table_cache[key][2] == fp:
                self._table_cache.move_to_end(key)
                return self._table_cache[key][1]
            del self._table_cache[key]      # mutated in place: stale copy
        by_pdev: Dict[int, Tuple] = {}
        for p in range(self.tenancy.n_pdev):
            dev = self.devices[p]
            elt, occ_ret, occ_lim = (
                torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                .to(dev) for a in host)
            by_pdev[p] = (pad_elt_columns(elt), occ_ret, occ_lim)
            if dev.type == "cuda":
                # the compute streams read these: finish the upload first
                torch.cuda.current_stream(dev).synchronize()
            self.table_uploads += 1
        self._table_cache[key] = (host, by_pdev, fp)
        while len(self._table_cache) > _TABLE_CACHE_SLOTS:
            self._table_cache.popitem(last=False)
        return by_pdev

    def _host_yet(self, tables: RiskTables) -> torch.Tensor:
        """The YET as a host tensor the staging engine can slice: page-locked
        when any pdev is a CUDA device (pinned once per YET, cached by
        identity with the same tripwire as the resident tables)."""
        yet = torch.from_numpy(tables.yet)
        if all(d.type == "cpu" for d in self.devices) or yet.is_pinned():
            return yet
        fp = self._table_fingerprint((tables.yet,))
        hit = self._pinned_yet
        if hit is None or hit[0] is not tables.yet or hit[1] != fp:
            self._pinned_yet = hit = (tables.yet, fp, yet.pin_memory())
        return hit[2]

    def clear_table_cache(self) -> None:
        """Release every resident table set (host pins + per-pdev device
        copies) and the pinned YET copy.  Long-lived engines cycling
        through many table sets should call this when a working set retires
        — the LRU cap bounds entry count, not bytes."""
        self._table_cache.clear()
        self._pinned_yet = None

    # ------------------------------------------------------------------
    def _chunk(self, tables: RiskTables) -> int:
        return max(1, min(self.cfg.chunk_events, tables.yet.shape[1]))

    def run_single(self, tables: RiskTables) -> np.ndarray:
        """Whole-YET single-device run (Algorithm 1, N=1)."""
        elt, occ_ret, occ_lim = self._resident_tables(tables)[0]
        yet = torch.from_numpy(tables.yet).to(self.devices[0])
        ylt = self._step(yet, elt, occ_ret, occ_lim, float(tables.agg_ret),
                         float(tables.agg_lim), self._chunk(tables))
        return ylt.cpu().numpy()

    # ------------------------------------------------------------------
    def run_tenant_chunked(self, tables: RiskTables,
                           straggler_hist: Optional[Dict[int, float]] = None,
                           overlapped: bool = True) -> RunReport:
        """Multi-tenant execution per the tenancy plan.

        ``overlapped=True`` (default) runs the event-driven pipeline —
        compute(k) launches as soon as chunk k lands, staging of chunk k+1
        overlaps it.  ``overlapped=False`` is the blocking schedule (stage
        *all* tenants, then launch compute), kept only so a measurement can
        show what the overlap buys.
        """
        t_start = time.perf_counter()
        tasks = self.pool.plan(tables.num_trials, uniform=True)
        resident = self._resident_tables(tables)
        host_yet = self._host_yet(tables)
        agg_ret, agg_lim = float(tables.agg_ret), float(tables.agg_lim)
        chunk = self._chunk(tables)

        def stage_fn(t: TenantTask):
            rows = host_yet[t.start:t.stop]
            # neutral rows: pad event id 0 -> loss 0, zeroed on the device
            return {"yet": PaddedRows(rows, t.pad) if t.pad else rows}

        def compute_fn(t: TenantTask, arrays):
            elt, occ_ret, occ_lim = resident[t.pdev]
            return self._step(arrays["yet"], elt, occ_ret, occ_lim,
                              agg_ret, agg_lim, chunk)

        ylt = np.zeros(tables.num_trials, np.float32)
        if overlapped:
            ex = PipelineExecutor(self.pool, streams=self.streams)
            rep = ex.run(tasks, stage_fn, compute_fn, straggler_hist)
            # device->host only after every tenant has been launched
            for t in tasks:
                ylt[t.start:t.stop] = rep.results[t.vdev][:t.size].cpu().numpy()
            return RunReport(ylt, time.perf_counter() - t_start,
                             rep.per_tenant_s(), ex.engine.log, rep.timeline)

        # blocking schedule: stage everything, then compute
        order = reorder_for_stragglers(tasks, straggler_hist)
        engine = StagingEngine(self.pool, streams=self.streams)
        origins = record_origins(self.devices)
        staged = engine.stage(order, stage_fn, block=True)
        base = staged[0].base_s if staged else time.perf_counter()
        now = lambda: time.perf_counter() - base
        launched = []
        for sc in staged:             # launch all (async) — pdevs serialise
            t0 = now()
            out, start, done = launch_after_copy(sc, compute_fn,
                                                 self.streams.compute(
                                                     sc.task.pdev))
            launched.append((sc, out, start, done, t0))
        timeline: List[TenantTimeline] = []
        for sc, out, start, done, t0 in launched:
            if done is not None:
                done.synchronize()
            task = sc.task
            timeline.append(TenantTimeline(
                task.vdev, task.pdev, task.slot, sc.enqueue_s, sc.ready_s,
                t0, now(),
                device_times_ms(origins[task.pdev], sc, start, done)))
            ylt[task.start:task.stop] = out[:task.size].cpu().numpy()
        return RunReport(ylt, time.perf_counter() - t_start,
                         {tl.vdev: tl.compute_s for tl in timeline},
                         engine.log, timeline)

    # ------------------------------------------------------------------
    def input_specs(self, num_trials: Optional[int] = None
                    ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """``name -> (shape, dtype)`` of the step's inputs (no allocation)."""
        cfg = self.cfg
        T = num_trials or cfg.num_trials
        K, M, cat = cfg.events_per_trial, cfg.num_elts, cfg.event_catalog
        return {
            "yet": ((T, K), "int32"),
            "elt": ((cat + 1, M), "float32"),
            "occ_ret": ((M,), "float32"),
            "occ_lim": ((M,), "float32"),
            "agg_ret": ((), "float32"),
            "agg_lim": ((), "float32"),
        }
