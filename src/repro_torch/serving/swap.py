"""Host-tier swap store: the preemption data plane (swap-out / swap-in).

The JAX package's ``repro/serving/swap.py``.  When a higher-priority request
arrives and the slot table or the paged pool is full, the scheduler preempts
a lower-priority victim: the engine snapshots the victim's page blocks (K/V
per attention sublayer and the position rows), its cross-attention page row
(an encoder-decoder arch), its SSM slot records (an SSM or hybrid arch) and
its per-slot decode state to the host, frees the device pages through the
ordinary allocator accounting, and parks a :class:`SwapRecord` here.

* **pinned host store** -- on a CUDA device every array of a record lives
  in page-locked host memory: the snapshot's device-to-host copy into it is
  asynchronous on the engine's stream (a copy into pageable memory would be
  synchronous), and so is the staging back.  Only the victim's *private*
  blocks are uniquely held here -- shared prefix pages stay on the device
  under their other readers -- but the snapshot covers every block, so a
  restore never depends on what happened to the trie meanwhile.
* **staged swap-in** -- :meth:`HostSwapStore.prefetch` stages a record back
  through :class:`repro_torch.core.transfer.StagingEngine` in
  **sequential** mode (the paper's winning host-to-device strategy): pinned
  ``cudaMemcpyAsync`` on a copy stream that waits for nothing, ending in a
  CUDA event.  :meth:`HostSwapStore.fetch` makes the compute stream *wait
  on that event*, with no host synchronisation, so a restore enqueued
  behind it reads the staged copy in order.
* **fault injection** -- a :class:`repro_torch.distributed.fault.FaultPlane`
  can poison reads: :meth:`HostSwapStore.fetch` then raises
  :class:`~repro_torch.distributed.fault.InjectedFault` before handing out
  the staged copy and drops it; the host record is untouched, so a retry
  stages the intact copy again.

Conservation: :meth:`HostSwapStore.pages` is the store's private attention
block count and :meth:`HostSwapStore.pages_by_kind` the per-kind split,
audited by :meth:`repro_torch.serving.kvcache.PagedKVCache.assert_conserved`.

The port samples from ``(seed, local step)`` where the reference folds a
PRNG key, so a record carries the request's ``seed`` where the reference's
carries ``key``; its page blocks are the victim's row as it is (the restore
has no compiled shape to keep), not padded to the page-table width.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.tenancy import (TenancyConfig, TenantTask,
                                      VirtualDevicePool)
from repro_torch.core.transfer import (MeshStagingLanes, StagingEngine,
                                       _tree_bytes, tree_map)
from repro_torch.obs.telemetry import get_telemetry


@dataclasses.dataclass
class SwapRecord:
    """Everything needed to resume a preempted request token-exactly.

    A decode step reads nothing but the page content, the position rows,
    the slot's page-table row and the per-slot scalars below, and sampling
    is a function of ``(seed, lstep)`` -- so restoring these bitwise and
    pointing the page table at pages holding the snapshot makes the rest of
    the decode indistinguishable from an uninterrupted run.  Arrays are
    host tensors (pinned on a CUDA device)."""
    req: Any                        # the preempted request object
    priority: int
    target: int                     # total token budget
    temp: float
    top_k: int
    bucket: int
    ring: int
    tokens: List[int]               # collected so far (resume appends)
    chain_keys: List[bytes]         # prefix-trie keys of the prompt blocks
    written: Set[int]               # blocks the decode ring already wrote
    pos: int                        # per-slot scalars, read off the device
    remaining: int
    lstep: int
    seed: int                       # sampling seed (the reference's key)
    logits: torch.Tensor            # (V,) float32 last logits row
    host_kv: Dict[str, Dict[str, torch.Tensor]]  # sub -> k/v (S, nb, P,
    #                                 Hkv, D): the victim's whole page row
    host_pos: torch.Tensor          # (nb, P) int32 position rows
    n_private: int                  # blocks uniquely held by this record
    preemptions: int = 1            # times this request has been swapped
    t_first: Optional[float] = None  # first-token stamp (TTFT survives)
    host_cross: Optional[Dict[str, torch.Tensor]] = None  # k/v (S, nbc, P,
    #                                 Hkv, D): the cross page row
    n_cross: int = 0                # cross pages held by this record
    host_state: Optional[Dict[str, Any]] = None  # sub -> {ssm, conv}
    n_state: int = 0                # SSM records (one per SSM sublayer)


def _pin(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_pinned() else t.pin_memory()


def _staged_axes(a) -> Tuple[Optional[str], ...]:
    """Logical axes of a staged leaf: page blocks ``(S, nb, P, Hkv, D)`` --
    self- or cross-attention -- split on KV heads, the rest replicated."""
    return ((None, None, None, "kv", None) if a.dim() == 5
            else (None,) * a.dim())


class HostSwapStore:
    """Ticketed host-side store of preempted requests' state, staged back
    to ``device`` (the engine's) by a sequential :class:`StagingEngine`.

    With ``sharder`` on a mesh, a swap-in rides
    :class:`repro_torch.core.transfer.MeshStagingLanes` instead: each mesh
    position's KV-head slice of every page block on its own lane, landing
    as the pools' shards.  The host tier keeps global, unsharded blocks,
    so a record restores onto any mesh (or none)."""

    def __init__(self, device=None, fault_plane: Optional[Any] = None,
                 telemetry: Optional[Any] = None,
                 sharder: Optional[Any] = None):
        self.device = torch.device(device if device is not None else "cpu")
        # sequential mode: the paper's winner for host->device staging
        self.staging = StagingEngine(
            VirtualDevicePool(TenancyConfig(1, 1, "sequential"),
                              devices=[self.device]))
        self.fault_plane = fault_plane
        self.sharder = sharder
        self.lanes: Optional[MeshStagingLanes] = None
        if sharder is not None and sharder.mesh is not None:
            self.lanes = MeshStagingLanes(sharder)
        self._records: Dict[int, SwapRecord] = {}
        # ticket -> its StagedChunk (its MeshStagedChunk on lanes)
        self._staged: Dict[int, Any] = {}
        self._next_ticket = 0
        self.puts = 0
        self.fetches = 0
        self.poisoned_reads = 0
        # CUDA: (start event, end event, bytes) of every prefetch, for the
        # caller's timing; cleared by the caller
        self.prefetch_log: List[Tuple[Any, Any, int]] = []
        self.tel = get_telemetry(telemetry)
        self.retarget_telemetry(self.tel)

    def retarget_telemetry(self, tel: Any) -> None:
        """Re-point the store and its staging engine (and lanes) at
        ``tel``."""
        self.tel = tel
        self.staging.tel = tel
        if self.lanes is not None:
            self.lanes.retarget_telemetry(tel)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def pages(self) -> int:
        """Private attention page blocks held by the host tier."""
        return sum(r.n_private for r in self._records.values())

    def pages_by_kind(self) -> Dict[str, int]:
        """Host-held blocks per state kind (the store half of the per-kind
        two-tier audit)."""
        recs = self._records.values()
        return {"attn": sum(r.n_private for r in recs),
                "cross": sum(r.n_cross for r in recs),
                "ssm": sum(r.n_state for r in recs)}

    def tickets(self) -> List[int]:
        return sorted(self._records)

    def record(self, ticket: int) -> SwapRecord:
        return self._records[ticket]

    @staticmethod
    def _tree(rec: SwapRecord) -> Dict[str, Any]:
        """The arrays a restore reads on the device."""
        tree: Dict[str, Any] = {"kv": rec.host_kv, "pos": rec.host_pos,
                                "logits": rec.logits}
        if rec.host_cross is not None:
            tree["cross"] = rec.host_cross
        if rec.host_state is not None:
            tree["state"] = rec.host_state
        return tree

    # ------------------------------------------------------------------
    def put(self, rec: SwapRecord) -> int:
        # crash-at-swap injection (SIGKILL, no return): the victim is
        # host-gathered but no PREEMPT journal record exists yet
        if self.fault_plane is not None:
            crash = getattr(self.fault_plane, "swap_put_crash", None)
            if crash is not None:
                crash()
        self._pin_record(rec)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._records[ticket] = rec
        self.puts += 1
        if self.tel.enabled:
            self.tel.count("swap.puts")
            self.tel.count("swap.bytes_out", _tree_bytes(self._tree(rec)))
            self.tel.gauge("swap.host_pages", self.pages())
        return ticket

    def _pin_record(self, rec: SwapRecord) -> None:
        """On a CUDA device, page-lock a record's arrays (records read back
        from a checkpoint arrive pageable)."""
        if self.device.type != "cuda":
            return
        for name in ("host_kv", "host_pos", "logits", "host_cross",
                     "host_state"):
            val = getattr(rec, name)
            if val is not None:
                setattr(rec, name, tree_map(_pin, val))

    def prefetch(self, ticket: int) -> None:
        """Enqueue the record's host-to-device copy on the staging engine's
        copy stream and return at once.  Idempotent; called ahead of
        re-admission so the copy overlaps whatever round is on the
        device."""
        if ticket in self._staged:
            return
        tree = self._tree(self._records[ticket])
        self.tel.event("swap.prefetch", ticket=ticket,
                       lanes=self.lanes.n_lanes if self.lanes else 1)
        if self.lanes is not None:
            staged = self.lanes.put(tree, _staged_axes, slot=ticket)
            chunks = staged.chunks
        else:
            task = TenantTask(vdev=0, pdev=0, slot=0, start=0, stop=1)
            staged = self.staging.put(task, tree)
            chunks = [staged]
        for chunk in chunks:
            if chunk.event is not None:
                self.prefetch_log.append((chunk.start_event, chunk.event,
                                          _tree_bytes(chunk.arrays)))
        self._staged[ticket] = staged

    def fetch(self, ticket: int) -> Dict[str, Any]:
        """The record's arrays on the device, ordered for the current
        stream: on a CUDA device the current stream waits on the staged
        copy's event (no host synchronisation) and the staged tensors are
        marked as used there.  A poisoned read (fault plane) raises before
        anything is handed out and drops the staged copy; the host record
        stays intact for the retry."""
        if self.fault_plane is not None:
            try:
                self.fault_plane.swap_read_fault()
            except Exception:
                self.poisoned_reads += 1
                self.tel.count("swap.poisoned_reads")
                self._staged.pop(ticket, None)
                raise
        with self.tel.span("swap.fetch", ticket=ticket):
            self.prefetch(ticket)
            staged = self._staged.pop(ticket)
            if self.lanes is not None:
                nbytes = sum(_tree_bytes(c.arrays) for c in staged.chunks)
                # page blocks stay split like the pools; the replicated
                # leaves become global tensors on the engine's device
                arrays = tree_map(
                    lambda t: t.full() if all(e is None for e in t.spec)
                    else t, self.lanes.wait(staged))
            else:
                if staged.event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(staged.event)
                    tree_map(lambda t: t.record_stream(stream),
                             staged.arrays)
                arrays, nbytes = staged.arrays, _tree_bytes(staged.arrays)
        self.fetches += 1
        if self.tel.enabled:
            self.tel.count("swap.fetches")
            self.tel.count("swap.bytes_in", nbytes)
        return arrays

    def pop(self, ticket: int) -> SwapRecord:
        """Remove a record (restored, or dropped terminally)."""
        self._staged.pop(ticket, None)
        rec = self._records.pop(ticket)
        self.tel.gauge("swap.host_pages", self.pages())
        return rec

    def restore_records(self, records: Dict[int, SwapRecord]) -> None:
        """Re-park checkpointed records under their *original* tickets
        (crash recovery: the scheduler's restore queue names tickets).  The
        store must be empty."""
        assert not self._records, "restore_records on a non-empty store"
        for rec in records.values():
            self._pin_record(rec)
        self._records = dict(records)
        self._next_ticket = max(self._records, default=-1) + 1
        self.tel.gauge("swap.host_pages", self.pages())


# ----------------------------------------------------------------------
# checkpoint serialization (crash-safe serving)
# ----------------------------------------------------------------------
def _flatten_state(tree: Any, prefix: str, out: Dict[str, torch.Tensor]):
    """Flatten a nested dict of tensors into '/'-joined names."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_state(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = tree


def _unflatten_state(arrays: Dict[str, Any], prefix: str) -> Any:
    sub: Dict[str, Any] = {}
    for name, arr in arrays.items():
        if not name.startswith(prefix + "/"):
            continue
        parts = name[len(prefix) + 1:].split("/")
        node = sub
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return sub


def _host(t: Any) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(t))


def swap_record_to_payload(rec: SwapRecord, req_record: Any
                           ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Serialize a record for an engine checkpoint: a json-able meta dict
    plus named host tensors (what :mod:`repro_torch.distributed.checkpoint`
    persists; bfloat16 included).  ``req_record`` is the caller-serialized
    request (the journal's SUBMIT payload)."""
    meta = {
        "req": req_record,
        "priority": int(rec.priority), "target": int(rec.target),
        "temp": float(rec.temp), "top_k": int(rec.top_k),
        "bucket": int(rec.bucket), "ring": int(rec.ring),
        "tokens": [int(t) for t in rec.tokens],
        "chain_keys": [k.hex() for k in rec.chain_keys],
        "written": sorted(int(b) for b in rec.written),
        "pos": int(rec.pos), "remaining": int(rec.remaining),
        "lstep": int(rec.lstep), "n_private": int(rec.n_private),
        "preemptions": int(rec.preemptions),
        "t_first": None if rec.t_first is None else float(rec.t_first),
        "n_cross": int(rec.n_cross), "n_state": int(rec.n_state),
        "kv_subs": sorted(rec.host_kv),
        "has_cross": rec.host_cross is not None,
        "state_subs": (sorted(rec.host_state)
                       if rec.host_state is not None else None),
    }
    arrays: Dict[str, torch.Tensor] = {
        "seed": torch.tensor([int(rec.seed)], dtype=torch.int64),
        "logits": rec.logits, "host_pos": rec.host_pos}
    for sub, kv in rec.host_kv.items():
        arrays[f"kv/{sub}/k"] = kv["k"]
        arrays[f"kv/{sub}/v"] = kv["v"]
    if rec.host_cross is not None:
        arrays["cross/k"] = rec.host_cross["k"]
        arrays["cross/v"] = rec.host_cross["v"]
    if rec.host_state is not None:
        for sub, state in rec.host_state.items():
            _flatten_state(state, f"state/{sub}", arrays)
    return meta, arrays


def swap_record_from_payload(meta: Dict[str, Any], arrays: Dict[str, Any],
                             req: Any) -> SwapRecord:
    """Inverse of :func:`swap_record_to_payload`.  ``req`` is the rebuilt
    request object."""
    arrays = {k: _host(v) for k, v in arrays.items()}
    host_kv = {sub: {"k": arrays[f"kv/{sub}/k"], "v": arrays[f"kv/{sub}/v"]}
               for sub in meta["kv_subs"]}
    host_cross = ({"k": arrays["cross/k"], "v": arrays["cross/v"]}
                  if meta["has_cross"] else None)
    host_state = None
    if meta["state_subs"] is not None:
        host_state = {sub: _unflatten_state(arrays, f"state/{sub}")
                      for sub in meta["state_subs"]}
    return SwapRecord(
        req=req, priority=meta["priority"], target=meta["target"],
        temp=meta["temp"], top_k=meta["top_k"], bucket=meta["bucket"],
        ring=meta["ring"], tokens=list(meta["tokens"]),
        chain_keys=[bytes.fromhex(k) for k in meta["chain_keys"]],
        written=set(meta["written"]), pos=meta["pos"],
        remaining=meta["remaining"], lstep=meta["lstep"],
        seed=int(arrays["seed"][0]), logits=arrays["logits"],
        host_kv=host_kv, host_pos=arrays["host_pos"],
        n_private=meta["n_private"], preemptions=meta["preemptions"],
        t_first=meta["t_first"], host_cross=host_cross,
        n_cross=meta["n_cross"], host_state=host_state,
        n_state=meta["n_state"])
