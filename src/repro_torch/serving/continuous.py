"""Continuous batching over a persistent slot table (paged KV-cache decode).

The JAX package's ``repro/serving/continuous.py``.  A fixed-capacity *slot
table* lives on the device and three events interleave per outer step:

* **admission** -- queued requests are prefilled at their page-aligned
  prompt bucket (same-bucket admissions batched into one prefill call of
  power-of-two width), their K/V written into
  :class:`repro_torch.serving.kvcache.PagedKVCache` pages by the scatter
  kernel, and their sampling state scattered into free slot rows.  With
  ``prefix_sharing`` each request's longest chain of registered full-prefix
  blocks maps onto existing pages, and on a pure-attention arch a request
  whose whole padded prompt is registered (and whose prefill logits are
  cached) skips its prefill.  Non-token prefill inputs (a vision arch's
  patch embeddings) salt the chain keys, so only requests with identical
  extras share pages, and same-bucket prefills are batched per set of
  extra names, the extras stacked with zero rows for the padding;
* **one decode micro-round** -- ``inner_steps`` masked decode steps over
  *all* capacity rows with no host synchronisation inside (the reference's
  one ``lax.scan``), followed by a CUDA event that
  :meth:`RoundHandle.ready` queries.  On a CUDA device a round is one
  CUDA graph (:class:`RoundProgram`, the reference's jitted ``round_fn``):
  captured at the first dispatch of its key ``(steps, all_greedy,
  any_topk)`` -- counted by ``decode_traces`` and ``trace.decode``, as the
  reference counts its traces -- and replayed on the current stream at
  every later one; on the CPU, and on the card with
  ``round_graphs=False``, its steps are enqueued op by op;
* **retirement** -- rows whose token budget ran out are collected on the
  host, their pages' refcounts dropped, their slots freed.

SSM sublayers (mamba2, and jamba's Mamba-2 layers beside its attention
pages) keep their decode state dense in the slot table, a ``(n_stages,
capacity, H, P, N)`` SSD state and a ``(n_stages, capacity, W-1,
conv_dim)`` convolution window per sublayer: admission writes the
prefilled state into the slot's row, a decode step writes every row's new
state in place through ``torch.where(active, new, old)`` (masked rows stay
frozen, with no host synchronisation), and an arch without attention pages
nothing.  That state is neither paged nor cached, so only a pure-attention
arch skips a prefill or caches its logits (the reference's ``_pure_attn``);
a hybrid arch shares its attention pages all the same.

An encoder-decoder arch (whisper) carries a second paged kind, ``cross``:
admission takes the request's row of ``cross_blocks = ceil(S_enc /
page_size)`` private pages from the pool's cross space
(:meth:`PagedKVCache.alloc_cross`) and writes its prefill's cross K/V into
them once, by the scatter kernel, and its cross page table row
(``cross_pt``); a decode step runs each decoder layer's paged
self-attention, then gathers the row's cross pages into a dense ``(C,
S_enc, Hkv, D)`` view and attends to it (the reference's ``naive_attention``,
as it does), then the MLP.  Frames salt the chain keys like any extra
input; the cross pages are per request, so such an arch never skips a
prefill.

Rows are masked, not compacted: an inactive row samples into the void (its
emission is dropped) and writes its K/V and position to the reserved TRASH
page.  Copy-on-write rides the dispatch path: decode writes land at
``pos % ring``, so the blocks a round will write are known on the host, and
:meth:`ContinuousBatchingEngine.dispatch_round` forks every shared page
among them (:meth:`PagedKVCache.note_write`; one page copy + page-table
remap per fork) before the round is enqueued.

State is updated in place: the reference donates its state pytree to every
jit so XLA aliases the pools; here the pools, position pool and page table
*are* the state, and every write -- position pool first, then per layer the
new token's K/V, then the decode kernel's read -- is ordered on one stream.

Greedy token-exactness: an admitted request decodes through exactly the same
prefill (same left-padded bucket prompt; batched prefill rows are
independent) and per-token arithmetic as ``ServingEngine.generate`` on that
padded prompt, with the same ``(seed, local step)`` sampling schedule -- so
each row's greedy tokens match the blocking engine, whatever its neighbours
do.  Prefix sharing preserves this: a block is shared only when the whole
padded prompt up to its end is byte-identical, forks copy pages before the
first divergent write, and cached admission logits are the stored output of
the identical earlier prefill.

Preemption (overload survival): a live row can be *swapped out* --
:meth:`ContinuousBatchingEngine.preempt` snapshots its page blocks, its
cross page row, its SSM records and its per-slot decode state into pinned
host memory (one gather and one device-to-host copy on the engine's stream,
completed by one CUDA event), parks them in a
:class:`repro_torch.serving.swap.HostSwapStore`, drops its page references
through the ordinary allocator accounting and vacates the row *in place*
(``remaining`` 0, the page-table and cross rows SENTINEL).
:meth:`ContinuousBatchingEngine.try_restore` re-admits it: unwritten prefix
blocks still registered are re-shared from the trie, the record is staged
back on a copy stream (prefetched ahead), and the *fresh* pages alone --
distinct, never TRASH -- receive the snapshot through the scatter kernel
(``paged_admit_kv`` for the attention blocks and their positions, one launch
a sublayer; ``paged_prefill_scatter`` for the cross pages), the SSM records
and the slot scalars written back in place.  Every state tensor keeps its
storage, so a captured round goes on replaying across any number of swaps.
The reference rebuilds its state pytree in jitted ``evict_fn`` /
``restore_fn`` and pads the restore to the page-table width with TRASH
redirects so that it traces once; the port has no shape to keep.
Preemption needs a quiesced engine (no round in flight): the scheduler
collects first.  A :class:`repro_torch.distributed.fault.FaultPlane` hooks
the top of :meth:`ContinuousBatchingEngine.dispatch_round` and
:meth:`ContinuousBatchingEngine.try_admit_batch`, raising before anything
changes.

On a device mesh (``ServingEngine(..., sh=serving_sharder(mesh))``, the
reference's ``--mesh``) the K/V pools of :meth:`_init_state` are split on
KV heads over the mesh's "model" axis (:mod:`repro_torch.serving.kvcache`),
each decode step, admission, copy-on-write and restore runs a shard at a
time through the sharded kernel wrappers, and everything else -- weights,
page table, position pool, SSM state, sampling state -- is global on the
mesh's first device, where the one controller computes it once.  A swap
snapshot gathers the shards into global host blocks and a swap-in stages
each shard's heads on its own lane
(:class:`repro_torch.core.transfer.MeshStagingLanes`), so a record restores
onto any mesh.  A 1x1 mesh is bit for bit the meshless engine; the per-shard
decode is bit for bit its heads of the whole call, so wider meshes are too.

MoE archs (olmoe) are the exception, as in the reference: expert-capacity
routing couples the rows of a batch -- a prefill's rows, and every decode
step's capacity rows, masked ones included -- so a MoE row is only
statistically exchangeable with ``generate``, and a shared page holds *a*
valid prefill of its chain.  The contract there is engine against engine on
identical admissions (``supported_modes`` says ``"statistical"``).

Without a MoE sublayer no masked row's step reaches a live row, so the
engine hands the step's row mask to the paged decode kernel, which leaves
masked rows unread (their attention output is zero, where the reference
computes it and throws it away): a round of 64 capacity rows pays for the
live rows' pages only.  ``round.masked_row_steps`` counts the row-steps so
skipped; a MoE engine passes no mask and counts none.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ATTN, MOE, NONE, ArchConfig
from repro_torch.core.tenancy import resolve_devices
from repro_torch.core.transfer import tree_map
from repro_torch.distributed.fault import InjectedFault
from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_cross_attention, apply_embedding,
                                       apply_mlp, apply_rmsnorm,
                                       apply_unembed, pad_vocab)
from repro_torch.models.model import _sinusoid_at
from repro_torch.models.ssm import (apply_ssm_decode, checkpoint_slot_state,
                                    init_ssm_state, restore_slot_state)
from repro_torch.models.transformer import apply_ffn, stage_view
from repro_torch.obs.telemetry import Telemetry, get_telemetry
from repro_torch.serving.engine import (CudaGraphs, ServingEngine,
                                        capture_counted, count_replay,
                                        extras_to_device,
                                        resolve_extra_inputs, sample_rows,
                                        to_device)
from repro_torch.serving.kvcache import (POS_SENTINEL, PagedKVCache,
                                         copy_page, gather_cross,
                                         gather_pages, paged_admit,
                                         paged_admit_cross,
                                         paged_attention_decode, ssm_subs,
                                         state_kinds)
from repro_torch.serving.swap import HostSwapStore, SwapRecord


def _has_moe(cfg: ArchConfig) -> bool:
    """Does any sublayer's MLP route through experts?  Expert capacity then
    couples a step's rows, masked ones included."""
    return any(mlp == MOE for _, mlp in cfg.block_schedule())


@dataclasses.dataclass
class _Slot:
    """Host-side record of one occupied slot-table row."""
    req: Any                       # duck-typed: .prompt/.max_new_tokens/...
    target: int
    temp: float                    # resolved sampling params, mirrored on
    top_k: int                     # the host so dispatch_round can pick the
    bucket: int = 0                # sampling strength
    ring: int = 0
    planned: int = 0               # decode steps already dispatched (the
    tokens: List[int] = dataclasses.field(  # CoW write scan runs at dispatch)
        default_factory=list)
    t_first: Optional[float] = None  # wall stamp of the first collected token
    priority: int = 1              # the request's tier (preemption order)
    preemptions: int = 0           # times this request has been swapped out
    chain_keys: List[bytes] = dataclasses.field(default_factory=list)
    seed: int = 0


@dataclasses.dataclass
class RoundHandle:
    """One dispatched (not yet collected) decode micro-round.

    ``emitted`` / ``act`` / ``nonfinite`` are host tensors (pinned, on a
    CUDA device) that the round's own copies fill: collecting round k waits
    for round k's ``done`` event only, never for a round k+1 enqueued behind
    it on the same stream."""
    emitted: torch.Tensor          # (steps, C) int32, -1 where row inactive
    act: torch.Tensor              # (steps, C) bool
    nonfinite: torch.Tensor        # () int64: live row-steps so far whose
    steps: int                     # logits were not all finite
    t_start: float
    rnd: int = -1                  # round ordinal, for the round-span event
    done: Any = None               # CUDA event after the round (None: CPU)
    start: Any = None              # CUDA event before the round

    def ready(self) -> bool:
        """Non-blocking probe: has the round's device work finished?  A CUDA
        event query; work on the CPU has finished when dispatch returns."""
        return True if self.done is None else bool(self.done.query())

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()


@dataclasses.dataclass
class CollectResult:
    finished: List[Tuple[Any, np.ndarray, int]]   # (request, tokens, slot)
    active_steps: np.ndarray       # (C,) decode steps each row was live for
    slot_reqs: List[Optional[Any]]  # slot -> request, pre-retirement snapshot
    retired: List[Any] = dataclasses.field(default_factory=list)


RoundKey = Tuple[int, bool, bool]       # (steps, all_greedy, any_topk)



def _addresses(tree: Any, path: str = "") -> List[Tuple[str, int]]:
    """(path, data_ptr) of every tensor in a dict / list nest (every shard
    of a :class:`ShardedTensor`)."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree.data_ptr())]
    if isinstance(tree, ShardedTensor):
        return [(f"{path}/{p}", t.data_ptr())
                for p, t in enumerate(tree.locals)]
    if isinstance(tree, dict):
        return [a for k, v in tree.items()
                for a in _addresses(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [a for i, v in enumerate(tree)
                for a in _addresses(v, f"{path}/{i}")]
    return []


@dataclasses.dataclass
class CapturedRound:
    """One key's round as a graph: it writes its emissions into ``emitted``
    and ``act`` and reads the state at the addresses it was captured at."""
    graph: Any                     # replay() enqueues the round
    emitted: torch.Tensor          # (steps, C) int32
    act: torch.Tensor              # (steps, C) bool
    counts: List[Dict[str, int]]   # kernel counts one replay adds
    held: List[Any]                # buffers it reads besides the state
    capture_ms: float              # host time of the capture
    replays: int = 0


class RoundProgram:
    """One decode round per key ``(steps, all_greedy, any_topk)`` as a
    captured graph, replayed at every later dispatch of the key.

    At a key's first dispatch the round runs eagerly on the backend's
    capture stream -- real work with real results, which also warms the
    libraries and allocates the kernels' scratch for that stream outside
    any graph -- and the same steps are then captured into the key's graph,
    writing into static ``emitted`` / ``act`` buffers.  Capture runs the
    wrappers' Python, not their kernels, so the kernel counts it added are
    taken back out and added at every replay.  A graph reads the state
    where it was captured: every state and parameter tensor must keep its
    storage (all writes are in place), and a replay raises if one moved.
    Nothing falls back to eager rounds: a failed capture or replay raises.
    ``backend`` is :class:`CudaGraphs` on the card (a test gives a stub)."""

    def __init__(self, backend):
        self.backend = backend
        self.rounds: Dict[RoundKey, CapturedRound] = {}
        self._addresses: Optional[List[Tuple[str, int]]] = None

    def run(self, eng: "ContinuousBatchingEngine", key: RoundKey
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Enqueue ``eng``'s round for ``key``; returns the (static) buffers
        its emissions land in."""
        cap = self.rounds.get(key)
        if cap is None:
            return self._first(eng, key)
        self._check_addresses(eng)
        cap.graph.replay()
        cap.replays += 1
        count_replay(cap.counts)
        return cap.emitted, cap.act

    def _first(self, eng: "ContinuousBatchingEngine", key: RoundKey
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        steps, all_greedy, any_topk = key
        emitted = torch.empty((steps, eng.capacity), dtype=torch.int32,
                              device=eng.device)
        act = torch.empty((steps, eng.capacity), dtype=torch.bool,
                          device=eng.device)

        def enqueue():
            eng._enqueue_round(emitted, act, all_greedy, any_topk)

        self.backend.run_beside(enqueue)
        graph, added, capture_ms = capture_counted(self.backend, enqueue)
        self._check_addresses(eng)
        self.rounds[key] = CapturedRound(graph, emitted, act, added,
                                         self.backend.take_held(), capture_ms)
        return emitted, act

    def _check_addresses(self, eng: "ContinuousBatchingEngine") -> None:
        """Record the state's and parameters' addresses at the first
        capture; raise if any differs later."""
        now = _addresses({"state": eng.state, "params": eng.params})
        if self._addresses is None:
            self._addresses = now
        elif now != self._addresses:
            moved = [p for (p, a), (q, b) in zip(now, self._addresses)
                     if p != q or a != b] or ["the tree's layout"]
            raise RuntimeError(
                f"round program: {moved[0]} is not where the captured "
                "rounds read it; state must be written in place")


class ContinuousBatchingEngine:
    """Masked fixed-step decode over a persistent slot table.

    Drive it through :class:`repro_torch.serving.multitenant.
    MultiTenantScheduler` (``mode="continuous"``) or directly::

        eng = ContinuousBatchingEngine(engine, capacity=4)
        for req, tokens in eng.run_all(requests): ...

    On a CUDA device its rounds go through a :class:`RoundProgram`;
    ``round_graphs=False`` enqueues them op by op there too, for
    comparison.
    """

    def __init__(self, engine: ServingEngine, capacity: int = 8,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 inner_steps: int = 4, max_prompt_len: int = 128,
                 prefix_sharing: bool = True,
                 preserve_pristine: Any = True,
                 batch_admission: bool = True,
                 logits_cache_size: int = 32,
                 swap: bool = True,
                 fault_plane: Optional[Any] = None,
                 admission_retry_limit: int = 8,
                 telemetry: Optional[Telemetry] = None,
                 device=None, round_graphs: bool = True):
        if device is not None:
            dev = resolve_devices(1, device)[0]        # raises: no card
            if dev != engine.device:
                raise ValueError(f"device {dev}: the engine's parameters "
                                 f"live on {engine.device}")
        cfg = engine.cfg
        self.engine = engine
        self.cfg = cfg
        self.sh = engine.sh
        self.device = engine.device
        self.params = engine.params
        self.bundle = engine.bundle
        self.capacity = capacity
        self.inner_steps = inner_steps
        self.max_prompt_len = max_prompt_len
        self.n_stages = cfg.num_layers // cfg.stage_period
        self.sched = cfg.block_schedule()[:cfg.stage_period]
        # a masked row's step reaches no live row unless experts route it:
        # then the decode kernel leaves masked rows unread
        self.skip_masked_rows = not _has_moe(cfg)
        self.page_size = page_size
        self.state_kinds = state_kinds(cfg)
        self.ssm_subs = ssm_subs(cfg)
        # enc-dec: the whole encoder output's cross K/V pages per request,
        # written once at admission into the pool's separate cross space
        self.cross_blocks = (-(-cfg.encoder_seq_len // page_size)
                             if cfg.enc_dec else 0)
        max_ring = self._ring_len(self.bucket_len(max_prompt_len))
        self.kv = PagedKVCache(cfg, capacity, page_size,
                               -(-max_ring // page_size), num_pages,
                               cross_blocks=self.cross_blocks)
        self.prefix_sharing = bool(prefix_sharing and self.kv.attn_subs)
        # pristine-preserve policy: False = never copy; True (default) =
        # reuse-aware (preserve a sole-owner registered page only once its
        # chain has recorded a sharing hit); "always" = preserve every time
        self.preserve_pristine = preserve_pristine
        self.batch_admission = batch_admission
        # a prefill skip rebuilds a row from shared pages and cached logits
        # alone: cross pages are per request and SSM state is neither paged
        # nor cached, so only pure-attention archs skip a prefill (or cache
        # its logits)
        self._pure_attn = {k.name for k in self.state_kinds} == {"attn"}
        self.logits_cache_size = int(logits_cache_size)
        self._logits_cache: "collections.OrderedDict[bytes, torch.Tensor]" = \
            collections.OrderedDict()
        # preemption: every state kind has a host snapshot (attention and
        # cross pages as page blocks, SSM slot state as fixed-width
        # records), so any arch preempts when swap is on
        self.fault_plane = fault_plane
        self.can_preempt = bool(swap) and all(
            k.swappable for k in self.state_kinds)
        self.admission_retry_limit = int(admission_retry_limit)
        self.rejected: List[Any] = []   # run_all's terminal REJECTED requests
        # first uses of a round key: the reference counts its round_fn's
        # traces, one per (steps, all_greedy, any_topk)
        self.decode_traces = 0
        self._round_keys: set = set()
        self.prefill_calls = 0     # host-side prefill invocations (batched)
        self.prefill_skips = 0     # admissions served from the logits cache
        self.rounds = 0
        self.row_steps = 0         # sum over rounds of live rows per step
        self.nonfinite_rows = 0    # live row-steps with a non-finite logit
        self.preemptions = 0
        self.restores = 0
        # lane/shard ordinal for telemetry: the lowest device ordinal of the
        # mesh the pools are split over (0 on the single-device path)
        self.pdev = (min(d.index or 0 for d in
                         self.sh.mesh.position_devices())
                     if self.sh.mesh is not None else 0)
        self.tel = get_telemetry(telemetry)
        self._round_log: List[Tuple[int, int, int]] = []
        self.kv.tel = self.tel
        self.swap_store = (HostSwapStore(self.device, fault_plane=fault_plane,
                                         telemetry=self.tel, sharder=self.sh)
                           if self.can_preempt else None)
        # CUDA-event windows: (start, end) per prefill call and per round
        self._prefill_events: List[Tuple[Any, Any]] = []
        self.round_ms: List[float] = []
        self.state = self._init_state()
        self.round_program: Optional[RoundProgram] = (
            RoundProgram(CudaGraphs(self.device))
            if round_graphs and self.device.type == "cuda" else None)
        self._slots: List[Optional[_Slot]] = [None] * capacity
        self._free_slots: List[int] = list(range(capacity - 1, -1, -1))

    # ------------------------------------------------------------------
    def bucket_len(self, prompt_len: int) -> int:
        """Prompts are left-padded to a page-aligned bucket."""
        p = self.page_size
        return max(p, -(-prompt_len // p) * p)

    def _ring_len(self, bucket: int) -> int:
        w = self.cfg.sliding_window
        return min(bucket, w) if w is not None else bucket

    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    def live_after(self, steps: int) -> bool:
        """Will any current row still be live after ``steps`` more decode
        steps?  (Host-side: collected tokens exclude any in-flight round.)"""
        return any(s is not None and s.target - len(s.tokens) > steps
                   for s in self._slots)

    def free_slot_count(self) -> int:
        return len(self._free_slots)

    def live_priorities(self) -> List[int]:
        """Priorities of every live row, in no particular order."""
        return [s.priority for s in self._slots if s is not None]

    def occupancy(self) -> float:
        """Fraction of row-steps that decoded a live row, over collected
        micro-rounds."""
        total = sum(steps * cap for steps, cap, _ in self._round_log)
        if not total:
            return 0.0
        return sum(live for _, _, live in self._round_log) / total

    @classmethod
    def supported_modes(cls, cfg: ArchConfig) -> Dict[str, Dict[str, Any]]:
        """Capability probe: what each serving mode offers for ``cfg`` (the
        reference's table: the state kinds a row carries, whether rows can
        be swap-preempted, whether prefix sharing applies -- through
        window-phase keys on a sliding-window arch -- and whether continuous
        decode is bitwise or, under MoE capacity routing, only
        statistically exchangeable with ``generate``)."""
        kinds = state_kinds(cfg)
        names = [k.name for k in kinds]
        moe = _has_moe(cfg)
        cont = {
            "supported": True,
            "state_kinds": names,
            "preemptable": all(k.swappable for k in kinds),
            "prefix_sharing": "attn" in names,
            "window_phase_keys": ("attn" in names
                                  and cfg.sliding_window is not None),
            "exactness": "statistical" if moe else "bitwise",
        }
        return {"blocking": {"supported": True, "exactness": "reference"},
                "overlapped": {"supported": True,
                               "exactness": cont["exactness"]},
                "continuous": cont}

    # ------------------------------------------------------------------
    def _init_state(self) -> Dict[str, Any]:
        cfg, c, dev = self.cfg, self.capacity, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        # the K/V pools (self- and cross-attention) split on KV heads over
        # the mesh; everything else global on the engine's device
        caches = self.kv.make_pools(self.n_stages, dev, self.sh)
        for name in self.ssm_subs:
            caches[name] = {k: v[None].repeat((self.n_stages,)
                                              + (1,) * v.dim())
                            for k, v in init_ssm_state(cfg, c, dev).items()}
        extra = {}
        if self.cross_blocks:
            caches["cross"] = self.kv.make_cross_pools(self.n_stages, dev,
                                                       self.sh)
            # per-slot cross page rows (the cross space's page table)
            extra["cross_pt"] = self.kv.make_cross_page_table(dev)
        return {
            **extra,
            "caches": caches,
            "page_table": self.kv.make_page_table(dev),
            "pos_pool": self.kv.make_pos_pool(dev),
            "logits": torch.zeros((c, pad_vocab(cfg.vocab_size)),
                                  dtype=torch.float32, device=dev),
            "pos": torch.zeros((c,), **i32),
            "ring": torch.ones((c,), **i32),
            "remaining": torch.zeros((c,), **i32),
            "temps": torch.zeros((c,), dtype=torch.float32, device=dev),
            "topks": torch.zeros((c,), **i32),
            "seeds": torch.zeros((c,), dtype=torch.int64, device=dev),
            "lstep": torch.zeros((c,), **i32),
            "nonfinite": torch.zeros((), dtype=torch.int64, device=dev),
            "trash": torch.full((), PagedKVCache.TRASH, **i32),
            "pos_sentinel": torch.full((), POS_SENTINEL, **i32),
        }

    def _event(self):
        return self.engine._event()

    # ------------------------------------------------------------------
    # the decode step (enqueue only: no host synchronisation)
    # ------------------------------------------------------------------
    def _decode_step(self, emitted_row: torch.Tensor, act_row: torch.Tensor,
                     all_greedy: bool, any_topk: bool) -> None:
        cfg, st, params = self.cfg, self.state, self.params
        p_sz = self.page_size
        active = st["remaining"] > 0
        tok = sample_rows(st["logits"], st["temps"], st["topks"], st["seeds"],
                          st["lstep"], all_greedy=all_greedy,
                          any_topk=any_topk)
        pos, ring, pt = st["pos"], st["ring"], st["page_table"]
        page = off = None
        if self.kv.attn_subs:
            slot_log = torch.remainder(pos, ring)
            blk = torch.div(slot_log, p_sz, rounding_mode="floor")
            off = torch.remainder(slot_log, p_sz)
            page = torch.gather(pt, 1, blk[:, None].long())[:, 0]
            page = torch.where(active, page, st["trash"])
            # this step's positions first: the decode read validates
            # against them (masked rows write POS_SENTINEL into TRASH)
            st["pos_pool"][page.long(), off.long()] = torch.where(
                active, pos, st["pos_sentinel"])

        x = apply_embedding(params["embed"], tok[:, None], cfg)
        if not cfg.use_rope:
            # per-row positions (C, 1, 1) -> (C, 1, d), read on the device
            x = x + _sinusoid_at(pos[:, None, None],
                                 cfg.d_model).to(x.dtype)
        if self.cross_blocks:
            x = self._enc_dec_layers(x, active, pt, page, off, pos)
        else:
            x = self._decoder_layers(x, active, pt, page, off, pos)
        h = apply_rmsnorm(params["final_norm"], x)
        new_logits = apply_unembed(params["embed"], h, cfg)[:, 0]
        st["nonfinite"] += (active
                            & ~torch.isfinite(new_logits).all(dim=-1)).sum()
        st["logits"].copy_(torch.where(active[:, None], new_logits,
                                       st["logits"]))
        step = active.to(torch.int32)
        pos.add_(step)
        st["remaining"].sub_(step)
        st["lstep"].add_(step)
        emitted_row.copy_(torch.where(active, tok, -1))
        act_row.copy_(active)

    def _decoder_layers(self, x: torch.Tensor, active: torch.Tensor,
                        pt: torch.Tensor, page, off, pos: torch.Tensor
                        ) -> torch.Tensor:
        """The decoder-only stages of one step: paged attention or the SSM
        decode per sublayer, then its MLP."""
        cfg, st, params = self.cfg, self.state, self.params
        mask = active if self.skip_masked_rows else None
        for s in range(self.n_stages):
            sp = stage_view(params["stages"], s)
            sc = stage_view(st["caches"], s)
            for i, (mixer, mlp) in enumerate(self.sched):
                sub = sp[f"sub{i}"]
                hin = apply_rmsnorm(sub["norm1"], x)
                if mixer == ATTN:
                    hout, _ = paged_attention_decode(
                        sub["attn"], hin, sc[f"sub{i}"], pt, page, off, pos,
                        cfg, st["pos_pool"], self.sh, mask)
                else:
                    hout, new = apply_ssm_decode(sub["mamba"], hin,
                                                 sc[f"sub{i}"], cfg)
                    # masked rows keep their state (attention rows are
                    # masked by writing TRASH instead)
                    for k, old in sc[f"sub{i}"].items():
                        keep = active.reshape((-1,) + (1,) * (old.dim() - 1))
                        old.copy_(torch.where(keep, new[k], old))
                x = x + hout
                if mlp != NONE:
                    # every capacity row, masked ones too: under MoE they
                    # compete for expert capacity, as in the reference
                    x = x + apply_ffn(sub, apply_rmsnorm(sub["norm2"], x),
                                      cfg)
        return x

    def _enc_dec_layers(self, x: torch.Tensor, active: torch.Tensor,
                        pt: torch.Tensor, page: torch.Tensor,
                        off: torch.Tensor, pos: torch.Tensor
                        ) -> torch.Tensor:
        """The encoder-decoder's decoder layers of one step: paged
        self-attention, then the read-only gather of each row's cross pages
        and the cross-attention to them, then the MLP -- ``decode_fn``'s
        residual structure operation for operation, per row."""
        cfg, st, params = self.cfg, self.state, self.params
        mask = active if self.skip_masked_rows else None
        self_pool = st["caches"][self.kv.attn_subs[0]]
        cross, cpt = st["caches"]["cross"], st["cross_pt"]
        for s in range(self.n_stages):
            sp = stage_view(params["dec_stages"], s)
            a, _ = paged_attention_decode(
                sp["attn"], apply_rmsnorm(sp["norm1"], x),
                stage_view(self_pool, s), pt, page, off, pos, cfg,
                st["pos_pool"], self.sh, mask)
            x = x + a
            ck = gather_cross(cross["k"][s], cpt, cfg.encoder_seq_len)
            cv = gather_cross(cross["v"][s], cpt, cfg.encoder_seq_len)
            x = x + apply_cross_attention(
                sp["cross"], apply_rmsnorm(sp["norm_c"], x),
                (ck.to(x.dtype), cv.to(x.dtype)), cfg, decode=True)
            x = x + apply_mlp(sp["mlp"], apply_rmsnorm(sp["norm2"], x), cfg)
        return x

    def _enqueue_round(self, emitted: torch.Tensor, act: torch.Tensor,
                       all_greedy: bool, any_topk: bool) -> None:
        """A round's steps, op by op, emissions into ``emitted`` / ``act``
        (steps, C): what a round program captures."""
        for i in range(emitted.shape[0]):
            self._decode_step(emitted[i], act[i], all_greedy, any_topk)

    # ------------------------------------------------------------------
    # device halves of admission and copy-on-write
    # ------------------------------------------------------------------
    def _write_row(self, slot: int, pages: np.ndarray, logits0: torch.Tensor,
                   remaining: int, temp: float, topk: int, seed: int,
                   pos: int, ring: int, lstep: int = 0) -> torch.Tensor:
        """Page-table row + the slot's sampling state, in place and without
        a host synchronisation (``fill_`` takes its scalar as a kernel
        argument; an index assignment of a Python number copies it from
        pageable memory); returns the row's pages on the device."""
        st = self.state
        row = np.full((self.kv.max_blocks,), PagedKVCache.SENTINEL, np.int32)
        row[:len(pages)] = pages
        row_dev = to_device(row, self.device)
        st["page_table"][slot].copy_(row_dev)
        st["logits"][slot].copy_(logits0)
        for name, value in (("pos", pos), ("ring", ring),
                            ("remaining", remaining), ("temps", temp),
                            ("topks", topk), ("seeds", seed),
                            ("lstep", lstep)):
            st[name][slot].fill_(value)
        return row_dev[:len(pages)]

    def _admit_kv(self, pages_dev: torch.Tensor,
                  caches: Dict[str, Any]) -> None:
        """Fused compute-then-scatter: the bucket's freshly prefilled K/V
        goes straight into its allocated pages and its positions into the
        position pool, one scatter-kernel launch per attention sublayer."""
        pos_src = caches[self.kv.attn_subs[0]]["pos"][0, 0]       # (ring,)
        for i, name in enumerate(self.kv.attn_subs):
            paged_admit(self.state["caches"][name],
                        None if i else self.state["pos_pool"], pages_dev,
                        {kind: caches[name][kind][:, 0] for kind in "kv"},
                        pos_src, self.sh)

    def _cow(self, src: int, dst: int, slot: int, blk: int) -> None:
        """Copy-on-write fork: copy page ``src`` -> ``dst`` in every
        attention pool and the position pool, and repoint the writer's
        page-table entry."""
        st = self.state
        for name in self.kv.attn_subs:
            for kind in "kv":
                copy_page(st["caches"][name][kind], src, dst)
        st["pos_pool"][dst].copy_(st["pos_pool"][src])
        st["page_table"][slot, blk].fill_(dst)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def try_admit(self, req: Any) -> bool:
        return self.try_admit_batch([req])[0]

    @torch.no_grad()
    def try_admit_batch(self, reqs: List[Any]) -> List[bool]:
        """Admit up to ``len(self._free_slots)`` requests in one go: plan
        (bucket, ring, padded prompt, chain keys, full-prefix probe), one
        batched prefill per prompt bucket for every plan that cannot skip
        it, then admit each in order (re-probing the trie, so same-batch
        prefix sharing works).  Returns one admitted-flag per request;
        rejected requests (slot or page pressure) are untouched.  An
        injected admission stall (fault plane) raises before any prefill or
        page allocation, so the whole batch stays with the caller."""
        if self.fault_plane is not None and reqs:
            self.fault_plane.admission_fault()
        with self.tel.span("admit.batch", n=len(reqs)) as admit_span:
            flags = self._try_admit_batch_inner(reqs)
            admit_span.note(admitted=sum(flags))
        return flags

    def _try_admit_batch_inner(self, reqs: List[Any]) -> List[bool]:
        flags = [False] * len(reqs)
        plans: List[Dict[str, Any]] = []
        for i, req in enumerate(reqs):
            if len(plans) >= len(self._free_slots):
                break
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            if prompt.size > self.max_prompt_len:
                raise ValueError(
                    f"prompt of {prompt.size} tokens exceeds max_prompt_len="
                    f"{self.max_prompt_len}")
            bucket = self.bucket_len(prompt.size)
            ring = self._ring_len(bucket)
            padded = np.zeros((bucket,), np.int32)
            padded[bucket - prompt.size:] = prompt
            extra = resolve_extra_inputs(self.cfg, req)
            salt = b""
            if extra:
                # non-token prefill inputs feed the prefilled state, so they
                # are part of block identity: requests share pages only
                # under identical extras
                dg = hashlib.sha256()
                for name in sorted(extra):
                    dg.update(name.encode())
                    dg.update(np.ascontiguousarray(
                        np.asarray(extra[name])).tobytes())
                salt = dg.digest()
            keys = (self.kv.chain_keys(padded, ring=ring, salt=salt)
                    if self.prefix_sharing else [])
            # provisional only -- the authoritative share decision re-probes
            # at admit time; this just decides whether to prefill
            skip = bool(keys and self._pure_attn
                        and len(self.kv.lookup_chain(keys)) == len(keys)
                        and keys[-1] in self._logits_cache)
            plans.append(dict(i=i, req=req, bucket=bucket, ring=ring,
                              padded=padded, extra=extra, keys=keys,
                              skip=skip, logits=None, caches=None))
        if not plans:
            return flags
        groups: Dict[Tuple[int, Tuple[str, ...]],
                     List[Dict[str, Any]]] = {}
        for pl in plans:
            if not pl["skip"]:
                gk = (pl["bucket"], tuple(sorted(pl["extra"])))
                groups.setdefault(gk, []).append(pl)
        for (bucket, extra_names), grp in groups.items():
            chunks = [grp] if self.batch_admission else [[pl] for pl in grp]
            for chunk in chunks:
                width = 1 << (len(chunk) - 1).bit_length()
                tokens = np.zeros((width, bucket), np.int32)
                for j, pl in enumerate(chunk):
                    tokens[j] = pl["padded"]
                # the chunk's extras stacked; padding rows are zeros (rows
                # are independent: the pad rows are sliced away)
                extras = {}
                for name in extra_names:
                    rows = [np.asarray(pl["extra"][name]) for pl in chunk]
                    extras[name] = np.stack(
                        rows + [np.zeros_like(rows[0])] * (width - len(chunk)))
                batch = {"tokens": to_device(tokens, self.device),
                         **extras_to_device(extras, self.device)}
                with self.tel.span("admit.prefill", bucket=bucket,
                                   width=width, n=len(chunk)) as sp:
                    t0 = self._event()
                    logits, caches, _ = self.bundle.prefill_fn(self.params,
                                                               batch)
                    t1 = self._event()
                    if self.tel.enabled:
                        # ``call``: this prefill's entry in prefill_ms()
                        sp.note(rids=[getattr(pl["req"], "rid", -1)
                                      for pl in chunk],
                                call=(len(self._prefill_events)
                                      if t0 is not None else None))
                if t0 is not None:
                    self._prefill_events.append((t0, t1))
                self.prefill_calls += 1
                for j, pl in enumerate(chunk):
                    pl["logits"] = logits[j:j + 1]
                    pl["caches"] = {name: {k: a[:, j:j + 1]
                                           for k, a in sub.items()}
                                    for name, sub in caches.items()}
        for pl in plans:
            flags[pl["i"]] = self._admit_planned(pl)
        return flags

    def _admit_planned(self, pl: Dict[str, Any]) -> bool:
        """Page mapping + state scatter for one planned request.  False
        leaves the allocator untouched."""
        req, bucket, ring = pl["req"], pl["bucket"], pl["ring"]
        kv = self.kv
        nb = kv.blocks_for(ring)             # 0 without attention sublayers
        shared: List[int] = []
        will_write: Any = ()
        target = int(req.max_new_tokens)
        if nb and self.prefix_sharing:
            shared = kv.lookup_chain(pl["keys"])[:nb]
            # blocks this request's decode ring-writes will touch
            will_write = {((bucket + t) % ring) // self.page_size
                          for t in range(min(target, ring))}
        cached_logits = None
        if pl["skip"]:
            cached_logits = self._logits_cache.get(pl["keys"][-1])
            if len(shared) < nb or cached_logits is None:
                # the chain (or its logits) was evicted between planning and
                # admission: no prefill result to fall back on -- requeue
                return False
            self._logits_cache.move_to_end(pl["keys"][-1])
        slot = self._free_slots[-1]
        pages = np.zeros((0,), np.int32)
        if nb:
            pages = kv.alloc_shared(slot, shared, nb - len(shared),
                                    will_write)
            if pages is None:
                return False             # pool pressure: retry later
        cross_pages = None
        if self.cross_blocks:
            cross_pages = kv.alloc_cross(slot)
            if cross_pages is None:
                if nb:
                    kv.free(slot)        # undo the attn half
                return False             # cross-space pressure
        self._free_slots.pop()
        temp = getattr(req, "temperature", None)
        if temp is None:
            temp = self.engine.temperature
        topk = int(getattr(req, "top_k", 0) or 0)
        seed = int(getattr(req, "seed", 0) or 0)
        logits0 = cached_logits if pl["skip"] else pl["logits"][0]
        pages_dev = self._write_row(slot, pages, logits0, target, float(temp),
                                    topk, seed, bucket, ring)
        if pl["skip"]:
            self.prefill_skips += 1
            self.tel.count("admit.prefill_skips")
        else:
            caches = pl["caches"]
            if self.cross_blocks:
                # the prefill's {"self", "cross"}: the self caches go to the
                # (single) attention sublayer's pages, the cross K/V once
                # into the slot's private cross pages
                cross_dev = to_device(cross_pages, self.device)
                paged_admit_cross(self.state["caches"]["cross"], cross_dev,
                                  {k: a[:, 0] for k, a in
                                   caches["cross"].items()}, self.sh)
                self.state["cross_pt"][slot].copy_(cross_dev)
                caches = {self.kv.attn_subs[0]: caches["self"]}
            if nb:
                self._admit_kv(pages_dev, caches)
            for name in self.ssm_subs:       # the prefilled state, one row
                for k, rows in self.state["caches"][name].items():
                    rows[:, slot].copy_(caches[name][k][:, 0])
            if self.prefix_sharing and self._pure_attn and pl["keys"]:
                self._logits_cache_put(pl["keys"][-1], pl["logits"][0])
        if self.prefix_sharing and pl["keys"]:
            kv.register(slot, pl["keys"][:nb])
        self._slots[slot] = _Slot(req, target, float(temp), topk,
                                  bucket=bucket, ring=ring,
                                  priority=int(getattr(req, "priority", 1)),
                                  chain_keys=list(pl["keys"][:nb]),
                                  seed=seed)
        return True

    def _logits_cache_put(self, key: bytes, row: torch.Tensor) -> None:
        cache = self._logits_cache
        cache[key] = row
        cache.move_to_end(key)
        while len(cache) > self.logits_cache_size:
            cache.popitem(last=False)

    # ------------------------------------------------------------------
    # decode micro-rounds
    # ------------------------------------------------------------------
    def _resolve_round_writes(self) -> None:
        """Pre-dispatch copy-on-write scan: the blocks each live row will
        write in the coming round are known on the host (``pos % ring``),
        so every shared or pristine-registered page among them is forked
        before the round is enqueued.  Without sharing the scan is
        skipped."""
        if not (self.prefix_sharing and self.kv.attn_subs):
            return
        preserve = bool(self.preserve_pristine)
        require_hit = self.preserve_pristine != "always"
        for c, s in enumerate(self._slots):
            if s is None:
                continue
            n = min(self.inner_steps, s.target - s.planned)
            if n <= 0:
                continue
            blks = sorted({((s.bucket + s.planned + t) % s.ring)
                           // self.page_size for t in range(n)})
            for blk in blks:
                fork = self.kv.note_write(c, blk, preserve=preserve,
                                          require_hit=require_hit)
                if fork is not None:
                    self._cow(fork[0], fork[1], c, blk)
            s.planned += n

    @torch.no_grad()
    def dispatch_round(self) -> RoundHandle:
        """Enqueue one masked micro-round (non-blocking); the caller may
        admit the next requests while it runs on the device.  An injected
        round drop (fault plane) raises before the copy-on-write scan, so a
        bare re-dispatch is sound."""
        if self.fault_plane is not None:
            self.fault_plane.round_fault()
        rnd = self.rounds
        with self.tel.span("round.dispatch", round=rnd, pdev=self.pdev):
            t0 = time.perf_counter()
            with self.tel.span("round.cow"):
                self._resolve_round_writes()
            live = [s for s in self._slots if s is not None]
            all_greedy = all(s.temp <= 0 for s in live)
            any_topk = any(s.top_k > 0 for s in live)
            steps, c = self.inner_steps, self.capacity
            key = (steps, all_greedy, any_topk)
            if key not in self._round_keys:
                self._round_keys.add(key)
                self.decode_traces += 1
                self.tel.count("trace.decode")
            with self.tel.span("round.enqueue", steps=steps,
                               all_greedy=all_greedy):
                start = self._event()
                if self.round_program is not None:
                    emitted, act = self.round_program.run(self, key)
                else:
                    emitted = torch.empty((steps, c), dtype=torch.int32,
                                          device=self.device)
                    act = torch.empty((steps, c), dtype=torch.bool,
                                      device=self.device)
                    self._enqueue_round(emitted, act, all_greedy, any_topk)
                nonfinite = self.state["nonfinite"].clone()
                # the round's results leave its buffers behind the round
                # itself, ahead of anything enqueued later (the next replay
                # of a captured round rewrites them)
                if self.device.type == "cuda":
                    host = [torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                            for t in (emitted, act, nonfinite)]
                    for h, t in zip(host, (emitted, act, nonfinite)):
                        h.copy_(t, non_blocking=True)
                    emitted, act, nonfinite = host
                else:
                    emitted, act = emitted.clone(), act.clone()
                done = self._event()
            self.rounds += 1
        return RoundHandle(emitted, act, nonfinite, steps, t0, rnd=rnd,
                           done=done, start=start)

    def collect(self, handle: RoundHandle) -> CollectResult:
        """Materialise a round's emissions, append tokens to their rows and
        retire rows that hit their budget (pages back to the allocator)."""
        handle.wait()
        emitted = handle.emitted.numpy()
        act = handle.act.numpy()
        if handle.start is not None:
            self.round_ms.append(handle.start.elapsed_time(handle.done))
        self.nonfinite_rows = max(self.nonfinite_rows,
                                  int(handle.nonfinite))
        slot_reqs = [s.req if s is not None else None for s in self._slots]
        active_steps = act.sum(axis=0).astype(np.int64)
        live_steps = int(active_steps.sum())
        self.row_steps += live_steps
        self._round_log.append((handle.steps, self.capacity, live_steps))
        if self.skip_masked_rows:
            self.tel.count("round.masked_row_steps",
                           handle.steps * self.capacity - live_steps)
        self.tel.record_span("round.device", handle.t_start,
                             time.perf_counter(), round=handle.rnd,
                             steps=handle.steps, capacity=self.capacity,
                             live_steps=live_steps, pdev=self.pdev)
        finished: List[Tuple[Any, np.ndarray, int]] = []
        retired: List[_Slot] = []
        for c, s in enumerate(self._slots):
            if s is None:
                continue
            row = emitted[act[:, c], c]
            if row.size and s.t_first is None:
                s.t_first = time.perf_counter()
            s.tokens.extend(int(t) for t in row)
            if len(s.tokens) >= s.target:
                finished.append((s.req,
                                 np.asarray(s.tokens[:s.target], np.int32),
                                 c))
                retired.append(s)
                self.kv.free(c)
                self._slots[c] = None
                self._free_slots.append(c)
        return CollectResult(finished, active_steps, slot_reqs, retired)

    # ------------------------------------------------------------------
    # preemption: swap-out / swap-in (KV tiering)
    # ------------------------------------------------------------------
    def _to_host(self, tree: Any) -> Any:
        """Device tensors -> host tensors: on a CUDA device one pinned
        non-blocking copy per leaf on the current stream, completed by one
        event (the one host synchronisation of a snapshot); on the CPU the
        leaves are already fresh host copies."""
        if self.device.type != "cuda":
            return tree

        def pinned(t: torch.Tensor) -> torch.Tensor:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t, non_blocking=True)

        host = tree_map(pinned, tree)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host

    def _snapshot_slot(self, slot: int, preempting: bool = False
                       ) -> SwapRecord:
        """One live slot as a :class:`SwapRecord` -- a pure read (sharers,
        allocator and device state untouched), shared by :meth:`preempt`
        (which then vacates the slot) and :meth:`snapshot_live` (engine
        checkpoints).  The gathers and the copy to pinned host memory are
        enqueued on the current stream behind the last collected round, and
        the slot's device scalars ride the same copy.  Caller contract: no
        round in flight."""
        s = self._slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is empty")
        if not self.can_preempt:
            raise RuntimeError(
                "engine cannot preempt: swap disabled or the arch registered "
                "an unswappable state kind")
        if self.prefix_sharing:
            assert s.planned == len(s.tokens), \
                "slot snapshot with a decode round in flight"
        kv, st = self.kv, self.state
        pages = kv.owned_pages(slot)
        dev: Dict[str, Any] = {
            "logits": st["logits"][slot].clone(),
            "scalars": torch.stack([st["pos"][slot], st["remaining"][slot],
                                    st["lstep"][slot]]),
            "kv": {}, "pos": st["pos_pool"][:0].clone()}
        if pages:
            idx = to_device(np.asarray(pages, np.int64), self.device)
            # the host tier keeps global blocks (a split pool's heads
            # gathered), so a record restores onto any mesh
            dev["kv"] = {name: {k: gather_pages(st["caches"][name][k], idx)
                                for k in "kv"}
                         for name in kv.attn_subs}
            dev["pos"] = st["pos_pool"].index_select(0, idx)
        n_cross = 0
        if self.cross_blocks:
            cpages = kv.cross_pages_of(slot)
            cidx = to_device(np.asarray(cpages, np.int64), self.device)
            dev["cross"] = {k: gather_pages(st["caches"]["cross"][k], cidx)
                            for k in "kv"}
            n_cross = len(cpages)
        if self.ssm_subs:
            dev["state"] = {name: checkpoint_slot_state(st["caches"][name],
                                                        slot)
                            for name in self.ssm_subs}
        host = self._to_host(dev)
        pos, remaining, lstep = (int(v) for v in host["scalars"])
        written = {((s.bucket + t) % s.ring) // self.page_size
                   for t in range(min(len(s.tokens), s.ring))}
        return SwapRecord(
            req=s.req, priority=s.priority, target=s.target, temp=s.temp,
            top_k=s.top_k, bucket=s.bucket, ring=s.ring,
            tokens=list(s.tokens), chain_keys=list(s.chain_keys),
            written=written, pos=pos, remaining=remaining, lstep=lstep,
            seed=s.seed, logits=host["logits"], host_kv=host["kv"],
            host_pos=host["pos"], n_private=len(kv.private_blocks(slot)),
            preemptions=s.preemptions + (1 if preempting else 0),
            t_first=s.t_first, host_cross=host.get("cross"),
            n_cross=n_cross, host_state=host.get("state"),
            n_state=len(self.ssm_subs))

    def _evict(self, slot: int) -> None:
        """Vacate a row in place: no budget left, the page-table row (and
        cross row) at SENTINEL, so the stale row can neither decode nor
        address pages given to newer requests."""
        st = self.state
        st["remaining"][slot].fill_(0)
        st["page_table"][slot].fill_(PagedKVCache.SENTINEL)
        if self.cross_blocks:
            st["cross_pt"][slot].fill_(PagedKVCache.SENTINEL)

    @torch.no_grad()
    def preempt(self, slot: int) -> int:
        """Swap a live row out to the host tier and vacate its slot: snapshot
        every page block (a pure read), park the record, drop the page
        references through the ordinary accounting (shared pages keep their
        other readers; only the private suffix is host-held) and evict the
        row.  Caller contract: no round in flight.  Returns the ticket."""
        rec = self._snapshot_slot(slot, preempting=True)
        with self.tel.span("swap.out", slot=slot,
                           pages=len(self.kv.owned_pages(slot)),
                           private=rec.n_private, pdev=self.pdev):
            ticket = self.swap_store.put(rec)
            self.kv.swap_out(slot, rec.n_private, cross_blocks=rec.n_cross,
                             state_records=rec.n_state)
            self._evict(slot)
        self._slots[slot] = None
        self._free_slots.append(slot)
        self.preemptions += 1
        self.tel.count("swap.preemptions")
        return ticket

    @torch.no_grad()
    def snapshot_live(self) -> List[Tuple[int, SwapRecord]]:
        """Engine-checkpoint gather: every live slot as a record, in slot
        order, vacating nothing.  Caller contract: no round in flight."""
        return [(c, self._snapshot_slot(c))
                for c, s in enumerate(self._slots) if s is not None]

    def restore_from(self, live: List[SwapRecord],
                     swapped: Dict[int, SwapRecord]) -> int:
        """Rebuild a *fresh* engine from a checkpoint: re-park the host
        tier's ``swapped`` records under their original tickets (seeding the
        empty pool's ledgers), then re-admit every checkpointed ``live``
        record through the ordinary restore.  Returns the live slots
        rebuilt."""
        if not live and not swapped:
            return 0
        assert self.swap_store is not None, "restore_from needs a swap store"
        assert self.active_count() == 0, "restore_from on a non-empty engine"
        with self.tel.span("recovery.restore", live=len(live),
                           swapped=len(swapped), pdev=self.pdev):
            self.swap_store.restore_records(swapped)
            for rec in [*swapped.values(), *live]:
                # a checkpointed live slot was never swapped out of this
                # pool: credit the ledger before try_restore debits it
                self.kv.adopt_swapped(rec.n_private,
                                      cross_blocks=rec.n_cross,
                                      state_records=rec.n_state)
            for rec in live:
                ticket = self.swap_store.put(rec)
                if not self.try_restore(ticket):
                    raise RuntimeError(
                        "recovery: pool/slot pressure rebuilding a "
                        "checkpointed live slot")
        self.tel.count("recovery.slots_restored", len(live))
        return len(live)

    @torch.no_grad()
    def try_restore(self, ticket: int) -> bool:
        """Swap a preempted request back into a free slot, token-exactly.

        Blocks the victim never wrote whose chain is still registered are
        re-shared from the trie (their pages hold the snapshot's bits);
        every other block gets a fresh page, and only those fresh pages
        receive the staged copy.  The slot's scalars are written back, so
        the rest of the decode -- same ``(seed, lstep)`` schedule, positions
        and page content -- is that of an uninterrupted run.

        Returns False (allocator untouched, record kept) under slot or page
        pressure; raises :class:`InjectedFault` on a poisoned swap read
        (record kept for the retry)."""
        if not self._free_slots:
            return False
        kv = self.kv
        rec = self.swap_store.record(ticket)
        nb = kv.blocks_for(rec.ring)         # 0 without attention sublayers
        # pristine prefix: leading blocks the decode ring never wrote
        pristine = 0
        while pristine < nb and pristine not in rec.written:
            pristine += 1
        shared: List[int] = []
        if self.prefix_sharing and rec.chain_keys:
            shared = kv.lookup_chain(rec.chain_keys)[:pristine]
        will_write = ({((rec.pos + t) % rec.ring) // self.page_size
                       for t in range(min(rec.remaining, rec.ring))}
                      if nb else ())
        slot = self._free_slots[-1]
        pages = np.zeros((0,), np.int32)
        if nb:
            pages = kv.alloc_shared(slot, shared, nb - len(shared),
                                    will_write)
            if pages is None:
                return False
        cross_pages = None
        if self.cross_blocks:
            cross_pages = kv.alloc_cross(slot)
            if cross_pages is None:
                if nb:
                    kv.free(slot)        # undo the attn half; retry later
                return False
        try:
            arrays = self.swap_store.fetch(ticket)
        except InjectedFault:
            kv.free(slot)                # undo both kinds; record intact
            raise
        self._free_slots.pop()
        with self.tel.span("swap.restore", slot=slot, pages=nb,
                           reshared=len(shared), pdev=self.pdev):
            self._restore_row(slot, rec, arrays, pages, len(shared),
                              cross_pages)
            kv.swap_in(rec.n_private, cross_blocks=rec.n_cross,
                       state_records=rec.n_state)
        self.swap_store.pop(ticket)
        if self.prefix_sharing and rec.chain_keys:
            # unwritten restored blocks hold their chains' prefill content:
            # register them again so later identical prefixes re-share
            kv.register(slot, rec.chain_keys[:pristine])
        self._slots[slot] = _Slot(
            rec.req, rec.target, rec.temp, rec.top_k, bucket=rec.bucket,
            ring=rec.ring, planned=len(rec.tokens), tokens=list(rec.tokens),
            t_first=rec.t_first, priority=rec.priority,
            preemptions=rec.preemptions, chain_keys=list(rec.chain_keys),
            seed=rec.seed)
        self.restores += 1
        self.tel.count("swap.restores")
        return True

    def _restore_row(self, slot: int, rec: SwapRecord, arrays: Dict[str, Any],
                     pages: np.ndarray, n_shared: int,
                     cross_pages: Optional[np.ndarray]) -> None:
        """The device half of a restore, in place on the current stream:
        the page-table row, the fresh pages' K/V and positions through the
        admission scatter (``pages[n_shared:]`` with the matching blocks of
        the snapshot: distinct non-reserved ids), the cross row through the
        cross scatter, the SSM records and the slot's scalars."""
        st = self.state
        nb = len(pages)
        row_dev = self._write_row(slot, pages, arrays["logits"],
                                  rec.remaining, rec.temp, rec.top_k,
                                  rec.seed, rec.pos, rec.ring, rec.lstep)
        if nb > n_shared:
            fresh = row_dev[n_shared:nb]
            pos_rows = arrays["pos"][n_shared:nb]

            def as_ring(b):
                # the fresh blocks (S, nf, P, Hkv, D) as a dense cache
                # (S, nf * P, Hkv, D); staged blocks may be split on heads
                f = lambda t: t[:, n_shared:nb].reshape(  # noqa: E731
                    t.shape[0], -1, *t.shape[3:])
                return (b.map(f, b.spec[:2] + b.spec[3:])
                        if isinstance(b, ShardedTensor) else f(b))

            for i, name in enumerate(self.kv.attn_subs):
                paged_admit(st["caches"][name],
                            None if i else st["pos_pool"], fresh,
                            {k: as_ring(arrays["kv"][name][k])
                             for k in "kv"},
                            pos_rows.reshape(-1), self.sh)
        if cross_pages is not None:
            cross_dev = to_device(cross_pages, self.device)
            for k in "kv":
                ops.paged_prefill_scatter_sharded(
                    st["caches"]["cross"][k], cross_dev, arrays["cross"][k],
                    self.sh)
            st["cross_pt"][slot].copy_(cross_dev)
        for name in self.ssm_subs:
            restore_slot_state(st["caches"][name], slot,
                               arrays["state"][name])

    def drop_swapped(self, ticket: int) -> SwapRecord:
        """Abandon a swapped-out record (terminal failure past the restore
        retry budget): its blocks leave the ledger without a restore."""
        rec = self.swap_store.pop(ticket)
        self.kv.swap_in(rec.n_private, restored=False,
                        cross_blocks=rec.n_cross, state_records=rec.n_state)
        return rec

    def fail_live(self) -> List[Any]:
        """Terminal failure path (round-fault limit exceeded): vacate every
        live row and return the abandoned requests.  Caller contract: no
        round in flight."""
        failed: List[Any] = []
        for c, s in enumerate(self._slots):
            if s is None:
                continue
            failed.append(s.req)
            self.kv.free(c)
            self._evict(c)
            self._slots[c] = None
            self._free_slots.append(c)
        return failed

    def prefill_ms(self) -> List[float]:
        """CUDA-event time of every prefill call so far (waits for them)."""
        out = []
        for a, b in self._prefill_events:
            b.synchronize()
            out.append(a.elapsed_time(b))
        return out

    def assert_conserved(self) -> None:
        """Audit every state kind the slot rows carry: the attention and
        cross page spaces (:meth:`PagedKVCache.assert_conserved`, and every
        page row and cross row held by an occupied slot), the slot rows
        that hold the SSM state (the free and the occupied rows partition
        the table), and -- with a swap store -- the host tier's per-kind
        ledgers against the store."""
        occupied = {c for c, s in enumerate(self._slots) if s is not None}
        free = set(self._free_slots)
        assert len(free) == len(self._free_slots), "a slot freed twice"
        assert not (free & occupied) and \
            len(free) + len(occupied) == self.capacity, (free, occupied)
        self.kv.assert_conserved(
            None if self.swap_store is None
            else self.swap_store.pages_by_kind())
        if self.kv.attn_subs:
            holding = {c for c in range(self.capacity)
                       if self.kv.owned_pages(c)}
            assert holding == occupied, (sorted(holding), sorted(occupied))
        if self.cross_blocks:
            holding = {c for c in range(self.capacity)
                       if self.kv.cross_pages_of(c)}
            assert holding == occupied, (sorted(holding), sorted(occupied))

    # ------------------------------------------------------------------
    def run_all(self, requests) -> List[Tuple[Any, np.ndarray]]:
        """FIFO-drain a request list without a scheduler: admit as slots and
        pages free up, one micro-round per iteration.  Returns (request,
        tokens) in completion order.  A head request the pool cannot admit
        while nothing is in flight is retried ``admission_retry_limit``
        times (injected admission stalls are transient, a pool too small is
        not), then dropped into ``self.rejected``; a dropped round is simply
        dispatched again."""
        queue: Deque[Any] = collections.deque(requests)
        done: List[Tuple[Any, np.ndarray]] = []
        stall = 0
        while queue or self.active_count():
            progress = False
            while queue and self._free_slots:
                take = [queue.popleft() for _ in
                        range(min(len(queue), len(self._free_slots)))]
                try:
                    flags = self.try_admit_batch(take)
                except InjectedFault:
                    for req in reversed(take):
                        queue.appendleft(req)
                    break
                for req, ok in reversed(list(zip(take, flags))):
                    if not ok:
                        queue.appendleft(req)
                progress = progress or any(flags)
                if not all(flags):
                    break              # pool pressure: decode frees pages
            if queue and not self.active_count() and not progress:
                stall += 1
                if stall > self.admission_retry_limit:
                    self.rejected.append(queue.popleft())
                    stall = 0
                continue
            stall = 0
            try:
                res = self.collect(self.dispatch_round())
            except InjectedFault:
                continue               # dropped round: state untouched
            done.extend((req, toks) for req, toks, _ in res.finished)
        return done
