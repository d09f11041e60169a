"""Paged KV-cache for continuous batching (vLLM-style).

The JAX package's ``repro/serving/kvcache.py`` for the attention, cross-
attention and SSM state kinds.
The pool is broken into fixed-size *pages* so a persistent slot table (see
:mod:`repro_torch.serving.continuous`) can admit and retire requests
independently:

* **fixed-size pages** -- the K/V pool per attention sublayer is
  ``(n_stages, num_pages, page_size, Hkv, D)`` bfloat16; a shared position
  pool ``(num_pages, page_size)`` int32 carries the absolute token position
  of every cache entry (the validity source of the attention mask).
* **per-sequence page tables** -- ``(capacity, max_blocks)`` int32 mapping a
  slot's logical cache blocks to physical pages.  Unused blocks point at the
  reserved ``SENTINEL`` page whose positions stay at ``POS_SENTINEL``.
* **host-side accounting** (:class:`PagedKVCache`), numpy and plain Python,
  ported line for line: LIFO free list, per-page refcounts, the chain-keyed
  prefix trie with reuse-aware pristine preservation, the copy-on-write
  reserve and the conservation audit ``assert_conserved``.  It never touches
  device tensors: the engine applies the device half of every fork/remap it
  decides (:meth:`PagedKVCache.note_write`).
* **device primitives** -- :func:`paged_write` (one entry per row, in
  place), :func:`paged_attend`, :func:`paged_admit` and
  :func:`paged_admit_cross`, which go through
  :mod:`repro_torch.kernels.ops`: a CUDA tensor to the hand-written kernels
  of :mod:`repro_torch.kernels.paged_attention`, a CPU tensor to their plain
  versions.  The reference's ``backend="jnp"`` dense gather is that plain
  version; there is no switch that sends a CUDA tensor to it.

Masked (inactive) rows redirect their writes to the reserved ``TRASH`` page,
which no active row's page table ever references.

On a device mesh (a :func:`repro_torch.distributed.sharding.serving_sharder`)
the K/V pools -- self- and cross-attention -- are split on KV heads: each
pool is a :class:`repro_torch.distributed.sharding.ShardedTensor` whose
shards are ``(n_stages, num_pages, page_size, Hkv/M, D)`` blocks, each
contiguous on its device, and the primitives run a shard at a time (the
sharded kernel wrappers, one launch a shard), the decode's ``(C, H/M, D)``
outputs gathered along heads before ``wo``.  Page tables, the position
pool, the free list, the trie and refcounts stay host-global (and the
position pool and page table global on the mesh's first device), so the
accounting above is the same on any mesh.

State kinds: ``attn`` (the page space above), ``cross`` and ``ssm``; a
hybrid arch (jamba) carries attn and ssm, the encoder-decoder arch
(whisper) attn and cross.  The cross space holds each request's whole
encoder output's cross-attention K/V, ``cross_blocks`` pages a row in its
own pools ``(n_stages, num_cross_pages, page_size, Hkv, D)`` in the compute
dtype: written once at admission, read-only after, private to the request,
so it needs no refcounts, trie or copy-on-write, only its own free list
(:meth:`PagedKVCache.alloc_cross`).  SSM slot state is not paged: it lives
dense in the engine's slot table, one row per slot.  An arch without attention
sublayers (mamba2) therefore has no page space at all -- ``blocks_for`` gives 0, nothing is allocated, shared or registered,
and the conservation audit holds trivially.

Preemption (see :mod:`repro_torch.serving.swap`) adds a *host tier* on top
without disturbing the device invariant: a swap-out frees the victim's
device pages through the ordinary accounting and records its private
blocks, cross pages and SSM records in per-kind ledgers (``swapped_pages``,
``swapped_cross``, ``swapped_state``), which ``assert_conserved(host_pages=
...)`` audits against the swap store -- an int the attention ledger, a
``{"attn", "cross", "ssm"}`` dict every kind.

Exactness contract (as the reference's): the paged read/write replicates the
dense ring cache of :func:`repro_torch.models.layers.apply_attention_decode`
slot for slot -- token ``pos`` lands in logical slot ``pos % ring``, validity
``kpos <= pos`` (plus the sliding window), the same bf16 storage casts and
mask constants -- so greedy decode through the paged path is token-exact
with ``ServingEngine.generate`` on the same padded prompt.
"""
from __future__ import annotations

from typing import (Dict, Iterable, List, NamedTuple, Optional, Set, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.configs import ATTN, ArchConfig
from repro_torch.distributed.sharding import Sharder, ShardedTensor
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import POS_SENTINEL
from repro_torch.models.layers import _project_qkv, apply_rope, dtype_of
from repro_torch.obs.telemetry import get_telemetry

# POS_SENTINEL (2 ** 30) matches init_kv_cache's "empty slot" position


def attn_subs(cfg: ArchConfig) -> List[str]:
    """Names of the attention sublayers in one stage (``sub{i}``)."""
    sched = cfg.block_schedule()[:cfg.stage_period]
    return [f"sub{i}" for i, (mixer, _) in enumerate(sched) if mixer == ATTN]


def ssm_subs(cfg: ArchConfig) -> List[str]:
    """Names of the SSM sublayers in one stage (``sub{i}``)."""
    sched = cfg.block_schedule()[:cfg.stage_period]
    return [f"sub{i}" for i, (mixer, _) in enumerate(sched) if mixer != ATTN]


class StateKind(NamedTuple):
    """One kind of per-request serving state the pool accounts for:
    ``paged`` -- it lives in a device page space (attention pages in the
    refcounted space, cross-attention pages in their own); ``swappable`` --
    it has a host snapshot, so a row carrying it may be preempted."""
    name: str
    paged: bool
    swappable: bool


def state_kinds(cfg: ArchConfig) -> Tuple[StateKind, ...]:
    """The state kinds an arch's slot rows carry, in the reference's order:
    attention pages, cross-attention pages (an encoder-decoder arch), SSM
    slot state.  Every kind swaps (pages as page blocks, SSM state as
    fixed-width records)."""
    kinds: List[StateKind] = []
    if attn_subs(cfg):
        kinds.append(StateKind("attn", paged=True, swappable=True))
    if cfg.enc_dec:
        kinds.append(StateKind("cross", paged=True, swappable=True))
    if ssm_subs(cfg):
        kinds.append(StateKind("ssm", paged=False, swappable=True))
    return tuple(kinds)


class PagedKVCache:
    """Page pool geometry + host free list / refcounts / trie.

    Device state (pools / position pool / page tables) is *built* here but
    owned by the engine's state dict.  This class keeps the host-side truth:
    which pages are free, cached or live, each page's refcount, the prefix
    trie, the copy-on-write reserve, and the allocation/sharing/reuse
    counters.  It never touches device tensors.
    """

    SENTINEL = 0           # page-table padding: never written, never valid
    TRASH = 1              # masked rows' write target: never read as valid
    RESERVED = 2

    def __init__(self, cfg: ArchConfig, capacity: int, page_size: int,
                 max_blocks: int, num_pages: Optional[int] = None,
                 cross_blocks: int = 0):
        self.cfg = cfg
        self.capacity = capacity
        self.page_size = page_size
        self.max_blocks = max(max_blocks, 1)
        self.attn_subs = attn_subs(cfg)
        self.state_kinds = state_kinds(cfg)
        # cross-attention page space: per-request, written once at
        # admission, read-only thereafter -- no refcounts, trie or CoW,
        # just its own free list.  Sized to hold every slot's row plus the
        # two reserved pages (SENTINEL for vacated page-table rows).
        self.cross_blocks = int(cross_blocks)
        self.num_cross_pages = (self.RESERVED + capacity * self.cross_blocks
                                if self.cross_blocks else 0)
        self._cross_free: List[int] = list(
            range(self.num_cross_pages - 1, self.RESERVED - 1, -1))
        self._cross_owned: Dict[int, List[int]] = {}
        self.cross_pages_allocated = 0
        self.cross_pages_freed = 0
        if not self.attn_subs:
            num_pages = self.RESERVED      # no page space: nothing is paged
        elif num_pages is None:
            num_pages = self.RESERVED + capacity * self.max_blocks
        if self.attn_subs and num_pages < self.RESERVED + self.max_blocks:
            raise ValueError("num_pages cannot hold even one full sequence")
        self.num_pages = num_pages
        # LIFO free list: freshly freed pages are reallocated first
        self._free: List[int] = list(range(num_pages - 1, self.RESERVED - 1,
                                           -1))
        self._owned: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}          # page -> live slot references
        self._prefix: Dict[bytes, int] = {}     # block chain key -> page
        self._page_key: Dict[int, bytes] = {}   # inverse of _prefix
        # refcount-0 but trie-registered pages: page -> (chain depth, age)
        self._cached: Dict[int, Tuple[int, int]] = {}
        self._cache_seq = 0
        # slot -> block indices not yet first-written (each may need a fork)
        self._pending: Dict[int, Set[int]] = {}
        # page -> sharing hits recorded while trie-registered (cleared on
        # unregister): the evidence the reuse-aware preserve policy needs
        self._hits: Dict[int, int] = {}
        self._ever_used: set = set()
        self.pages_allocated = 0
        self.pages_reused = 0
        self.pages_shared = 0
        self.cow_forks = 0
        self.pristine_forks = 0
        # host tier (preemption swap): blocks whose only copy lives in the
        # host swap store right now, per state kind -- attention page
        # blocks, cross pages, SSM records (one per SSM sublayer a victim)
        self.swapped_pages = 0
        self.swapped_cross = 0
        self.swapped_state = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_drops = 0
        # telemetry plane: every host counter above is mirrored as a
        # ``kv.*`` metric.  The owning engine re-points this at its own
        # plane; standalone pools report to the global one.
        self.tel = get_telemetry(None)
    # ------------------------------------------------------------------
    # host-side allocator
    # ------------------------------------------------------------------
    def blocks_for(self, ring_len: int) -> int:
        """Pages a ring of ``ring_len`` positions takes (0 without
        attention sublayers: nothing is paged)."""
        if not self.attn_subs:
            return 0
        return -(-ring_len // self.page_size)        # ceil div

    def free_pages(self) -> int:
        return len(self._free)

    def cached_pages(self) -> int:
        return len(self._cached)

    def available(self) -> int:
        """Pages an allocation can draw on: free plus evictable cached."""
        return len(self._free) + len(self._cached)

    def ref(self, page: int) -> int:
        """Live slot references to ``page``."""
        return self._ref.get(page, 0)

    def hits(self, page: int) -> int:
        """Sharing hits recorded against ``page`` while trie-registered."""
        return self._hits.get(page, 0)

    @property
    def cow_reserve(self) -> int:
        """Headroom the allocator must keep for *mandatory* copy-on-write
        forks: pending first-writes whose page is multi-referenced right
        now.  Derived from actual sharer counts (a pending write into an
        exclusively owned page costs nothing -- if it is registered, the
        write merely unregisters or optionally preserves it, and
        preservation moves a page from free to cached without shrinking
        ``available()``)."""
        need = 0
        for slot, blks in self._pending.items():
            pages = self._owned.get(slot, ())
            for b in blks:
                if self._ref.get(pages[b], 0) > 1:
                    need += 1
        return need

    def chain_keys(self, padded: np.ndarray, ring: Optional[int] = None,
                   salt: bytes = b"") -> List[bytes]:
        """Chain key per page block of a padded prompt: the bytes of the
        whole prompt up to and including the block's last cached position,
        so two requests share a block only when every earlier token (padding
        included) agrees -- exactly the condition under which the block's KV
        is bitwise equal.

        ``ring`` (sliding-window archs) keys by *(content chain, window
        phase)*: prefill clips the cache to the last ``ring`` positions, so
        ring block ``b`` holds absolute positions ``base + b*P`` onward
        (``base = bucket - ring``) and its key is the prompt bytes through
        the block's last cached position plus a ``(ring, base, block)`` tag
        -- requests with a different bucket or window hold different
        positions in the "same" ring block and must never collide.  When
        the ring covers the whole bucket (``ring is None`` or ``ring >=
        bucket``) keys are byte-identical to the historical untagged form.

        ``salt`` prefixes every key (non-token prefill inputs -- encoder
        frames, vision patch embeds -- change the KV a block holds, so they
        must be part of block identity)."""
        t = np.ascontiguousarray(np.asarray(padded, np.int32).reshape(-1))
        p = self.page_size
        bucket = t.size
        if ring is None or ring >= bucket:
            return [salt + t[:(b + 1) * p].tobytes()
                    for b in range(bucket // p)]
        base = bucket - ring
        return [salt + t[:min(base + (b + 1) * p, bucket)].tobytes()
                + b"|w%d:%d:%d" % (ring, base, b)
                for b in range(-(-ring // p))]

    def lookup_chain(self, keys: Iterable[bytes]) -> List[int]:
        """Pages of the longest registered full-block prefix of ``keys``."""
        pages: List[int] = []
        for key in keys:
            page = self._prefix.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def alloc(self, slot: int, n_blocks: int) -> Optional[np.ndarray]:
        """Take ``n_blocks`` fresh pages for ``slot``; None if the pool is
        short (the caller leaves the request queued and retries after
        eviction)."""
        return self.alloc_shared(slot, [], n_blocks, ())

    def alloc_shared(self, slot: int, shared: List[int], n_fresh: int,
                     will_write: Iterable[int]) -> Optional[np.ndarray]:
        """Build ``slot``'s page row: ``shared`` (a prefix of existing pages,
        refcounts incremented) followed by ``n_fresh`` fresh pages.

        ``will_write`` are the block indices the request will write during
        its decode; ``cow_reserve`` headroom is charged only for those that
        land on *shared* pages (refcount > 1 once this admission joins) --
        the mandatory forks -- plus any pending writes of other slots whose
        page this admission newly makes shared.  Writes into exclusively
        owned pages are free (a coarse one-page-per-block charge would
        reject admissions the pool could in fact hold).  Returns None
        (nothing changed) when the pool cannot cover ``n_fresh`` plus the
        post-admission reserve -- the request stays queued.
        """
        if slot in self._owned:
            # silently overwriting would leak the old pages off both the
            # free list and the owned map; the engine retires a slot before
            # reusing it, so this is always a caller bug
            raise ValueError(
                f"slot {slot} already owns pages; free() it before "
                f"re-allocating")
        will_write = set(will_write)
        # reviving a cached shared page takes it out of the evictable set,
        # so it costs availability exactly like a fresh page does
        revived = sum(self._ref.get(p, 0) == 0 for p in shared)
        # post-admission reserve: every pending write (existing slots' and
        # this one's) whose page will be multi-referenced after the shared
        # refcounts are bumped needs a guaranteed fork page
        shared_set = set(shared)
        reserve = 0
        for s2, blks in self._pending.items():
            pages2 = self._owned.get(s2, ())
            for b in blks:
                p = pages2[b]
                if self._ref.get(p, 0) + (p in shared_set) > 1:
                    reserve += 1
        for b in will_write:
            if b < len(shared) and self._ref.get(shared[b], 0) + 1 > 1:
                reserve += 1
        if self.available() - n_fresh - revived < reserve:
            self.tel.count("kv.alloc_blocked")
            return None
        for p in shared:
            if self._ref.get(p, 0) == 0:        # revive a cached page
                self._cached.pop(p, None)
            self._ref[p] = self._ref.get(p, 0) + 1
            self._hits[p] = self._hits.get(p, 0) + 1
        fresh = [self._take_page() for _ in range(n_fresh)]
        for p in fresh:
            self._ref[p] = 1
        self._owned[slot] = list(shared) + fresh
        self._pending[slot] = will_write
        self.pages_allocated += n_fresh
        self.pages_shared += len(shared)
        tel = self.tel
        if tel.enabled:
            tel.count("kv.pages_allocated", n_fresh)
            if shared:
                tel.count("kv.pages_shared", len(shared))
                tel.count("kv.prefix_hits")
            tel.gauge("kv.free_pages", len(self._free))
            # zero-length span so the pool's activity lands on the trace
            # timeline (parents under the enclosing admission span)
            tel.event("kv.alloc", slot=slot, fresh=n_fresh,
                      shared=len(shared))
        return np.asarray(self._owned[slot], np.int32)

    def alloc_cross(self, slot: int) -> Optional[np.ndarray]:
        """Take ``slot``'s row of ``cross_blocks`` pages from the cross page
        space; None when the space is short (the request stays queued).
        Cross pages are private and written once, so there is nothing to
        share and no reserve to keep."""
        if slot in self._cross_owned:
            raise ValueError(
                f"slot {slot} already owns cross pages; free() it before "
                f"re-allocating")
        if len(self._cross_free) < self.cross_blocks:
            self.tel.count("kv.alloc_blocked")
            return None
        pages = [self._cross_free.pop() for _ in range(self.cross_blocks)]
        self._cross_owned[slot] = pages
        self.cross_pages_allocated += len(pages)
        if self.tel.enabled:
            self.tel.count("kv.cross.pages_allocated", len(pages))
        return np.asarray(pages, np.int32)

    def cross_pages_of(self, slot: int) -> List[int]:
        """The slot's cross page row (block order), read-only."""
        return list(self._cross_owned.get(slot, ()))

    def _free_cross(self, slot: int) -> int:
        pages = self._cross_owned.pop(slot, None)
        if not pages:
            return 0
        self._cross_free.extend(pages)
        self.cross_pages_freed += len(pages)
        if self.tel.enabled:
            self.tel.count("kv.cross.pages_freed", len(pages))
        return len(pages)

    def register(self, slot: int, keys: List[bytes]) -> None:
        """Enter ``slot``'s pages into the prefix trie under their chain
        keys.  First registration wins (duplicate-content pages from one
        admission batch stay private); already-shared prefix pages are
        naturally skipped because their key is present."""
        pages = self._owned.get(slot, [])
        for blk, key in enumerate(keys):
            if blk >= len(pages):
                break
            page = pages[blk]
            if key in self._prefix or page in self._page_key:
                continue
            self._prefix[key] = page
            self._page_key[page] = key

    def note_write(self, slot: int, blk: int, preserve: bool = True,
                   require_hit: bool = True) -> Optional[Tuple[int, int]]:
        """Resolve ``slot``'s upcoming decode write into block ``blk``.

        Returns ``(src, dst)`` when the engine must copy page ``src`` to the
        freshly mapped page ``dst`` (device-side) before the round runs:

        * refcount > 1 -- mandatory copy-on-write fork (other requests, or
          the trie's cached readers, still read ``src``);
        * sole owner of a trie-registered page with ``preserve``, a free
          page at hand, and -- under the default reuse-aware policy
          (``require_hit``) -- at least one sharing hit recorded against the
          page: pristine-preserving fork, ``src`` stays in the trie as a
          cached page so later identical prefixes can re-share it.  Without
          a recorded hit there is no evidence the chain is ever re-used, so
          the copy is skipped (the share-nothing fast path);
          ``require_hit=False`` preserves on every such write.

        Otherwise returns None; a sole-owner write into a registered page
        that is not preserved simply unregisters it (its content is about
        to diverge from its chain key).  Idempotent per block: after the
        first resolution the slot owns the page exclusively and
        unregistered, so later ring wraps fall through.
        """
        pages = self._owned.get(slot)
        if pages is None:
            return None
        page = pages[blk]
        pending = self._pending.get(slot)
        if pending is not None:
            pending.discard(blk)
        if self._ref.get(page, 0) > 1:
            dst = self._take_page()
            self._ref[page] -= 1
            self._ref[dst] = 1
            pages[blk] = dst
            self.cow_forks += 1
            self.pages_allocated += 1
            self.tel.count("kv.cow_forks")
            return page, dst
        if page in self._page_key:
            if (preserve and self._free
                    and (not require_hit or self._hits.get(page, 0) > 0)):
                # moves a page free -> live and a page live -> cached, so
                # available() (free + cached) is unchanged: preservation
                # can never eat into the mandatory-fork reserve
                dst = self._free.pop()
                self.pages_reused += dst in self._ever_used
                self._ever_used.add(dst)
                self._ref[dst] = 1
                pages[blk] = dst
                self._ref[page] = 0
                self._cached[page] = (blk, self._cache_seq)
                self._cache_seq += 1
                self.pristine_forks += 1
                self.pages_allocated += 1
                self.tel.count("kv.pristine_forks")
                return page, dst
            self._unregister(page)
        return None

    def owned_pages(self, slot: int) -> List[int]:
        """The slot's current page row (block order), read-only."""
        return list(self._owned.get(slot, ()))

    def private_blocks(self, slot: int) -> List[int]:
        """Block indices whose page content exists nowhere but this slot's
        row: refcount 1 and not trie-registered -- a preemption victim's
        private suffix, the only blocks a swap-out moves to the host tier
        (shared pages keep serving their other readers, registered pristine
        pages linger as cache)."""
        return [b for b, p in enumerate(self._owned.get(slot, ()))
                if self._ref.get(p, 0) == 1 and p not in self._page_key]

    def trie_keys(self) -> List[bytes]:
        """Every chain key registered in the prefix trie, sorted (recorded
        in engine checkpoints for audit)."""
        return sorted(self._prefix)

    def swapped_by_kind(self) -> Dict[str, int]:
        """Host-tier ledger per state kind."""
        return {"attn": self.swapped_pages, "cross": self.swapped_cross,
                "ssm": self.swapped_state}

    def swap_out(self, slot: int, host_blocks: int, cross_blocks: int = 0,
                 state_records: int = 0) -> int:
        """Preemption swap-out: retire a victim slot's page references --
        exactly :meth:`free`, cross row included -- and account its snapshot
        against the per-kind host ledger.  The engine snapshots content
        before calling this; the allocator only moves the ledger.  Returns
        the attention pages whose refcount dropped to 0."""
        released = self.free(slot)
        self.swapped_pages += host_blocks
        self.swapped_cross += cross_blocks
        self.swapped_state += state_records
        self.swap_outs += 1
        self.tel.count("kv.swap_out_blocks", host_blocks)
        if cross_blocks:
            self.tel.count("kv.cross.swap_out_blocks", cross_blocks)
        if state_records:
            self.tel.count("kv.ssm.swap_out_records", state_records)
        self.tel.gauge("kv.swapped_pages", self.swapped_pages)
        return released

    def adopt_swapped(self, host_blocks: int, cross_blocks: int = 0,
                      state_records: int = 0) -> None:
        """Crash recovery: seed a fresh pool's host ledger for a
        checkpointed swap record re-parked in the store without ever having
        been swapped out of this pool."""
        self.swapped_pages += host_blocks
        self.swapped_cross += cross_blocks
        self.swapped_state += state_records
        self.tel.gauge("kv.swapped_pages", self.swapped_pages)

    def swap_in(self, host_blocks: int, restored: bool = True,
                cross_blocks: int = 0, state_records: int = 0) -> None:
        """Account a record's blocks leaving the host tier: restored into
        fresh pages and slot rows (``restored``), or dropped with a
        terminally failed record."""
        assert self.swapped_pages >= host_blocks, \
            (self.swapped_pages, host_blocks)
        assert self.swapped_cross >= cross_blocks, \
            (self.swapped_cross, cross_blocks)
        assert self.swapped_state >= state_records, \
            (self.swapped_state, state_records)
        self.swapped_pages -= host_blocks
        self.swapped_cross -= cross_blocks
        self.swapped_state -= state_records
        if restored:
            self.swap_ins += 1
            self.tel.count("kv.swap_in_blocks", host_blocks)
        else:
            self.swap_drops += 1
            self.tel.count("kv.swap_drop_blocks", host_blocks)
        self.tel.gauge("kv.swapped_pages", self.swapped_pages)

    def free(self, slot: int) -> int:
        """Retire a slot: decrement its pages' refcounts and return its
        cross row (if any) to the cross free list.  Attention pages
        reaching refcount 0 return to the free list -- or stay behind as
        cached (evictable) pristine pages when still trie-registered, so a
        later identical prefix can re-share them.  Returns the number of
        attention pages whose refcount dropped to 0."""
        self._free_cross(slot)
        released = 0
        for blk, page in enumerate(self._owned.pop(slot, [])):
            self._ref[page] -= 1
            if self._ref[page] == 0:
                released += 1
                if page in self._page_key:
                    self._cached[page] = (blk, self._cache_seq)
                    self._cache_seq += 1
                else:
                    self._free.append(page)
        self._pending.pop(slot, None)
        if self.tel.enabled and released:
            self.tel.count("kv.pages_freed", released)
            self.tel.gauge("kv.free_pages", len(self._free))
        return released

    # ------------------------------------------------------------------
    def _unregister(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            self._prefix.pop(key, None)
        self._cached.pop(page, None)
        self._hits.pop(page, None)

    def _take_page(self) -> int:
        """Pop a free page; when the free list is dry, evict a cached
        pristine page -- leaf-most chain entry first (deepest block, then
        oldest), so short shared prefixes survive longest."""
        if self._free:
            page = self._free.pop()
        else:
            page = max(self._cached,
                       key=lambda q: (self._cached[q][0],
                                      -self._cached[q][1]))
            self._unregister(page)
            self.tel.count("kv.evictions")
        self.pages_reused += page in self._ever_used
        self._ever_used.add(page)
        return page

    # ------------------------------------------------------------------
    def assert_conserved(
            self, host_pages: Optional[Union[int, Dict[str, int]]] = None
    ) -> None:
        """Audit the allocator: page conservation, refcount integrity, trie
        consistency, fork-reserve headroom and -- when a cross page space
        exists -- cross-row conservation.  With ``host_pages`` (the swap
        store's count) the audit covers the host tier too: an int checks
        the attention ledger (``swapped_pages == host_pages``), a dict
        (``store.pages_by_kind()``) every kind's ledger."""
        usable = self.num_pages - self.RESERVED
        live = {p for p, r in self._ref.items() if r > 0}
        free_set = set(self._free)
        cached_set = set(self._cached)
        assert len(self._free) == len(free_set), "free list has duplicates"
        assert not (free_set & live), "free page still referenced"
        assert not (free_set & cached_set), "page both free and cached"
        assert not (cached_set & live), "cached page still referenced"
        assert all(p in self._page_key for p in cached_set), \
            "cached page not trie-registered"
        assert len(free_set) + len(cached_set) + len(live) == usable, \
            (len(free_set), len(cached_set), len(live), usable)
        counts: Dict[int, int] = {}
        for pages in self._owned.values():
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        for p in live | set(counts):
            assert self._ref.get(p, 0) == counts.get(p, 0), \
                (p, self._ref.get(p, 0), counts.get(p, 0))
        for key, p in self._prefix.items():
            assert self._page_key.get(p) == key, "trie inverse out of sync"
        for p in self._hits:
            assert p in self._page_key, "hit count on an unregistered page"
        for slot, blks in self._pending.items():
            assert slot in self._owned, "pending writes on a retired slot"
            assert all(b < len(self._owned[slot]) for b in blks)
        # the refcount-derived reserve (mandatory forks outstanding) must
        # always be coverable, so a copy-on-write fork can never fail
        assert self.available() >= self.cow_reserve, \
            (self.available(), self.cow_reserve)
        if self.cross_blocks:
            cross_live = [p for pages in self._cross_owned.values()
                          for p in pages]
            cross_free = set(self._cross_free)
            assert len(cross_free) == len(self._cross_free), \
                "cross free list has duplicates"
            assert len(set(cross_live)) == len(cross_live), \
                "cross page owned twice"
            assert not (cross_free & set(cross_live)), \
                "cross page both free and owned"
            assert len(cross_free) + len(cross_live) == \
                self.num_cross_pages - self.RESERVED, \
                (len(cross_free), len(cross_live), self.num_cross_pages)
        ledger = self.swapped_by_kind()
        assert all(v >= 0 for v in ledger.values()), ledger
        if host_pages is not None:
            if isinstance(host_pages, dict):
                want = {k: 0 for k in ledger}
                want.update(host_pages)
                assert ledger == want, (ledger, want)
            else:
                assert self.swapped_pages == host_pages, \
                    (self.swapped_pages, host_pages)

    # ------------------------------------------------------------------
    # device-state constructors (the engine holds the results in its state)
    # ------------------------------------------------------------------
    def make_page_table(self, device=None) -> torch.Tensor:
        return torch.full((self.capacity, self.max_blocks), self.SENTINEL,
                          dtype=torch.int32, device=device)

    def make_pos_pool(self, device=None) -> torch.Tensor:
        return torch.full((self.num_pages, self.page_size), POS_SENTINEL,
                          dtype=torch.int32, device=device)

    def make_pools(self, n_stages: int, device=None,
                   sh: Optional[Sharder] = None
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each attention sublayer's K and V pools ``(n_stages, NP, P, Hkv,
        D)`` bfloat16; on ``sh``'s mesh split on KV heads, each shard's
        block allocated contiguous on its device (:class:`ShardedTensor`)."""
        cfg = self.cfg
        shape = (n_stages, self.num_pages, self.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        return {name: {k: _zeros(shape, torch.bfloat16, device, sh)
                       for k in "kv"}
                for name in self.attn_subs}

    def make_cross_page_table(self, device=None) -> torch.Tensor:
        return torch.full((self.capacity, self.cross_blocks), self.SENTINEL,
                          dtype=torch.int32, device=device)

    def make_cross_pools(self, n_stages: int, device=None,
                         sh: Optional[Sharder] = None
                         ) -> Dict[str, torch.Tensor]:
        """Cross-attention page pools, in the *compute* dtype: ``generate``
        decodes straight from the prefill's cross K/V (compute dtype), so
        storing anything else here would break bitwise parity with it.  On
        ``sh``'s mesh split on KV heads, as the self-attention pools."""
        cfg = self.cfg
        shape = (n_stages, self.num_cross_pages, self.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        dt = dtype_of(cfg.compute_dtype)
        return {k: _zeros(shape, dt, device, sh) for k in "kv"}


POOL_AXES = (None, None, None, "kv", None)     # (stages, NP, P, Hkv, D)


def _zeros(shape, dtype, device, sh: Optional[Sharder]):
    if sh is not None and sh.mesh is not None:
        return sh.zeros(shape, POOL_AXES, dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# device primitives (used inside the decode step and admission); a pool may
# be a ShardedTensor split on its KV-head axis, the rest global tensors on
# the mesh's first device
# ---------------------------------------------------------------------------
def paged_write(pool, pages: torch.Tensor, offsets: torch.Tensor,
                values: torch.Tensor):
    """Scatter one entry per row, in place: ``pool[pages[c], offsets[c]] =
    values[c]`` (values ``(C, Hkv, D)``; a sharded pool takes its heads in
    each shard).  Masked rows all target the TRASH page; their collisions
    are benign because TRASH is never read as valid."""
    if not isinstance(pool, ShardedTensor):
        pool[pages.long(), offsets.long()] = values
        return pool
    for _, local, sl in pool.unique():
        dev = local.device
        local[pages.to(dev).long(), offsets.to(dev).long()] = \
            values[:, sl[2]].to(dev)
    return pool


def copy_page(pool, src: int, dst: int) -> None:
    """Page ``src`` of every stage copied onto page ``dst``, in place (in
    every shard of a sharded pool)."""
    for local in ([t for _, t, _ in pool.unique()]
                  if isinstance(pool, ShardedTensor) else [pool]):
        local[:, dst].copy_(local[:, src])


def gather_pages(pool, idx: torch.Tensor) -> torch.Tensor:
    """Pages ``idx`` of every stage as global blocks ``(S, len(idx), P,
    Hkv, D)`` on the mesh's first device (a sharded pool's heads gathered:
    data movement)."""
    if not isinstance(pool, ShardedTensor):
        return pool.index_select(1, idx)
    return pool.map(lambda t: t.index_select(1, idx.to(t.device))).full()


def paged_attend(q: torch.Tensor, pool: Dict[str, torch.Tensor],
                 page_table: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig, pos_pool: torch.Tensor,
                 sh: Optional[Sharder] = None,
                 row_mask: Optional[torch.Tensor] = None):
    """Paged attention read: q (C, H, D) already-roped queries; pool
    {"k","v"} (NP, P, Hkv, D); page_table (C, NB); positions (C,);
    row_mask (C,) bool or None: rows it masks are not read and give zeros.
    Returns (C, H, D) float32 -- the decode kernel on a CUDA device, its
    plain version (the reference's dense-gather oracle) on the CPU; for
    pools split on ``sh``'s mesh one call a shard, the result sharded like
    q (:class:`ShardedTensor`)."""
    return ops.paged_attention_decode_sharded(
        q, pool["k"], pool["v"], pos_pool, page_table, positions, sh,
        window=cfg.sliding_window, row_mask=row_mask)


def paged_admit(pool: Dict[str, torch.Tensor],
                pos_pool: Optional[torch.Tensor], pages: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos_src: torch.Tensor,
                sh: Optional[Sharder] = None) -> None:
    """Admission-time write of one attention sublayer, in place: the dense
    prefill cache ``cache`` {"k","v"} (S, ring, Hkv, D) into ``pool``'s
    pages ``pages`` (nb,), cast to bfloat16 and zero past the ring, and
    (unless ``pos_pool`` is None) the positions ``pos_src`` (ring,) into
    ``pos_pool``'s rows of those pages, ``POS_SENTINEL`` past the ring --
    one launch of the scatter kernel on a CUDA device (one a shard of a
    split pool, each its heads), ``index_copy_`` and index-puts on the CPU;
    bit-exact with each other."""
    ops.paged_admit_kv_sharded(pool["k"], pool["v"], pos_pool, pages,
                               cache["k"], cache["v"], pos_src, sh)


def paged_admit_cross(pools: Dict[str, torch.Tensor], pages: torch.Tensor,
                      cross: Dict[str, torch.Tensor],
                      sh: Optional[Sharder] = None) -> None:
    """Admission's write-once cross scatter, in place: one request's cross
    K/V ``cross`` {"k","v"} (S, S_enc, Hkv, D) zero-padded to its
    ``nbc = len(pages)`` whole pages and written into ``pools``' pages
    ``pages`` -- one launch of the scatter kernel per pool (and shard) on a
    CUDA device, ``index_copy_`` on the CPU (bit-exact with each other).
    The pools are in the compute dtype, as the K/V are: the pages hold the
    prefill's cross K/V bit for bit, and the zeros past ``S_enc`` are
    dropped by :func:`gather_cross`."""
    for kind in ("k", "v"):
        pool, leaf = pools[kind], cross[kind]
        S, s_enc = leaf.shape[:2]
        nbc, psz = pages.shape[0], pool.shape[2]
        vals = torch.nn.functional.pad(
            leaf, (0, 0, 0, 0, 0, nbc * psz - s_enc))
        ops.paged_prefill_scatter_sharded(
            pool, pages, vals.reshape(S, nbc, psz, *leaf.shape[2:]), sh)


def gather_cross(pool, cross_pt: torch.Tensor, s_enc: int) -> torch.Tensor:
    """The slot rows' cross K (or V) as a dense view ``(C, s_enc, Hkv,
    D)``: pool ``(NPc, P, Hkv, D)`` gathered through the cross page table
    ``(C, nbc)`` and cut to ``s_enc`` (bitwise the prefill's cross K/V of
    each row's request; a split pool's heads gathered onto the mesh's first
    device)."""
    def gather(t: torch.Tensor) -> torch.Tensor:
        C, nbc = cross_pt.shape
        g = t[cross_pt.to(t.device).long()]           # (C, nbc, P, Hkv, D)
        return g.reshape(C, nbc * t.shape[1], *t.shape[2:])[:, :s_enc]

    if not isinstance(pool, ShardedTensor):
        return gather(pool)
    return pool.map(gather).full()


def paged_attention_decode(p, x, pool: Dict[str, torch.Tensor],
                           page_table: torch.Tensor, write_page: torch.Tensor,
                           write_off: torch.Tensor, positions: torch.Tensor,
                           cfg: ArchConfig, pos_pool: torch.Tensor,
                           sh: Optional[Sharder] = None,
                           row_mask: Optional[torch.Tensor] = None):
    """Single-token GQA decode against a paged cache (per-row positions).

    Mirrors :func:`repro_torch.models.layers.apply_attention_decode`
    operation for operation (same projections, rope at the row's absolute
    position, bf16 cache casts, validity ``kpos <= pos`` with optional
    sliding window) -- only the cache storage is paged: the new token's K/V
    is written at ``(write_page, write_off)`` per row *before* the read, and
    ``pos_pool`` already holds this step's positions.  With pools split on
    ``sh``'s mesh the read runs a shard at a time and its ``(C, H/M, D)``
    outputs are gathered along heads before ``wo`` (data movement, never a
    sum).  Rows ``row_mask`` masks skip the read: their attention output is
    zero (the caller throws their step away).

    x: (C, 1, d); positions: (C,) absolute position of the new token.
    Returns (out (C, 1, d), pool) with the pool updated in place."""
    H, D = cfg.num_heads, cfg.head_dim
    C = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, positions[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, positions[:, None], cfg.rope_theta)
    paged_write(pool["k"], write_page, write_off,
                k_new[:, 0].to(pool["k"].dtype))
    paged_write(pool["v"], write_page, write_off,
                v_new[:, 0].to(pool["v"].dtype))
    o = paged_attend(q[:, 0], pool, page_table, positions, cfg, pos_pool, sh,
                     row_mask)
    if isinstance(o, ShardedTensor):
        o = sh.constrain(o, (None, None, None))
    o = o.reshape(C, 1, H * D).to(x.dtype)
    out = torch.matmul(o, p["wo"].to(dtype_of(cfg.compute_dtype)))
    return out, pool
