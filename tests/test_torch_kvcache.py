"""The port's PagedKVCache against the JAX package's, operation for operation.

The host accounting (free list, refcounts, chain-keyed prefix trie,
copy-on-write reserve, conservation audit) is numpy and plain Python in both
packages.  A lockstep machine drives one allocator of each package with the
same seeded (and Hypothesis-drawn) interleavings of shared and unshared
admission, decode writes under the three preserve policies, and retirement
-- the machine of ``tests/test_kvcache.py`` for the attention state kind,
preemption swap cycles and checkpoint adoption included -- and requires
every return value, counter, free list, trie and host-tier ledger to agree
after every operation.  The device constructors and the per-row write/read
primitives are held against the reference too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import null_sharder
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving import kvcache as jkv
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import kvcache as tkv

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # pragma: no cover - CI installs it
    HAVE_HYPOTHESIS = False

ARCH = "internlm2-1.8b"
JCFG = jax_config(ARCH).reduced()
TCFG = get_config(ARCH).reduced()
PAGE = 4


def _prompt_pool():
    """tests/test_kvcache.py::_prompt_pool: 2-4 blocks, shared leading
    blocks, divergence in the last block only."""
    base = np.arange(1, 1 + 4 * PAGE, dtype=np.int32)
    pool = []
    for nblk in (2, 3, 4):
        for variant in range(3):
            p = base[:nblk * PAGE].copy()
            if variant:
                p[-1] = 200 + variant
            pool.append(p)
    return pool


PROMPTS = _prompt_pool()


def _state(kv):
    """Everything the host accounting holds, comparable across packages."""
    return (list(kv._free), {s: list(p) for s, p in kv._owned.items()},
            {p: r for p, r in kv._ref.items()}, dict(kv._prefix),
            dict(kv._page_key), dict(kv._cached),
            {s: set(b) for s, b in kv._pending.items()}, dict(kv._hits),
            set(kv._ever_used), kv.pages_allocated, kv.pages_reused,
            kv.pages_shared, kv.cow_forks, kv.pristine_forks,
            kv.free_pages(), kv.cached_pages(), kv.available(),
            kv.cow_reserve)


class Lockstep:
    """One allocator of each package, driven the way the continuous engine
    drives it, compared after every operation."""

    def __init__(self, num_pages, capacity, max_blocks=4):
        self.t = tkv.PagedKVCache(TCFG, capacity, PAGE, max_blocks, num_pages)
        self.j = jkv.PagedKVCache(JCFG, capacity, PAGE, max_blocks, num_pages)
        self.capacity = capacity
        self.live = {}

    def both(self, method, *args, **kw):
        a = getattr(self.t, method)(*args, **kw)
        b = getattr(self.j, method)(*args, **kw)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert (a is None) == (b is None), (method, a, b)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        else:
            assert a == b, (method, args, a, b)
        return a

    def check(self):
        assert _state(self.t) == _state(self.j)
        self.t.assert_conserved()
        self.j.assert_conserved(host_pages=0)

    def admit(self, slot, prompt, max_new, share):
        if slot in self.live:
            with pytest.raises(ValueError, match="already owns"):
                self.t.alloc_shared(slot, [], 1, ())
            return
        keys = self.both("chain_keys", prompt) if share else []
        nb = prompt.size // PAGE
        ring = prompt.size
        shared = self.both("lookup_chain", keys)[:nb]
        will_write = {((ring + t) % ring) // PAGE
                      for t in range(min(max_new, ring))}
        pages = self.both("alloc_shared", slot, shared, nb - len(shared),
                          will_write)
        if pages is None:
            return
        if share:
            self.both("register", slot, keys)
        self.live[slot] = set(will_write)

    def write(self, slot, mode):
        pending = self.live.get(slot)
        if not pending:
            return
        blk = min(pending)
        pending.discard(blk)
        self.both("note_write", slot, blk, preserve=mode > 0,
                  require_hit=mode == 1)

    def retire(self, slot):
        if slot in self.live:
            self.both("free", slot)
            del self.live[slot]


def _walk(m: Lockstep, ops) -> None:
    for op, slot, *params in ops:
        if op == "admit":
            i, max_new, share = params
            m.admit(slot, PROMPTS[i], max_new, share)
        elif op == "write":
            m.write(slot, params[0])
        else:
            m.retire(slot)
        m.check()
    for slot in sorted(m.live):
        m.retire(slot)
    m.check()
    assert m.t.free_pages() + m.t.cached_pages() == \
        m.t.num_pages - m.t.RESERVED
    assert m.t.cow_reserve == 0


def _ops(draw_int, draw_bool, capacity, n):
    ops = []
    for _ in range(n):
        op = ("admit", "write", "retire")[draw_int(0, 2)]
        slot = draw_int(0, capacity - 1)
        if op == "admit":
            ops.append((op, slot, draw_int(0, len(PROMPTS) - 1),
                        draw_int(1, 3 * PAGE), draw_bool()))
        elif op == "write":
            ops.append((op, slot, draw_int(0, 2)))
        else:
            ops.append((op, slot))
    return ops


def test_lockstep_fuzz_matches_reference():
    rng = np.random.default_rng(7)
    draw_int = lambda lo, hi: int(rng.integers(lo, hi + 1))
    draw_bool = lambda: bool(rng.integers(0, 2))
    for _ in range(150):
        m = Lockstep(tkv.PagedKVCache.RESERVED + draw_int(6, 20),
                     capacity=draw_int(2, 6))
        _walk(m, _ops(draw_int, draw_bool, m.capacity, draw_int(5, 40)))


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_lockstep_property_matches_reference():
    @settings(max_examples=60, deadline=None)
    @given(st.data())
    def run(data):
        draw_int = lambda lo, hi: data.draw(st.integers(lo, hi))
        draw_bool = lambda: data.draw(st.booleans())
        m = Lockstep(tkv.PagedKVCache.RESERVED + draw_int(6, 20),
                     capacity=draw_int(2, 6))
        _walk(m, _ops(draw_int, draw_bool, m.capacity, draw_int(5, 40)))

    run()


def test_unshared_admit_retire_conservation():
    """tests/test_kvcache.py::test_admit_retire_fuzz_conservation on the
    port: free pages plus owned pages stay the usable pool."""
    kv = tkv.PagedKVCache(TCFG, 6, PAGE, 4, tkv.PagedKVCache.RESERVED + 10)
    rng = np.random.default_rng(0)
    live = set()
    usable = kv.num_pages - kv.RESERVED
    for _ in range(500):
        if live and rng.random() < 0.45:
            slot = int(rng.choice(sorted(live)))
            kv.free(slot)
            live.discard(slot)
        else:
            slot, n = int(rng.integers(0, 6)), int(rng.integers(1, 5))
            if slot in live:
                with pytest.raises(ValueError, match="already owns"):
                    kv.alloc(slot, n)
            elif kv.alloc(slot, n) is not None:
                live.add(slot)
        assert kv.free_pages() + sum(
            len(kv.owned_pages(s)) for s in live) == usable
        kv.assert_conserved()


def test_reserve_tracks_sharer_counts():
    """tests/test_kvcache.py::test_reserve_tracks_sharer_counts on the port."""
    kv = tkv.PagedKVCache(TCFG, 3, PAGE, 1, tkv.PagedKVCache.RESERVED + 3)
    keys = kv.chain_keys(PROMPTS[0][:PAGE])
    assert kv.alloc_shared(0, [], 1, {0}) is not None
    kv.register(0, keys)
    assert kv.cow_reserve == 0
    chain = kv.lookup_chain(keys)
    assert kv.alloc_shared(1, chain, 0, {0}) is not None
    assert kv.cow_reserve == 2 and kv.available() == 2
    assert kv.alloc_shared(2, kv.lookup_chain(keys), 0, {0}) is None
    fork = kv.note_write(1, 0)
    assert fork is not None and fork[0] == chain[0]
    assert kv.cow_reserve == 0
    kv.free(0)
    kv.free(1)
    kv.assert_conserved()


@pytest.mark.parametrize("bucket,ring", [(16, None), (16, 8), (24, 8),
                                         (12, 12), (20, 6)])
def test_chain_keys_match_reference(bucket, ring):
    """Chain keys, sliding-window phase tags and salts are byte-identical:
    a trie built by one package would be read correctly by the other."""
    padded = np.random.default_rng(bucket).integers(0, 99, bucket).astype(
        np.int32)
    t = tkv.PagedKVCache(TCFG, 2, PAGE, 8)
    j = jkv.PagedKVCache(JCFG, 2, PAGE, 8)
    for salt in (b"", b"frames"):
        assert t.chain_keys(padded, ring=ring, salt=salt) == \
            j.chain_keys(padded, ring=ring, salt=salt)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b"])
def test_device_constructors_match_reference(arch):
    tc, jc = get_config(arch).reduced(), jax_config(arch).reduced()
    t = tkv.PagedKVCache(tc, 3, PAGE, 5)
    j = jkv.PagedKVCache(jc, 3, PAGE, 5)
    assert (t.num_pages, t.attn_subs) == (j.num_pages, j.attn_subs)
    assert [k.name for k in tkv.state_kinds(tc)] == ["attn"]
    np.testing.assert_array_equal(t.make_page_table().numpy(),
                                  np.asarray(j.make_page_table()))
    np.testing.assert_array_equal(t.make_pos_pool().numpy(),
                                  np.asarray(j.make_pos_pool()))
    tp, jp = t.make_pools(2), j.make_pools(2)
    assert set(tp) == set(jp)
    for name in tp:
        for kind in ("k", "v"):
            assert tuple(tp[name][kind].shape) == jp[name][kind].shape
            assert tp[name][kind].dtype == torch.bfloat16
            assert jp[name][kind].dtype == jnp.bfloat16


def test_paged_layer_decode_matches_reference():
    """One attention sublayer's paged decode (projections, rope at each
    row's position, the K/V write into the pool, the read through the page
    table) against the reference's ``backend="jnp"``: same output, same
    pool afterwards.  Inactive rows write into TRASH."""
    rng = np.random.default_rng(21)
    vals, _ = jparams.split(jax_build(JCFG).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, vals)
    attn_j = jax.tree.map(lambda a: a[0], vals["stages"]["sub0"]["attn"])
    attn_t = {k: v[0] for k, v in params_from_jax(
        TCFG, tree)["stages"]["sub0"]["attn"].items()}
    C, NB, Hkv, D = 3, 3, TCFG.num_kv_heads, TCFG.head_dim
    NP_ = tkv.PagedKVCache.RESERVED + C * NB
    k_np = rng.standard_normal((NP_, PAGE, Hkv, D)).astype(np.float32)
    v_np = rng.standard_normal((NP_, PAGE, Hkv, D)).astype(np.float32)
    table = np.arange(tkv.PagedKVCache.RESERVED, NP_, dtype=np.int32
                      ).reshape(C, NB)
    positions = np.asarray([5, 9, 11], np.int32)
    pos_pool = np.full((NP_, PAGE), tkv.POS_SENTINEL, np.int32)
    for c in range(C):
        for p in range(positions[c] + 1):
            pos_pool[table[c, p // PAGE], p % PAGE] = p
    active = np.asarray([True, False, True])
    off = positions % PAGE
    page = np.where(active, table[np.arange(C), positions // PAGE],
                    tkv.PagedKVCache.TRASH).astype(np.int32)
    x = rng.standard_normal((C, 1, TCFG.d_model)).astype(np.float32)

    pool_t = {k: torch.from_numpy(a).to(torch.bfloat16)
              for k, a in (("k", k_np), ("v", v_np))}
    out_t, pool_t = tkv.paged_attention_decode(
        attn_t, torch.from_numpy(x), pool_t, torch.from_numpy(table),
        torch.from_numpy(page), torch.from_numpy(off.astype(np.int32)),
        torch.from_numpy(positions), TCFG, torch.from_numpy(pos_pool))
    pool_j = {k: jnp.asarray(a, jnp.bfloat16)
              for k, a in (("k", k_np), ("v", v_np))}
    kpos = jnp.asarray(pos_pool)[jnp.asarray(table)].reshape(C, -1)
    out_j, pool_j = jkv.paged_attention_decode(
        attn_j, jnp.asarray(x), pool_j, jnp.asarray(table), kpos,
        jnp.asarray(page), jnp.asarray(off.astype(np.int32)),
        jnp.asarray(positions), JCFG, null_sharder(), backend="jnp")
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    for kind in ("k", "v"):
        np.testing.assert_array_equal(
            pool_t[kind].float().numpy(),
            np.asarray(pool_j[kind].astype(jnp.float32)))


class SwapLockstep(Lockstep):
    """The lockstep machine with the host tier: a swap-out moves a live
    slot's private blocks to a host record (``swap_out``), a swap-back
    returns or drops the oldest record (``swap_in``), and an adoption seeds
    the ledger as a checkpointed live slot does (``adopt_swapped``); the
    per-kind ledgers and both audits agree after every operation."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.host = []

    def check(self):
        assert _state(self.t) == _state(self.j)
        for kv in (self.t, self.j):
            assert kv.swapped_by_kind() == {"attn": sum(self.host),
                                            "cross": 0, "ssm": 0}
            assert (kv.swap_outs, kv.swap_ins, kv.swap_drops) == (
                self.j.swap_outs, self.j.swap_ins, self.j.swap_drops)
        self.t.assert_conserved(host_pages=sum(self.host))
        self.t.assert_conserved(host_pages={"attn": sum(self.host)})
        self.j.assert_conserved(host_pages={"attn": sum(self.host)})

    def swap_out(self, slot):
        if slot not in self.live:
            return
        n = len(self.both("private_blocks", slot))
        self.both("trie_keys")
        self.both("swap_out", slot, n)
        del self.live[slot]
        self.host.append(n)

    def swap_back(self, restored):
        if self.host:
            self.both("swap_in", self.host.pop(0), restored=restored)

    def adopt(self, slot):
        """An engine checkpoint's live slot re-parked: the record's private
        blocks credited to a fresh ledger before its restore debits them."""
        if slot not in self.live:
            return
        n = len(self.both("private_blocks", slot))
        self.both("free", slot)
        del self.live[slot]
        self.both("adopt_swapped", n)
        self.host.append(n)


def test_lockstep_swap_cycles_match_reference():
    """tests/test_kvcache.py's swap cycles on the port: swap-outs of live
    slots (shared pages stay with their other readers), swap-ins restored
    and dropped, adoptions -- the two-tier ledger, its counters and the
    audits in both forms agree with the reference after every step."""
    rng = np.random.default_rng(11)
    draw_int = lambda lo, hi: int(rng.integers(lo, hi + 1))
    draw_bool = lambda: bool(rng.integers(0, 2))
    swaps = 0
    for _ in range(120):
        m = SwapLockstep(tkv.PagedKVCache.RESERVED + draw_int(6, 20),
                         capacity=draw_int(2, 6))
        for op, slot, *params in _ops(draw_int, draw_bool, m.capacity,
                                      draw_int(5, 40)):
            if op == "retire" and draw_bool():
                op = ("swap", "swapback", "adopt")[draw_int(0, 2)]
            if op == "admit":
                i, max_new, share = params
                m.admit(slot, PROMPTS[i], max_new, share)
            elif op == "write":
                m.write(slot, params[0])
            elif op == "retire":
                m.retire(slot)
            elif op == "swap":
                m.swap_out(slot)
                swaps += 1
            elif op == "adopt":
                m.adopt(slot)
            else:
                m.swap_back(restored=draw_bool())
            m.check()
        while m.host:
            m.swap_back(restored=False)
            m.check()
        for slot in sorted(m.live):
            m.retire(slot)
        m.check()
        assert m.t.swapped_pages == 0
    assert swaps > 50
