"""The serving state-kind API against the JAX package's.

* ``state_kinds(cfg)``: the same ``StateKind(name, paged, swappable)``
  tuples as the reference's for every arch in ``configs/`` (full and
  reduced), and ``ServingEngine.state_kinds()`` equal to the reference
  engine's on reduced internlm2, mamba2 and whisper-base;
* ``supported_modes``' names and ``preemptable`` derived from those kinds;
* ``PagedKVCache.ref`` / ``hits``: the walks of the reference's
  tests/test_kvcache.py that assert on them (sharer counts and the
  copy-on-write reserve, the reuse-aware pristine preserve, the shared
  admission and fork lifecycle), run on both pools in lockstep, every
  page's ``ref`` and ``hits`` equal after every operation beside the
  reference test's own assertions.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving import kvcache as jkv
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine

PAGE = 4


def test_arch_ids_match():
    assert list(ARCH_IDS) == list(JAX_ARCH_IDS)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_kinds_match_reference(arch, reduced):
    cfg, jcfg = get_config(arch), jax_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got, want = tkv.state_kinds(cfg), jkv.state_kinds(jcfg)
    assert got == want
    assert all(isinstance(k, tkv.StateKind) for k in got)
    assert [k._asdict() for k in got] == [k._asdict() for k in want]
    modes = ContinuousBatchingEngine.supported_modes(cfg)["continuous"]
    jmodes = JaxCont.supported_modes(jcfg)["continuous"]
    assert modes["state_kinds"] == jmodes["state_kinds"] == \
        [k.name for k in want]
    assert modes["preemptable"] == jmodes["preemptable"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b",
                                  "whisper-base"])
def test_engine_state_kinds_match_reference(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, vals))
    eng = ServingEngine(cfg, tp, device="cpu")
    jeng = JaxEngine(jcfg, vals)
    assert eng.state_kinds() == jeng.state_kinds()
    for swap in (False, True):
        ceng = ContinuousBatchingEngine(eng, capacity=2, page_size=8,
                                        max_prompt_len=16, swap=swap)
        assert ceng.state_kinds == eng.state_kinds()
        assert ceng.can_preempt == (swap and all(
            k.swappable for k in ceng.state_kinds))


# ---------------------------------------------------------------------------
# ref / hits, in lockstep with the reference's pool
# ---------------------------------------------------------------------------
class Lockstep:
    """The same operations on the port's pool and the reference's; after
    each, every page's ``ref`` and ``hits`` (and the counters) agree."""

    def __init__(self, num_pages, capacity=4, max_blocks=4):
        arch = "internlm2-1.8b"
        self.t = tkv.PagedKVCache(get_config(arch).reduced(), capacity, PAGE,
                                  max_blocks, num_pages)
        self.j = jkv.PagedKVCache(jax_config(arch).reduced(), capacity, PAGE,
                                  max_blocks, num_pages)

    def __getattr__(self, name):
        def call(*args, **kw):
            got = getattr(self.t, name)(*args, **kw)
            want = getattr(self.j, name)(*args, **kw)
            if isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want))
            else:
                assert got == want, (name, got, want)
            self.hold()
            return got
        return call

    def hold(self):
        for p in range(self.t.num_pages):
            assert self.t.ref(p) == self.j.ref(p), p
            assert self.t.hits(p) == self.j.hits(p), p
        assert self.t.cow_reserve == self.j.cow_reserve
        assert (self.t.pages_shared, self.t.cow_forks,
                self.t.pristine_forks) == (self.j.pages_shared,
                                           self.j.cow_forks,
                                           self.j.pristine_forks)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, n).astype(np.int32)


def test_ref_tracks_sharer_counts():
    kv = Lockstep(num_pages=tkv.PagedKVCache.RESERVED + 3, capacity=3,
                  max_blocks=1)
    keys = kv.chain_keys(_prompt(PAGE))
    assert kv.alloc_shared(0, [], 1, {0}) is not None
    kv.register(0, keys)
    chain = kv.lookup_chain(keys)
    assert kv.alloc_shared(1, chain, 0, {0}) is not None
    assert kv.t.cow_reserve == 2
    assert kv.alloc_shared(2, kv.lookup_chain(keys), 0, {0}) is None
    assert kv.t.ref(chain[0]) == 2
    fork = kv.note_write(1, 0)
    assert fork is not None and fork[0] == chain[0]
    kv.free(0)
    kv.free(1)
    kv.t.assert_conserved()


def test_hits_drive_the_pristine_preserve():
    kv = Lockstep(num_pages=tkv.PagedKVCache.RESERVED + 6, capacity=3)
    keys = kv.chain_keys(_prompt(2 * PAGE))
    kv.alloc_shared(0, [], 2, {0})
    kv.register(0, keys)
    assert kv.t.hits(kv.lookup_chain(keys)[0]) == 0
    assert kv.note_write(0, 0) is None
    kv.free(0)
    kv.alloc_shared(0, [], 2, {0})
    kv.register(0, keys)
    chain = kv.lookup_chain(keys)
    kv.alloc_shared(1, chain, 0, set())
    assert kv.t.hits(chain[0]) == 1
    kv.free(1)                               # a hit outlives the sharer
    assert kv.t.hits(chain[0]) == 1
    fork = kv.note_write(0, 0)
    assert fork is not None and kv.t.pristine_forks == 1
    kv.free(0)
    kv.t.assert_conserved()


def test_ref_through_the_fork_lifecycle():
    kv = Lockstep(num_pages=tkv.PagedKVCache.RESERVED + 8, capacity=4)
    keys = kv.chain_keys(_prompt(2 * PAGE, seed=1))
    pages0 = kv.alloc_shared(0, [], 2, {0})
    kv.register(0, keys)
    pages1 = kv.alloc_shared(1, kv.lookup_chain(keys), 0, {0})
    assert list(pages1) == list(pages0)
    assert kv.t.ref(pages0[0]) == 2
    fork = kv.note_write(1, 0)
    assert kv.t.ref(pages0[0]) == 1 and kv.t.ref(fork[1]) == 1
    kv.note_write(0, 0)
    assert kv.t.ref(pages0[0]) == 0 and kv.t.cached_pages() == 1
    kv.free(0)
    kv.free(1)
    revived = kv.alloc_shared(2, kv.lookup_chain(keys), 0, set())
    assert list(revived) == list(pages0)
    assert kv.t.ref(pages0[0]) == 1
    kv.free(2)
    assert kv.t.ref(pages0[0]) == 0 and kv.t.hits(pages0[0]) == 2
    kv.t.assert_conserved()
