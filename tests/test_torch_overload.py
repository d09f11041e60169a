"""The port's overload survival against the JAX package's: priority
admission, swap preemption for every state kind, faults and shedding.

Both packages serve reduced configs from the same weights (the reference's
initialiser, converted by ``params_from_jax``) on the CPU, in float32:

* **token-exact preemption** -- a request swapped out to the host tier and
  restored later decodes the reference's ``generate`` tokens (greedy) or
  those of the same request run uninterrupted in the port (seeded
  sampling): pure attention, a victim holding shared prefix pages, sliding
  window, pure SSM, hybrid and encoder-decoder rows; the restored pages
  hold the snapshot bit for bit;
* **every request terminates** -- a 2x oversubscribed burst, shedding past
  ``max_backlog`` or a deadline, dropped rounds, stalled admissions and
  poisoned swap reads all end in exactly one outcome per request, with
  the two tiers conserved at every drain;
* **scheduler parity** -- one trace with two tiers, ``max_backlog`` and a
  ``FaultPlane`` through the reference's scheduler and the port's gives the
  same outcomes, victims, preemption and restore counts and tokens;
* the per-kind swap counters of a mamba2 and a whisper cycle equal
  ``tests/golden/obs_serving_counters.json``.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.fault import FaultPlane as JaxFaultPlane
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build
from repro.serving import continuous as jcont
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import MultiTenantScheduler as JaxSched
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.distributed.fault import FaultPlane
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.obs.telemetry import Telemetry
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request
from repro_torch.serving.swap import SwapRecord

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "obs_serving_counters.json")
KW = dict(capacity=2, page_size=8, num_pages=24, inner_steps=4,
          max_prompt_len=16)


def _engines(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, vals)
    return (ServingEngine(cfg, params_from_jax(cfg, tree), device="cpu"),
            JaxEngine(jcfg, vals))


@pytest.fixture(scope="module")
def engines():
    return _engines("internlm2-1.8b")


@pytest.fixture(scope="module")
def pceng(engines):
    # capacity 2 with ample pages: the slot table is the contended
    # resource, so a tier-0 arrival meets a full table
    return ContinuousBatchingEngine(engines[0], **KW)


def _oracle(jeng, ceng, req):
    """The reference's ``generate`` on the request's padded prompt."""
    b = ceng.bucket_len(req.prompt.size)
    padded = np.zeros((1, b), np.int32)
    padded[0, b - req.prompt.size:] = req.prompt
    return np.asarray(jeng.generate(padded, max_new_tokens=req.max_new_tokens,
                                    seed=req.seed).tokens[0])


def _sched(engine, ceng, **kw):
    kw.setdefault("preemption", True)
    return MultiTenantScheduler(engine, mode="continuous",
                                continuous_engine=ceng, **kw)


def _clone(req):
    return Request(req.tenant, req.prompt.copy(), req.max_new_tokens,
                   temperature=req.temperature, top_k=req.top_k,
                   seed=req.seed, priority=req.priority,
                   extra_inputs=req.extra_inputs)


def _preempt_mix(engine, ceng, reqs_lo, req_hi, **sched_kw):
    """Fill every slot with long tier-1 rows, dispatch a round, then land a
    tier-0 arrival against the full table.  Holds that a preemption and a
    restore happened and both tiers are conserved at drain; returns the
    scheduler and the responses by tenant."""
    sched = _sched(engine, ceng, **sched_kw)
    pre0, res0 = ceng.preemptions, ceng.restores
    for r in reqs_lo:
        sched.submit(r)
    sched.step()
    sched.submit(req_hi)
    out = sched.drain()
    assert ceng.preemptions > pre0
    assert ceng.restores > res0
    assert len(ceng.swap_store) == 0
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages())
    ceng.assert_conserved()
    assert len(out) == len(reqs_lo) + 1
    return sched, {r.tenant: r for r in out}


def _lo_hi(rng, vocab, tag, lo_len=12, lo_new=40, hi_new=4, **lo_kw):
    los = [Request(f"{tag}lo{i}", rng.integers(1, vocab, lo_len).astype(
        np.int32), max_new_tokens=lo_new, priority=1, **lo_kw)
           for i in range(2)]
    hi = Request(f"{tag}hi", rng.integers(1, vocab, 8).astype(np.int32),
                 max_new_tokens=hi_new, priority=0)
    return los, hi


# ---------------------------------------------------------------------------
# token-exact preemption
# ---------------------------------------------------------------------------
def test_preempt_restore_token_exact_greedy(engines, pceng, rng):
    """The victim's restored decode gives the reference's ``generate``
    tokens, as if it had never been preempted; the round keys are not
    traced again by a swap."""
    eng, jeng = engines
    los, hi = _lo_hi(rng, eng.cfg.vocab_size, "g")
    sched, by_tenant = _preempt_mix(eng, pceng, los, hi)
    for req in [*los, hi]:
        resp = by_tenant[req.tenant]
        assert resp.outcome == "completed"
        assert resp.ttft_s is not None and resp.ttft_s >= 0.0
        np.testing.assert_array_equal(_oracle(jeng, pceng, req), resp.tokens)
    assert sum(r.preemptions for r in by_tenant.values()) >= 1
    assert sum(s["preempted"] for s in sched.stats.values()) >= 1
    assert pceng.decode_traces == 1            # all greedy: one key


def test_preempt_restore_token_exact_seeded_sampling(engines, pceng, rng):
    """Seeded temperature sampling across a swap cycle: sampling is a
    function of (seed, lstep) and both are restored, so the continuation
    equals an uninterrupted run of the same request on the same engine."""
    eng, _ = engines
    V = eng.cfg.vocab_size
    los = [Request(f"slo{i}", rng.integers(1, V, 12).astype(np.int32),
                   max_new_tokens=36, priority=1, temperature=1.1, top_k=20,
                   seed=5 + i) for i in range(2)]
    hi = Request("shi", rng.integers(1, V, 8).astype(np.int32),
                 max_new_tokens=4, priority=0, temperature=0.9, seed=11)
    want = {r.tenant: t for c in [*los, hi]
            for r, t in pceng.run_all([_clone(c)])}
    _, by_tenant = _preempt_mix(eng, pceng, los, hi)
    for req in [*los, hi]:
        resp = by_tenant[req.tenant]
        assert resp.outcome == "completed"
        np.testing.assert_array_equal(want[req.tenant], resp.tokens)


def test_preempt_victim_with_shared_prefix_token_exact(engines, pceng, rng):
    """A victim whose prompt blocks are shared with a live neighbour: only
    its private suffix goes to the host tier, and victim and survivor both
    keep the reference's tokens."""
    eng, jeng = engines
    V = eng.cfg.vocab_size
    sys_prompt = rng.integers(1, V, 8).astype(np.int32)

    def mk(t):
        return Request(t, np.concatenate(
            [sys_prompt, rng.integers(1, V, 4).astype(np.int32)]),
            max_new_tokens=40, priority=1)

    los = [mk("cow0"), mk("cow1")]
    hi = Request("cowhi", rng.integers(1, V, 8).astype(np.int32),
                 max_new_tokens=4, priority=0)
    shared0 = pceng.kv.pages_shared
    _, by_tenant = _preempt_mix(eng, pceng, los, hi)
    assert pceng.kv.pages_shared > shared0
    for req in [*los, hi]:
        resp = by_tenant[req.tenant]
        assert resp.outcome == "completed"
        np.testing.assert_array_equal(_oracle(jeng, pceng, req), resp.tokens)


def test_sliding_window_preempt_restore_token_exact(rng):
    """Sliding window: the decode ring wraps inside the window, so the
    snapshot carries ring-wrapped blocks and positions exactly."""
    eng, jeng = _engines("h2o-danube-1.8b")
    ceng = ContinuousBatchingEngine(eng, **KW)
    assert ceng.can_preempt
    los, hi = _lo_hi(rng, eng.cfg.vocab_size, "w", lo_new=28, hi_new=3)
    _, by_tenant = _preempt_mix(eng, ceng, los, hi)
    for req in [*los, hi]:
        resp = by_tenant[req.tenant]
        assert resp.outcome == "completed"
        np.testing.assert_array_equal(_oracle(jeng, ceng, req), resp.tokens)


@pytest.fixture(scope="module")
def mamba():
    return _engines("mamba2-2.7b")


def test_ssm_preempt_restore_token_exact(mamba, rng):
    """Pure SSM: the slot's SSM state goes out as fixed-width records and
    comes back in place, so the victim keeps the reference's tokens."""
    eng, jeng = mamba
    ceng = ContinuousBatchingEngine(eng, capacity=2, page_size=8,
                                    inner_steps=3, max_prompt_len=16)
    assert ceng.can_preempt
    assert [k.name for k in ceng.state_kinds] == ["ssm"]
    los, hi = _lo_hi(rng, eng.cfg.vocab_size, "m", lo_len=9, lo_new=12,
                     hi_new=3)
    sched, by_tenant = _preempt_mix(eng, ceng, los, hi)
    assert sum(s["preempted"] for s in sched.stats.values()) >= 1
    for req in [*los, hi]:
        resp = by_tenant[req.tenant]
        assert resp.outcome == "completed"
        np.testing.assert_array_equal(_oracle(jeng, ceng, req), resp.tokens)
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_smoke_ssm_hybrid_preempt_restore(arch, rng):
    """tests/test_archs_smoke.py::test_smoke_ssm_hybrid_preempt_restore:
    SSM and hybrid rows are ordinary victims; every request completes to
    full length, and the non-MoE mamba2 keeps the tokens of the same
    requests run uninterrupted (jamba's MoE routing couples rows)."""
    cfg = get_config(arch).reduced()
    eng = ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")
    ceng = ContinuousBatchingEngine(eng, capacity=2, page_size=8,
                                    inner_steps=3, max_prompt_len=16)
    assert ceng.can_preempt
    assert "ssm" in [k.name for k in ceng.state_kinds]
    los, hi = _lo_hi(rng, cfg.vocab_size, "h", lo_len=9, lo_new=12,
                     hi_new=3)
    want = {r.tenant: t for c in [*los, hi]
            for r, t in ceng.run_all([_clone(c)])}
    sched = _sched(eng, ceng)
    for r in los:
        sched.submit(r)
    sched.step()
    sched.submit(hi)
    out = {r.tenant: r for r in sched.drain()}
    assert ceng.preemptions > 0 and ceng.restores > 0
    assert len(ceng.swap_store) == 0
    for req in [*los, hi]:
        resp = out[req.tenant]
        assert resp.outcome == "completed"
        assert resp.tokens.size == req.max_new_tokens
        if arch == "mamba2-2.7b":
            np.testing.assert_array_equal(want[req.tenant], resp.tokens)
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())
    ceng.assert_conserved()


def test_whisper_cross_row_preempt_restore(rng):
    """An encoder-decoder victim: its whole cross row (and its self pages)
    goes to the host tier and comes back into freshly allocated cross pages
    with ``cross_pt`` repointed; its tokens equal the uninterrupted run's
    and ``generate``'s, per request frames included."""
    cfg = get_config("whisper-base").reduced()
    eng = ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")
    ceng = ContinuousBatchingEngine(eng, capacity=2, page_size=8,
                                    inner_steps=3, max_prompt_len=16)
    assert [k.name for k in ceng.state_kinds] == ["attn", "cross"] \
        and ceng.can_preempt

    def frames():
        return {"frames": rng.normal(size=(cfg.encoder_seq_len,
                                           cfg.d_model)).astype(np.float32)}

    los = [Request(f"xlo{i}", rng.integers(1, cfg.vocab_size, 9).astype(
        np.int32), max_new_tokens=14, priority=1, extra_inputs=frames())
        for i in range(2)]
    hi = Request("xhi", rng.integers(1, cfg.vocab_size, 6).astype(np.int32),
                 max_new_tokens=3, priority=0, extra_inputs=frames())
    want = {r.tenant: t for c in [*los, hi]
            for r, t in ceng.run_all([_clone(c)])}
    cross0 = ceng.kv.cross_pages_allocated
    _, by_tenant = _preempt_mix(eng, ceng, los, hi)
    assert ceng.kv.cross_pages_allocated - cross0 >= 4 * ceng.cross_blocks
    for req in [*los, hi]:
        np.testing.assert_array_equal(want[req.tenant],
                                      by_tenant[req.tenant].tokens)
        b = ceng.bucket_len(req.prompt.size)
        padded = np.zeros((1, b), np.int32)
        padded[0, b - req.prompt.size:] = req.prompt
        gen = eng.generate(padded, req.max_new_tokens, extra_inputs={
            k: v[None] for k, v in req.extra_inputs.items()})
        np.testing.assert_array_equal(gen.tokens[0],
                                      by_tenant[req.tenant].tokens)
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())


def test_restored_pages_hold_the_snapshot_bit_for_bit(engines, rng):
    """Swap out, clobber the freed pages with new admissions, swap back:
    the fresh pages the restore wrote, their positions and the slot's
    scalars equal the snapshot's bits; shared pages were not written."""
    eng, _ = engines
    ceng = ContinuousBatchingEngine(eng, **dict(KW, capacity=3))
    V = eng.cfg.vocab_size
    reqs = [Request(f"b{i}", rng.integers(1, V, 12).astype(np.int32),
                    max_new_tokens=20) for i in range(2)]
    assert all(ceng.try_admit_batch(reqs))
    ceng.collect(ceng.dispatch_round())
    ticket = ceng.preempt(0)
    rec = ceng.swap_store.record(ticket)
    assert 0 < rec.n_private <= len(rec.host_pos) == len(rec.chain_keys)
    ceng.try_admit_batch([Request("c", rng.integers(1, V, 15).astype(
        np.int32), max_new_tokens=4)])
    ceng.collect(ceng.dispatch_round())
    assert ceng.try_restore(ticket)
    slot = next(c for c, s in enumerate(ceng._slots)
                if s is not None and s.req is reqs[0])
    pages = ceng.kv.owned_pages(slot)
    st = ceng.state
    idx = torch.as_tensor(pages)
    for name, kv in rec.host_kv.items():
        for k in "kv":
            got = st["caches"][name][k].index_select(1, idx)
            assert torch.equal(got.view(torch.int16),
                               kv[k].view(torch.int16)), (name, k)
    assert torch.equal(st["pos_pool"].index_select(0, idx), rec.host_pos)
    assert torch.equal(st["logits"][slot], rec.logits)
    assert (int(st["pos"][slot]), int(st["remaining"][slot]),
            int(st["lstep"][slot]), int(st["seeds"][slot])) == \
        (rec.pos, rec.remaining, rec.lstep, rec.seed)
    ceng.assert_conserved()


def test_ssm_slot_checkpoint_matches_reference(rng):
    """``checkpoint_slot_state`` / ``restore_slot_state`` on the reference's
    numbers: the record equals the reference's, a restore into a clobbered
    row writes in place and gives back the same bits, other rows
    untouched."""
    state = {"conv": rng.normal(size=(3, 4, 5, 7)).astype(np.float32),
             "ssm": {"h": rng.normal(size=(3, 4, 2, 8)).astype(np.float32)}}
    jrec = jssm.checkpoint_slot_state(jax.tree.map(jnp.asarray, state), 2)
    tstate = {"conv": torch.from_numpy(state["conv"].copy()),
              "ssm": {"h": torch.from_numpy(state["ssm"]["h"].copy())}}
    rec = tssm.checkpoint_slot_state(tstate, 2)
    np.testing.assert_array_equal(rec["conv"].numpy(), jrec["conv"])
    np.testing.assert_array_equal(rec["ssm"]["h"].numpy(), jrec["ssm"]["h"])
    ptr = tstate["conv"].data_ptr()
    tstate["conv"][:, 2] = 0.0
    tstate["ssm"]["h"][:, 2] = 0.0
    assert tssm.restore_slot_state(tstate, 2, rec) is tstate
    assert tstate["conv"].data_ptr() == ptr
    np.testing.assert_array_equal(tstate["conv"].numpy(), state["conv"])
    np.testing.assert_array_equal(tstate["ssm"]["h"].numpy(),
                                  state["ssm"]["h"])


# ---------------------------------------------------------------------------
# every request terminates
# ---------------------------------------------------------------------------
def test_burst_2x_oversubscribed_terminates(engines, pceng, rng):
    """A burst demanding twice the page pool (and 12x the slot table)
    drains without an exception, every request completed, both tiers
    balanced."""
    eng, _ = engines
    reqs = [Request(f"b{i}", rng.integers(1, eng.cfg.vocab_size,
                                          12).astype(np.int32),
                    max_new_tokens=10, priority=0 if i % 4 == 3 else 1)
            for i in range(24)]
    demand = sum(pceng.kv.blocks_for(pceng._ring_len(
        pceng.bucket_len(r.prompt.size))) for r in reqs)
    assert demand >= 2 * pceng.kv.num_pages
    sched = _sched(eng, pceng)
    for r in reqs:
        sched.submit(r)
    out = sched.drain()
    assert len(out) == len(reqs)
    assert all(r.outcome == "completed" for r in out)
    assert sum(r.tokens.size for r in out) == \
        sum(r.max_new_tokens for r in reqs)
    pceng.kv.assert_conserved(host_pages=pceng.swap_store.pages())


def test_load_shed_past_max_backlog(engines, pceng, rng):
    """Backlog past the bound sheds the lowest-priority queued work with an
    explicit ``rejected`` outcome, never tier 0; counted in ``shed``."""
    eng, _ = engines
    reqs = [Request(f"s{i}", rng.integers(1, eng.cfg.vocab_size,
                                          8).astype(np.int32),
                    max_new_tokens=4, priority=0 if i == 2 else 1)
            for i in range(6)]
    sched = _sched(eng, pceng, max_backlog=2)
    for r in reqs:
        sched.submit(r)
    out = sched.drain()
    assert len(out) == 6
    assert sum(s["shed"] for s in sched.stats.values()) == 4
    by_tenant = {r.tenant: r for r in out}
    assert by_tenant["s2"].outcome == "completed"
    assert sum(r.outcome == "rejected" for r in out) == 4
    for resp in out:
        if resp.outcome == "rejected":
            assert resp.tokens.size == 0 and resp.priority == 1


def test_fault_injection_survives_to_completion(engines, pceng, rng):
    """Dropped rounds and stalled admissions below the limits are retried:
    every request keeps the reference's tokens and the survived-fault count
    equals the injector's ledger."""
    eng, jeng = engines
    plane = FaultPlane(drop_round_every=4, stall_admission_every=3)
    pceng.fault_plane = plane
    try:
        sched = _sched(eng, pceng)
        reqs = [Request(f"f{i}", rng.integers(1, eng.cfg.vocab_size,
                                              10).astype(np.int32),
                        max_new_tokens=9, priority=i % 2)
                for i in range(4)]
        for r in reqs:
            sched.submit(r)
        out = sched.drain()
    finally:
        pceng.fault_plane = None
    assert len(out) == 4 and all(r.outcome == "completed" for r in out)
    assert plane.total_injected() > 0
    assert sched.faults_survived == plane.total_injected()
    by_tenant = {r.tenant: r for r in out}
    for req in reqs:
        np.testing.assert_array_equal(_oracle(jeng, pceng, req),
                                      by_tenant[req.tenant].tokens)
    pceng.kv.assert_conserved(host_pages=pceng.swap_store.pages())


def test_poisoned_swap_read_fails_terminally(engines, pceng, rng):
    """A record whose every read is poisoned exhausts the retry budget and
    fails that request only: ``failed``, host record dropped, the others
    complete, ledgers balanced."""
    eng, _ = engines
    plane = FaultPlane(poison_swap_every=1)
    pceng.swap_store.fault_plane = plane
    drops0 = pceng.kv.swap_drops
    try:
        los, hi = _lo_hi(rng, eng.cfg.vocab_size, "p", lo_new=28)
        sched = _sched(eng, pceng)
        for r in los:
            sched.submit(r)
        sched.step()
        sched.submit(hi)
        out = sched.drain()
    finally:
        pceng.swap_store.fault_plane = None
    assert sorted(r.outcome for r in out) == \
        ["completed", "completed", "failed"]
    failed, = [r for r in out if r.outcome == "failed"]
    assert failed.tokens.size == 0 and failed.preemptions >= 1
    assert pceng.kv.swap_drops > drops0
    assert len(pceng.swap_store) == 0 and sched.faults_survived > 0
    assert pceng.swap_store.poisoned_reads > 0
    pceng.kv.assert_conserved(host_pages=pceng.swap_store.pages())


def test_heartbeat_suspects_counted(engines, pceng, rng):
    eng, _ = engines
    sched = _sched(eng, pceng, heartbeat_timeout_s=0.0)
    sched.submit(Request("h", rng.integers(1, eng.cfg.vocab_size,
                                           8).astype(np.int32),
                         max_new_tokens=4))
    out = sched.drain()
    assert [r.outcome for r in out] == ["completed"]
    assert sched.heartbeat_suspects > 0
    assert sched.heartbeat.missed == sched.heartbeat_suspects


def test_deadline_miss_shed_at_pick(engines, pceng, rng):
    """A queued request past its absolute deadline is shed at pick time;
    fresh work behind it keeps the reference's tokens."""
    eng, jeng = engines
    sched = _sched(eng, pceng)
    late = Request("late", rng.integers(1, eng.cfg.vocab_size,
                                        8).astype(np.int32),
                   max_new_tokens=4, deadline_s=time.perf_counter() - 1.0)
    ok = Request("ok", rng.integers(1, eng.cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=4)
    sched.submit(late)
    sched.submit(ok)
    by_tenant = {r.tenant: r for r in sched.drain()}
    assert by_tenant["late"].outcome == "rejected"
    assert by_tenant["late"].tokens.size == 0
    assert sched.stats["late"]["shed"] == 1
    assert by_tenant["ok"].outcome == "completed"
    np.testing.assert_array_equal(_oracle(jeng, pceng, ok),
                                  by_tenant["ok"].tokens)


def test_live_priorities_accessor(engines, pceng, rng):
    eng, _ = engines
    assert pceng.live_priorities() == []
    sched = _sched(eng, pceng)
    for t, p in (("a", 1), ("b", 0)):
        sched.submit(Request(t, rng.integers(1, eng.cfg.vocab_size,
                                             8).astype(np.int32),
                             max_new_tokens=12, priority=p))
    sched.step()
    assert sorted(pceng.live_priorities()) == [0, 1]
    assert {r.outcome for r in sched.drain()} == {"completed"}
    assert pceng.live_priorities() == []


def test_restore_prefetch_window(pceng):
    """``_drain_restores`` stages a window of ``restore_prefetch`` tickets,
    not just the head."""
    store = pceng.swap_store

    def fake_record():
        return SwapRecord(
            req=None, priority=1, target=0, temp=0.0, top_k=0, bucket=8,
            ring=0, tokens=[], chain_keys=[], written=set(), pos=0,
            remaining=0, lstep=0, seed=0, logits=torch.zeros(4),
            host_kv={"sub": {"k": torch.zeros((1, 1, 1, 1, 1)),
                             "v": torch.zeros((1, 1, 1, 1, 1))}},
            host_pos=torch.zeros((1, 1), dtype=torch.int32), n_private=0)

    tickets = [store.put(fake_record()) for _ in range(3)]
    try:
        sched = _sched(pceng.engine, pceng, restore_prefetch=2)
        sched._restore_q = list(tickets)
        sched._ticket_backoff = {t: 10 ** 9 for t in tickets}
        assert sched._drain_restores(False) == 0
        assert sorted(sched._restore_q) == tickets
        assert len(store._staged) == 2
    finally:
        for t in tickets:
            store.pop(t)
    assert len(store) == 0
    pceng.kv.assert_conserved(host_pages=store.pages())


# ---------------------------------------------------------------------------
# the scheduler against the reference's
# ---------------------------------------------------------------------------
def test_scheduler_parity_with_reference(engines, monkeypatch):
    """One trace -- tier-1 rows filling the table, a tier-0 burst landing
    on it, ``max_backlog`` and a ``FaultPlane`` that drops rounds, stalls
    admissions and poisons swap reads -- through the reference's scheduler
    and the port's: the same outcomes, the same victims' slots, the same
    preemption and restore counts, the same greedy tokens.  The
    reference's rounds report ready at once, as the CPU port's do."""
    eng, jeng = engines
    monkeypatch.setattr(jcont.RoundHandle, "ready", lambda self: True)
    knobs = dict(drop_round_every=5, stall_admission_every=3,
                 poison_swap_every=4)
    rng = np.random.default_rng(21)
    V = eng.cfg.vocab_size
    # one request a tenant: the reference sheds only queue heads safely
    # (test_shed_behind_a_queue_head below)
    spec = [(f"t{i}", rng.integers(1, V, 9 + i).astype(np.int32),
             14 + 2 * i, 1) for i in range(4)]
    burst = [(f"hi{i}", rng.integers(1, V, 7).astype(np.int32), 4, 0)
             for i in range(2)]
    runs = {}
    for name, Sched, Cont, Req, Plane, e, kw in (
            ("port", MultiTenantScheduler, ContinuousBatchingEngine,
             Request, FaultPlane, eng, {}),
            ("ref", JaxSched, jcont.ContinuousBatchingEngine, JaxRequest,
             JaxFaultPlane, jeng, dict(backend="jnp"))):
        plane = Plane(**knobs)
        ceng = Cont(e, fault_plane=plane, **KW, **kw)
        victims = []
        preempt = ceng.preempt

        def spy(slot, preempt=preempt, victims=victims):
            victims.append(slot)
            return preempt(slot)

        ceng.preempt = spy
        sched = Sched(e, mode="continuous", continuous_engine=ceng,
                      preemption=True, max_backlog=3)
        for t, p, n, pr in spec:
            sched.submit(Req(t, p.copy(), n, priority=pr))
        sched.step()
        sched.step()
        for t, p, n, pr in burst:
            sched.submit(Req(t, p.copy(), n, priority=pr))
        out = sched.drain()
        runs[name] = dict(
            out=sorted((r.tenant, r.outcome, r.preemptions,
                        tuple(int(x) for x in r.tokens)) for r in out),
            victims=victims, pre=ceng.preemptions, res=ceng.restores,
            injected=dict(plane.injected), survived=sched.faults_survived,
            shed=sum(s["shed"] for s in sched.stats.values()))
    mine, ref = runs["port"], runs["ref"]
    assert mine == ref
    assert mine["pre"] >= 1 and mine["shed"] >= 1
    assert sum(mine["injected"].values()) >= 1


def test_shed_behind_a_queue_head(engines, pceng, rng):
    """Shedding a request queued behind another of its tenant removes that
    request itself (the reference's ``deque.remove`` compares the prompts
    of the two and raises there); the head is served."""
    eng, _ = engines
    V = eng.cfg.vocab_size
    reqs = [Request("one", rng.integers(1, V, 8 + i).astype(np.int32),
                    max_new_tokens=4) for i in range(4)]
    sched = _sched(eng, pceng, max_backlog=1)
    for r in reqs:
        sched.submit(r)
    out = sched.drain()
    assert [r.outcome for r in out] == ["completed"] + ["rejected"] * 3
    assert out[0].tokens.size == 4 and sched.stats["one"]["shed"] == 3
    late = Request("two", np.arange(1, 9, dtype=np.int32), 4,
                   deadline_s=time.perf_counter() - 1.0)
    sched = _sched(eng, pceng)
    sched.submit(Request("two", np.arange(2, 10, dtype=np.int32), 4))
    sched.submit(late)
    assert sorted(r.outcome for r in sched.drain()) == \
        ["completed", "rejected"]


# ---------------------------------------------------------------------------
# golden per-kind counters
# ---------------------------------------------------------------------------
def _drain_lockstep(ceng, reqs):
    queue, done = list(reqs), []
    while queue or ceng.active_count():
        free = ceng.free_slot_count()
        if queue and free:
            batch, queue = queue[:free], queue[free:]
            assert all(ceng.try_admit_batch(batch))
        done.extend(ceng.collect(ceng.dispatch_round()).finished)
    return done


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "whisper-base"])
def test_state_kind_counters_match_golden(arch):
    """tests/test_obs.py's admit -> round -> preempt -> restore -> drain
    cycle through the port gives the golden file's per-kind counters."""
    with open(GOLDEN) as f:
        want = json.load(f)["state_kind_counters"][arch]
    tel = Telemetry(enabled=True)
    cfg = get_config(arch).reduced()
    eng = ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")
    ceng = ContinuousBatchingEngine(eng, capacity=2, page_size=8,
                                    inner_steps=4, max_prompt_len=16,
                                    telemetry=tel)
    rng = np.random.default_rng(3)
    reqs = [Request(t, rng.integers(1, cfg.vocab_size, 12).astype(np.int32),
                    max_new_tokens=6) for t in ("a", "b")]
    assert all(ceng.try_admit_batch(reqs))
    ceng.collect(ceng.dispatch_round())
    ticket = ceng.preempt(0)
    assert ceng.try_restore(ticket)
    assert len(_drain_lockstep(ceng, [])) == 2
    got = {k: float(v) for k, v in sorted(tel.counter_snapshot().items())
           if k.startswith(("kv.cross.", "kv.ssm."))}
    assert got == want


def test_launch_serve_overload_flags():
    """``launch.serve`` holds the tier-0 requests back until the table is
    full, so they preempt; ``--max-backlog`` sheds; ``--no-swap`` waits
    instead of preempting."""
    import contextlib
    import io

    from repro_torch.launch import serve

    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert serve.main(["--device", "cpu", "--reduced", "--mode",
                               "continuous", "--tenants", "2", "--requests",
                               "8", "--prompt-len", "10", "--new-tokens",
                               "16", "--capacity", "2", "--priority", "4",
                               *extra]) == 0
        line, = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("overload:")]
        return dict(kv.split("=") for kv in line.split()[1:]), buf.getvalue()

    stats, text = run()
    assert stats["preemption"] == "on" and int(stats["preemptions"]) > 0
    assert int(stats["restores"]) == int(stats["preemptions"])
    assert "served 8 requests (completed=8 rejected=0) failed=0" in text
    stats, text = run("--max-backlog", "1")
    assert int(stats["shed"]) > 0
    stats, _ = run("--no-swap")
    assert stats["preemption"] == "off" and stats["preemptions"] == "0"
