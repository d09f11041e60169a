"""The slot schedules (``overlapped``, the default, and ``blocking``) and the
engine's split ``dispatch``/``await_result`` halves, against the JAX
package.

Both packages serve reduced float32 internlm2, mamba2 and olmoe from the
same weights (the reference's initialiser, converted by
``params_from_jax``) on the CPU, where the port's decode loop runs eagerly
and the reference's is its jitted ``lax.scan``:

* ``dispatch``/``await_result`` is token-exact with ``generate`` within the
  port at temperatures 0.0 and 0.9 (one sampling schedule), and equal to
  the reference's ``dispatch`` when greedy;
* the ``PendingGeneration`` handle;
* blocking and overlapped serve the same tokens, request for request, as
  the reference's scheduler (greedy), with monotone windows when
  overlapped and no overlap pair when blocking;
* the scheduler-only cases of ``tests/test_serving.py`` (round robin,
  ``max_batch``, straggler priority without starvation in both schedules,
  ``pending`` counting staged batches, busy time without queue wait, the
  depth-N dispatch queue, the EWMA harvest, honest windows) with a fake
  engine that speaks both protocols.

Overlap that needs asynchronous completion is shown on the card by
``chip_smoke.py`` (``serve-slots``), not here.
"""
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.pipeline import timeline_overlaps as jax_overlaps
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import MultiTenantScheduler as JaxSched
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core.pipeline import timeline_overlaps
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import (GenerationResult, PendingGeneration,
                                        ServingEngine)
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

ARCHS = ["internlm2-1.8b", "mamba2-2.7b", "olmoe-1b-7b"]
_CACHE = {}


def _engines(arch):
    """(port engine, reference engine) on the reference's weights, built
    once per arch for the file."""
    if arch not in _CACHE:
        jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
        vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
        tree = jax.tree.map(np.asarray, vals)
        _CACHE[arch] = (ServingEngine(cfg, params_from_jax(cfg, tree),
                                      device="cpu"),
                        JaxEngine(jcfg, vals))
    return _CACHE[arch]


def _prompts(eng, rng, B=2, S=16):
    return rng.integers(1, eng.cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------
# dispatch / await_result
# ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_dispatch_await_token_exact(arch, temperature, rng):
    """tests/test_serving_overlap.py::test_dispatch_await_token_exact: the
    decode loop reproduces the host loop token for token (one sampling
    schedule: a key per row per local step)."""
    base, _ = _engines(arch)
    eng = ServingEngine(base.cfg, base.params, temperature=temperature,
                        device="cpu")
    prompts = _prompts(eng, rng)
    for seed in (0, 7):
        blocking = eng.generate(prompts, max_new_tokens=6, seed=seed)
        handle = eng.dispatch(prompts, max_new_tokens=6, seed=seed)
        split = eng.await_result(handle)
        np.testing.assert_array_equal(blocking.tokens, split.tokens)
        assert split.tokens.shape == (2, 6) and split.steps == 6
        assert split.prefill_s >= 0 and split.decode_s >= 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_jax_dispatch_greedy(arch, rng):
    """Greedy: the port's dispatch gives the reference's dispatch tokens,
    through the scalar loop and through per-request rows."""
    eng, jeng = _engines(arch)
    prompts = _prompts(eng, rng, B=3, S=12)
    got = eng.await_result(eng.dispatch(prompts, 5))
    want = jeng.await_result(jeng.dispatch(prompts, 5))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    rows = dict(temperatures=[0.0] * 3, top_ks=[0, 2, 0], seeds=[1, 2, 3])
    got_rows = eng.await_result(eng.dispatch(prompts, 5, **rows))
    np.testing.assert_array_equal(got_rows.tokens, got.tokens)
    np.testing.assert_array_equal(
        got_rows.tokens, np.asarray(jeng.await_result(
            jeng.dispatch(prompts, 5, **rows)).tokens))


def test_temperature_seeds_vary_tokens(rng):
    """The temperature path is not vacuous: seeds 0 and 1 differ, and a
    temperature row with top-k 1 draws the greedy token."""
    base, _ = _engines("internlm2-1.8b")
    eng = ServingEngine(base.cfg, base.params, temperature=1.0, device="cpu")
    prompts = _prompts(eng, rng, B=4)
    a = eng.await_result(eng.dispatch(prompts, 8, seed=0))
    b = eng.await_result(eng.dispatch(prompts, 8, seed=1))
    assert not np.array_equal(a.tokens, b.tokens)
    greedy = base.await_result(base.dispatch(prompts, 8))
    topk1 = eng.await_result(eng.dispatch(prompts, 8, top_ks=[1] * 4,
                                          seeds=[5, 6, 7, 8]))
    np.testing.assert_array_equal(topk1.tokens, greedy.tokens)


def test_pending_generation_handle(rng):
    eng, _ = _engines("internlm2-1.8b")
    prompts = _prompts(eng, rng)
    handle = eng.dispatch(prompts, max_new_tokens=4)
    assert isinstance(handle, PendingGeneration)
    assert handle.t_dispatched >= handle.t_start
    assert handle.done is None and handle.ready()   # the CPU: complete
    first = eng.await_result(handle)
    assert handle.ready()
    # awaiting the same handle again gives the same tokens
    np.testing.assert_array_equal(first.tokens,
                                  eng.await_result(handle).tokens)
    assert first.tokens.dtype == np.int32 and first.events is None


def test_extra_inputs_raise_naming_their_slice(rng):
    """Encoder frames given to a decoder-only arch are ignored, as the
    reference's prefill ignores them: ``dispatch`` and a slot schedule
    give the tokens of the same prompts without them, and the reference's
    ``dispatch`` the same."""
    eng, jeng = _engines("internlm2-1.8b")
    prompts = _prompts(eng, rng)
    frames = {"frames": np.zeros((2, 4, 8), np.float32)}
    plain = eng.await_result(eng.dispatch(prompts, 2)).tokens
    np.testing.assert_array_equal(
        eng.await_result(eng.dispatch(prompts, 2, extra_inputs=frames)
                         ).tokens, plain)
    np.testing.assert_array_equal(np.asarray(jeng.await_result(
        jeng.dispatch(prompts, 2, extra_inputs=frames)).tokens), plain)
    sched = MultiTenantScheduler(eng, max_batch=2)
    sched.submit(Request("a", prompts[0], 2,
                         extra_inputs={"frames": np.zeros((4, 8))}))
    out = sched.drain()
    sched.close()
    np.testing.assert_array_equal(out[0].tokens,
                                  eng.generate(prompts[:1], 2).tokens[0])


# ---------------------------------------------------------------------
# the two slot schedules on a real engine, against the reference's
# ---------------------------------------------------------------------
def _mix(cfg, rng, n=9):
    return [(f"tenant-{i % 3}",
             rng.integers(1, cfg.vocab_size,
                          8 + (i % 2) * 4).astype(np.int32))
            for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_blocking_and_overlapped_match_jax_scheduler(arch, rng):
    """tests/test_serving_overlap.py::
    test_scheduler_blocking_vs_overlapped_token_identical, held against
    the reference's scheduler too: the same (tenant, tokens) sequence from
    the port's two schedules and the reference's overlapped one (greedy),
    ragged prompts right-aligned in their batch."""
    eng, jeng = _engines(arch)
    mix = _mix(eng.cfg, rng)

    def run(sched_cls, req_cls, engine, **kw):
        sched = sched_cls(engine, max_batch=2, **kw)
        for tenant, prompt in mix:
            sched.submit(req_cls(tenant, prompt.copy(), max_new_tokens=3))
        return sched, sched.drain()

    _, blocking = run(MultiTenantScheduler, Request, eng, overlapped=False)
    sched, overlapped = run(MultiTenantScheduler, Request, eng)
    jsched, ref = run(JaxSched, JaxRequest, jeng)
    assert sched.mode == "overlapped" and sched.continuous_engine is None
    assert len(blocking) == len(overlapped) == len(ref) == 9
    for rb, ro, rr in zip(blocking, overlapped, ref):
        assert rb.tenant == ro.tenant == rr.tenant
        assert rb.batch_size == ro.batch_size == rr.batch_size
        np.testing.assert_array_equal(rb.tokens, ro.tokens)
        np.testing.assert_array_equal(ro.tokens, np.asarray(rr.tokens))
    rep, jrep = sched.utilization_report(), jsched.utilization_report()
    assert set(rep) == set(jrep) == {"tenant-0", "tenant-1", "tenant-2"}
    for t in rep:
        assert rep[t]["requests"] == jrep[t]["requests"]
        assert rep[t]["tokens"] == jrep[t]["tokens"]
    assert len(sched.timeline) == len(jsched.timeline) == 6
    assert sched.pending() == 0 and not sched._inflight


def test_per_request_sampling_rides_the_overlapped_slot(rng):
    """Per-request temperature, top-k and seed go to dispatch as rows: a
    greedy row beside sampled ones keeps ``generate``'s tokens, top-k 1
    draws the greedy token, and a sampled row is reproducible from its
    seed."""
    eng, _ = _engines("internlm2-1.8b")
    p = _prompts(eng, rng, B=1)[0]
    reqs = [Request("a", p.copy(), 5),
            Request("a", p.copy(), 5, temperature=0.9, top_k=1, seed=3),
            Request("a", p.copy(), 5, temperature=1.2, seed=5)]

    def serve():
        sched = MultiTenantScheduler(eng, max_batch=3)
        for r in reqs:
            sched.submit(r)
        return [r.tokens for r in sched.drain()]

    out = serve()
    greedy = eng.generate(p[None], 5).tokens[0]
    np.testing.assert_array_equal(out[0], greedy)
    np.testing.assert_array_equal(out[1], greedy)
    np.testing.assert_array_equal(serve()[2], out[2])
    hot = ServingEngine(eng.cfg, eng.params, temperature=1.2, device="cpu")
    np.testing.assert_array_equal(
        hot.generate(p[None], 5, seed=5).tokens[0], out[2])


def test_overlapped_timeline_windows_are_monotone(rng):
    eng, _ = _engines("internlm2-1.8b")
    sched = MultiTenantScheduler(eng, max_batch=2, overlapped=True)
    for i in range(6):
        sched.submit(Request(f"t{i % 2}", rng.integers(
            1, eng.cfg.vocab_size, 8).astype(np.int32), max_new_tokens=2))
    sched.drain()
    tl = sched.timeline
    assert len(tl) == 4                    # 3 reqs/tenant at max_batch=2
    for e in tl:
        assert e.transfer_start <= e.transfer_end <= e.compute_start \
            <= e.compute_end, vars(e)
    for a, b in zip(tl, tl[1:]):           # staged in launch order
        assert b.transfer_start >= a.transfer_start


def test_blocking_schedule_structurally_shows_zero_overlap(rng):
    """The A/B baseline cannot satisfy the overlap predicate, in the port
    as in the reference: each slot is assembled after the previous
    generate() returned."""
    eng, jeng = _engines("internlm2-1.8b")
    prompts = [rng.integers(1, eng.cfg.vocab_size, 8).astype(np.int32)
               for _ in range(6)]
    for sched_cls, req_cls, engine, ov_fn in (
            (MultiTenantScheduler, Request, eng, timeline_overlaps),
            (JaxSched, JaxRequest, jeng, jax_overlaps)):
        sched = sched_cls(engine, max_batch=2, mode="blocking")
        for i, p in enumerate(prompts):
            sched.submit(req_cls(f"t{i % 2}", p.copy(), max_new_tokens=2))
        sched.drain()
        ov = ov_fn(sched.timeline)
        assert len(ov) == 3 and sum(ov) == 0, ov


def test_multitenant_round_robin(rng):
    eng, _ = _engines("internlm2-1.8b")
    sched = MultiTenantScheduler(eng, max_batch=2)
    for i in range(6):
        sched.submit(Request(f"tenant-{i % 2}", rng.integers(
            1, 200, 8).astype(np.int32), max_new_tokens=2))
    responses = sched.drain()
    assert len(responses) == 6
    rep = sched.utilization_report()
    assert set(rep) == {"tenant-0", "tenant-1"}
    assert rep["tenant-0"]["requests"] == 3
    assert abs(sum(r["busy_share"] for r in rep.values()) - 1.0) < 1e-6
    # batches alternate tenants
    assert [e.vdev for e in sched.timeline] == [0, 1, 0, 1]


def test_multitenant_batching_caps(rng):
    eng, _ = _engines("internlm2-1.8b")
    sched = MultiTenantScheduler(eng, max_batch=2)
    for _ in range(5):
        sched.submit(Request("t", rng.integers(1, 200, 8).astype(np.int32),
                             max_new_tokens=1))
    r1 = sched.step()
    assert len(r1) == 2 and all(x.batch_size == 2 for x in r1)
    sched.drain()
    assert sched.pending() == 0


def test_idle_step_returns_none():
    eng, _ = _engines("internlm2-1.8b")
    for mode in ("overlapped", "blocking"):
        sched = MultiTenantScheduler(eng, mode=mode)
        assert sched.step() is None
        sched.close()


# ---------------------------------------------------------------------
# scheduler-only cases, a fake engine that speaks both protocols
# ---------------------------------------------------------------------
class _Done:
    """Stands in for a CUDA event: ``synchronize`` sleeps out the rest of
    the fake decode, ``query`` says whether it is over."""

    def __init__(self, delay_s):
        self._ready_at = time.perf_counter() + delay_s

    def synchronize(self):
        rem = self._ready_at - time.perf_counter()
        if rem > 0:
            time.sleep(rem)

    def query(self):
        return time.perf_counter() >= self._ready_at


class _FakeEngine:
    """Deterministic stand-in: per-tenant latency keyed by the prompt's
    last token (tests/test_serving.py::_FakeEngine)."""

    temperature = 0.0

    def __init__(self, delays):
        self.delays = delays             # last-token value -> seconds

    def _delay(self, prompts):
        return self.delays.get(int(prompts[0, -1]), 0.0)

    def generate(self, prompts, steps, **kw):
        d = self._delay(prompts)
        time.sleep(d)
        return GenerationResult(np.zeros((prompts.shape[0], steps), np.int32),
                                0.0, d, steps)

    def dispatch(self, prompts, steps, **kw):
        t0 = time.perf_counter()
        import torch
        return PendingGeneration(
            torch.zeros((prompts.shape[0], steps), dtype=torch.int32),
            steps, t0, time.perf_counter(), done=_Done(self._delay(prompts)))

    def await_result(self, handle):
        t0 = time.perf_counter()
        handle.done.synchronize()
        return GenerationResult(handle.tokens.numpy(), 0.0,
                                time.perf_counter() - t0, handle.steps)


@pytest.mark.parametrize("overlapped", [False, True])
def test_straggler_priority_serves_rounds_without_starvation(overlapped):
    eng = _FakeEngine({1: 0.02, 2: 0.0})
    sched = MultiTenantScheduler(eng, max_batch=1, straggler_priority=True,
                                 overlapped=overlapped)
    for _ in range(3):
        sched.submit(Request("slow", np.array([1], np.int32), 1))
        sched.submit(Request("fast", np.array([2], np.int32), 1))
    served = []
    while sched.pending():
        r = sched.step()
        if r:
            served.extend(x.tenant for x in r)
    sched.close()
    assert served.count("fast") == 3 and served.count("slow") == 3
    if not overlapped:
        # blocking: round 2's pick already sees round 1's latencies
        assert served[2] == "slow" and served[3] == "fast"


def test_straggler_detector_keyed_by_stable_slot():
    eng = _FakeEngine({1: 0.01, 2: 0.0})
    sched = MultiTenantScheduler(eng, max_batch=1, overlapped=False)
    for _ in range(2):
        sched.submit(Request("tenant-a", np.array([1], np.int32), 1))
        sched.submit(Request("tenant-b", np.array([2], np.int32), 1))
    sched.drain()
    assert set(sched.detector.mean) == {0, 1}
    assert sched._slot_of == {"tenant-a": 0, "tenant-b": 1}
    assert sched.detector.mean[0] > sched.detector.mean[1]


def test_pending_counts_staged_ahead_batches():
    """pending() counts requests held in staged-ahead state (assembled but
    unserved, and dispatched but unawaited), or drain() would exit with
    work in flight."""
    eng = _FakeEngine({})
    sched = MultiTenantScheduler(eng, max_batch=2, overlapped=True)
    for _ in range(2):
        sched.submit(Request("a", np.array([1], np.int32), 1))
        sched.submit(Request("b", np.array([2], np.int32), 1))
    assert sched.pending() == 4
    r = sched.step()                       # serves a; b left dispatched
    assert len(r) == 2
    assert sched.pending() == 2 and len(sched.queues["b"]) == 0
    r = sched.step()
    assert len(r) == 2 and sched.pending() == 0
    sched.close()
    sched = MultiTenantScheduler(eng, max_batch=2, overlapped=False)
    for _ in range(2):
        sched.submit(Request("a", np.array([1], np.int32), 1))
        sched.submit(Request("b", np.array([2], np.int32), 1))
    sched.step()                           # serves a, stages b ahead
    assert sched._prepared is not None
    assert sched.pending() == 2


def test_overlapped_busy_excludes_queue_wait():
    """A slot dispatched under the previous slot's long decode is not
    billed for that wait: its compute window opens at the previous slot's
    compute_end."""
    eng = _FakeEngine({1: 0.08, 2: 0.0})
    sched = MultiTenantScheduler(eng, max_batch=1, overlapped=True)
    sched.submit(Request("slow", np.array([1], np.int32), 1))
    sched.submit(Request("fast", np.array([2], np.int32), 1))
    sched.drain()
    slow, fast = sched.timeline
    assert slow.compute_s >= 0.05
    assert fast.compute_s < 0.05, vars(fast)
    assert fast.compute_start >= slow.compute_end - 1e-6
    assert sched.stats["fast"]["busy_s"] < 0.05


def test_depth_n_dispatch_queue():
    """stage_depth 3 keeps up to 1 + 3 slots in flight, pending() counts
    them all, and responses come back in dispatch order."""
    eng = _FakeEngine({})
    sched = MultiTenantScheduler(eng, max_batch=1, overlapped=True,
                                 stage_depth=3)
    for i in range(5):
        sched.submit(Request("t", np.array([i], np.int32), 1))
    r = sched.step()                       # fills to 4 in flight, awaits 1
    assert len(r) == 1
    assert len(sched._inflight) == 3
    assert sched.pending() == 4            # 3 in flight + 1 queued
    served = len(r)
    while sched.pending():
        served += len(sched.step() or [])
    sched.close()
    assert served == 5


def test_ewma_harvest_closes_one_batch_lag():
    """When slot k's completion has landed, its latency is stamped before
    the pick for slot k+1: tenant b's slow first batch lands while the host
    idles, so round 2 starts with b."""
    eng = _FakeEngine({1: 0.02, 2: 0.06})
    sched = MultiTenantScheduler(eng, max_batch=1, straggler_priority=True,
                                 overlapped=True)
    for _ in range(2):
        sched.submit(Request("a", np.array([1], np.int32), 1))
        sched.submit(Request("b", np.array([2], np.int32), 1))
    served = [x.tenant for x in sched.step()]        # serves a; b in flight
    time.sleep(0.2)                # b's decode lands, the waiter stamps it
    while sched.pending():
        r = sched.step()
        if r:
            served.extend(x.tenant for x in r)
    sched.close()
    assert served == ["a", "b", "b", "a"], served
    rep = sched.utilization_report()
    assert rep["a"]["requests"] == 2 and rep["b"]["requests"] == 2


def _drain_order(sched):
    served = []
    while sched.pending():
        r = sched.step()
        if r:
            served.extend(x.tenant for x in r)
    sched.close()
    return served


def _assert_round_invariant(served, tenants, rounds):
    assert len(served) == len(tenants) * rounds
    for r in range(rounds):
        chunk = served[r * len(tenants):(r + 1) * len(tenants)]
        assert sorted(chunk) == sorted(tenants), (r, served)


@pytest.mark.parametrize("overlapped", [False, True])
@pytest.mark.parametrize("n_tenants,rounds,ewma", [
    (2, 3, [5.0, 0.0]),
    (3, 2, [0.0, 9.0, 9.0]),       # ties + zero history
    (4, 2, [1.0, 1.0, 1.0, 1.0]),  # fully degenerate EWMA
])
def test_straggler_round_invariant(n_tenants, rounds, ewma, overlapped):
    """Every backlogged tenant is served exactly once per round, in both
    schedules, whatever the EWMA seeding."""
    sched = MultiTenantScheduler(_FakeEngine({}), max_batch=1,
                                 straggler_priority=True,
                                 overlapped=overlapped)
    tenants = [f"t{i}" for i in range(n_tenants)]
    for _ in range(rounds):
        for t in tenants:
            sched.submit(Request(t, np.array([0], np.int32), 1))
    sched._recent.update(dict(zip(tenants, ewma)))
    _assert_round_invariant(_drain_order(sched), tenants, rounds)


def test_serving_timeline_windows_are_honest():
    """Blocking: the compute window is the generate call only; the
    staged-ahead assembly of the next slot does not stretch it."""
    eng = _FakeEngine({1: 0.01, 2: 0.01})
    sched = MultiTenantScheduler(eng, max_batch=1, overlapped=False)
    for _ in range(2):
        sched.submit(Request("a", np.array([1], np.int32), 1))
        sched.submit(Request("b", np.array([2], np.int32), 1))
    while sched.pending():
        sched.step()
    tl = sched.timeline
    assert len(tl) == 4
    for e in tl:
        assert e.transfer_start <= e.transfer_end <= e.compute_start \
            <= e.compute_end
    for a, b in zip(tl, tl[1:]):
        assert b.transfer_start >= a.compute_end - 1e-6


def test_overlap_pairs_with_asynchronous_completion():
    """With completions that land after dispatch returns (the fake's
    events, as a card's), the overlapped schedule stages slot k+1 inside
    slot k's decode window and the blocking one never does."""
    eng = _FakeEngine({1: 0.05, 2: 0.05, 3: 0.05})
    pairs = {}
    for mode in ("overlapped", "blocking"):
        sched = MultiTenantScheduler(eng, max_batch=1, mode=mode)
        for t in (1, 2, 3):
            sched.submit(Request(f"t{t}", np.array([t], np.int32), 1))
        sched.drain()
        pairs[mode] = sum(timeline_overlaps(sched.timeline))
    assert pairs["overlapped"] >= 1 and pairs["blocking"] == 0


@pytest.mark.parametrize("mode", ["overlapped", "blocking"])
def test_slot_spans_match_the_reference(mode, rng):
    """With the plane lit, a slot schedule records the reference's spans:
    ``engine.dispatch`` and ``engine.await`` (overlapped) or
    ``engine.generate`` (blocking), ``engine.prefill`` per slot,
    ``sched.step`` carrying the mode, and the slot timeline."""
    from repro.obs.telemetry import Telemetry as JaxTelemetry
    from repro_torch.obs.telemetry import Telemetry
    eng, jeng = _engines("internlm2-1.8b")
    mix = _mix(eng.cfg, rng, n=6)
    names = {}
    for side, tel, engine, sched_cls, req_cls in (
            ("port", Telemetry(enabled=True), eng, MultiTenantScheduler,
             Request),
            ("ref", JaxTelemetry(enabled=True), jeng, JaxSched, JaxRequest)):
        old = engine.tel
        engine.tel = tel
        try:
            sched = sched_cls(engine, max_batch=2, mode=mode, telemetry=tel)
            for tenant, prompt in mix:
                sched.submit(req_cls(tenant, prompt.copy(), max_new_tokens=2))
            sched.drain()
        finally:
            engine.tel = old
        spans = tel.spans()
        names[side] = sorted(s.name for s in spans
                             if s.name.split(".")[0] in ("engine", "sched",
                                                         "timeline"))
        steps = [s for s in spans if s.name == "sched.step"]
        assert steps and all(s.attrs["mode"] == mode for s in steps)
    assert names["port"] == names["ref"]
    want = {"overlapped": {"engine.dispatch", "engine.await"},
            "blocking": {"engine.generate"}}[mode]
    assert want <= set(names["port"])
