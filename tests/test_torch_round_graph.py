"""The decode round as one captured unit, against the JAX package's
jitted ``round_fn``.

The reference traces its round once per ``(steps, all_greedy, any_topk)``
and counts the traces (``decode_traces``, telemetry ``trace.decode``).  The
port counts the first use of each key the same way; on the card it captures
the key's round as a CUDA graph (``RoundProgram``) and replays it.  Here, on
the CPU, rounds stay the op-by-op enqueue, and the round program runs with a
stub in place of ``torch.cuda.CUDAGraph`` whose capture records the round
and whose replay runs it:

* the trace counts equal the reference engine's on the same admissions,
  under a ragged budget mix and mixed sampling tiers;
* the program keeps one graph per key, takes the kernel counts a capture
  added back out and adds them at every replay, and raises when a captured
  state tensor has moved;
* through the program, reduced internlm2 and mamba2 still match the JAX
  engine token for token.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.obs.telemetry import Telemetry as JaxTelemetry
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.telemetry import Telemetry
from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                            RoundProgram)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

KW = dict(capacity=2, page_size=8, inner_steps=4, max_prompt_len=32)
CAPTURED_LAUNCHES = 7        # what the stub's capture counts, as a wrapper
                             # counts launches that capture only records


def _engines(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, vals)
    return (ServingEngine(cfg, params_from_jax(cfg, tree), device="cpu"),
            JaxEngine(jcfg, vals))


@pytest.fixture(scope="module")
def engines():
    return _engines("internlm2-1.8b")


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: replay runs what was
    captured."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


class StubBackend:
    """The round program's CUDA side on the CPU: eager work runs in place,
    capture records the round without running it and counts launches the
    way a kernel wrapper does while a stream is captured."""

    def __init__(self):
        self.captured = []

    def run_beside(self, fn):
        fn()

    def capture(self, fn):
        self.captured.append(fn)
        pa.launch_counts["paged_attention_decode"] += CAPTURED_LAUNCHES
        return StubGraph(fn)

    def take_held(self):
        return []


def _tiered(rng, vocab, n, topk1=False):
    """Ragged prompts and budgets over three sampling tiers: greedy,
    temperature, temperature with top-k (``topk1``: temperature rows with
    top-k 1, which draw the greedy token, so that the two frameworks'
    random bits never decide a token)."""
    out = []
    for i in range(n):
        tier = i % 3
        kw = {}
        if tier == 1:
            kw = dict(temperature=0.9, top_k=1 if topk1 else 0, seed=i)
        elif tier == 2:
            kw = dict(temperature=1.1, top_k=1 if topk1 else 5, seed=i)
        out.append(Request("a", rng.integers(1, vocab, 5 + 3 * i).astype(
            np.int32), max_new_tokens=1 + (5 * i) % 11, **kw))
    return out


def _twin(req):
    return JaxRequest(req.tenant, req.prompt.copy(), req.max_new_tokens,
                      temperature=req.temperature, top_k=req.top_k,
                      seed=req.seed)


def test_decode_traces_match_reference_under_ragged_mix(engines):
    """tests/test_continuous.py::test_compile_count_stable_under_ragged_mix
    and tests/test_obs.py::test_enabled_plane_changes_no_compile_counts for
    the decode round: one trace per (steps, all_greedy, any_topk), however
    ragged the budgets, in the engine's count and the plane's counter."""
    eng, jeng = engines
    tel, jtel = Telemetry(enabled=True), JaxTelemetry(enabled=True)
    ceng = ContinuousBatchingEngine(eng, telemetry=tel, **KW)
    jceng = JaxCont(jeng, backend="jnp", telemetry=jtel, **KW)
    rng = np.random.default_rng(7)
    waves = [[Request("a", rng.integers(1, eng.cfg.vocab_size, 6 + i)
                      .astype(np.int32), max_new_tokens=1 + 4 * i)
              for i in range(3)],
             _tiered(rng, eng.cfg.vocab_size, 5),
             _tiered(rng, eng.cfg.vocab_size, 4)]
    seen = []
    for wave in waves:
        ceng.run_all(wave)
        jceng.run_all([_twin(r) for r in wave])
        assert ceng.decode_traces == jceng.decode_traces
        assert ceng.rounds == jceng.rounds
        seen.append(ceng.decode_traces)
    assert seen[0] == 1 and seen[-1] == 3      # greedy, then all three tiers
    assert (tel.counter_snapshot()["trace.decode"]
            == jtel.counter_snapshot()["trace.decode"] == 3)
    assert ceng.round_program is None          # the CPU enqueues op by op


def _drain(ceng, reqs):
    return {id(r): t for r, t in ceng.run_all(reqs)}


def test_round_program_bookkeeping_with_stub_graph(engines):
    """One capture per key; a capture's counts come back out and every
    replay adds them; the rounds give the eager engine's tokens and plain
    calls; a state tensor that moved after capture makes a replay raise."""
    eng, _ = engines
    rng = np.random.default_rng(11)
    reqs = _tiered(rng, eng.cfg.vocab_size, 7)
    pa.reset_counts()
    want = _drain(ContinuousBatchingEngine(eng, **KW), reqs)
    eager_plain = dict(pa.plain_counts)
    eager_launches = dict(pa.launch_counts)

    pa.reset_counts()
    ceng = ContinuousBatchingEngine(eng, **KW)
    backend = StubBackend()
    prog = ceng.round_program = RoundProgram(backend)
    got = _drain(ceng, reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[id(r)], want[id(r)])
    assert set(prog.rounds) == ceng._round_keys
    assert len(prog.rounds) == len(backend.captured) == ceng.decode_traces
    assert ceng.decode_traces == 3
    replays = sum(c.replays for c in prog.rounds.values())
    assert replays == ceng.rounds - ceng.decode_traces > 0
    assert all(c.graph.replays == c.replays for c in prog.rounds.values())
    assert all(c.emitted.shape == (KW["inner_steps"], KW["capacity"])
               for c in prog.rounds.values())
    # the capture's counts taken out, one replay's added per replay: the
    # stub counted launches only at capture, the CPU rounds plain calls
    for cap in prog.rounds.values():
        added = dict(zip(map(id, ops.counters()), cap.counts))
        assert added[id(pa.launch_counts)] == {
            "paged_attention_decode": CAPTURED_LAUNCHES}
        assert not any(n for c in cap.counts for n in c.values()
                       if c is not added[id(pa.launch_counts)])
    assert pa.launch_counts == {
        "paged_attention_decode": CAPTURED_LAUNCHES * replays,
        "paged_prefill_scatter": eager_launches["paged_prefill_scatter"]}
    assert pa.plain_counts == eager_plain

    # a captured tensor replaced, not written in place: the replay raises
    ceng.try_admit_batch([Request("a", reqs[0].prompt.copy(),
                                  max_new_tokens=4)])
    ceng.state["lstep"] = ceng.state["lstep"].clone()
    with pytest.raises(RuntimeError, match="state/lstep"):
        ceng.dispatch_round()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b"])
def test_round_program_matches_jax_engine(arch, engines):
    """Through the round program (the stub graph), the CPU engine gives the
    JAX engine's tokens, request for request: a greedy wave, then a wave of
    greedy rows beside temperature rows with top-k 1, ragged budgets."""
    eng, jeng = engines if arch == "internlm2-1.8b" else _engines(arch)
    rng = np.random.default_rng(13)
    V = eng.cfg.vocab_size
    waves = [[Request("a", rng.integers(1, V, 4 + 5 * i).astype(np.int32),
                      max_new_tokens=2 + 3 * i) for i in range(3)],
             _tiered(rng, V, 6, topk1=True)]
    ceng = ContinuousBatchingEngine(eng, **KW)
    ceng.round_program = RoundProgram(StubBackend())
    jceng = JaxCont(jeng, backend="jnp", **KW)
    for reqs in waves:
        got = _drain(ceng, reqs)
        twins = [_twin(r) for r in reqs]
        want = {id(t): tok for t, tok in jceng.run_all(twins)}
        for r, t in zip(reqs, twins):
            np.testing.assert_array_equal(got[id(r)], want[id(t)])
    assert set(ceng.round_program.rounds) == {(4, True, False),
                                              (4, False, True)}
    assert ceng.decode_traces == jceng.decode_traces == 2


def test_failed_capture_raises_and_nothing_falls_back(engines):
    """A capture that fails raises out of ``dispatch_round``; the key is
    not recorded as captured, so no later dispatch replays a half-made
    graph or quietly enqueues the round op by op instead."""
    eng, _ = engines

    class Failing(StubBackend):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    ceng = ContinuousBatchingEngine(eng, **KW)
    ceng.round_program = RoundProgram(Failing())
    ceng.try_admit_batch([Request("a", np.arange(1, 9, dtype=np.int32),
                                  max_new_tokens=6)])
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            ceng.dispatch_round()
    assert not ceng.round_program.rounds


def test_detached_decode_scratch_leaves_the_cache():
    """What a graph takes of the decode kernel's scratch is no longer the
    cache's: a later call on the stream cannot replace or reuse it."""
    cpu = torch.device("cpu")
    sc = dict(ml=torch.zeros(4), acc=torch.zeros(8),
              tickets=torch.zeros(2, dtype=torch.int32))
    pa._SCRATCH[(cpu.index, 991)] = sc
    assert ops.detach_decode_scratch(cpu, 991) is sc
    assert (cpu.index, 991) not in pa._SCRATCH
    assert ops.detach_decode_scratch(cpu, 991) is None


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b"])
def test_preempt_and_restore_between_stub_replays(arch, engines):
    """Preempt and restore between replays of captured rounds: evict and
    restore write the state in place, so the program keeps replaying the
    graphs it captured -- no new capture of a key, no address error -- and
    the victim's tokens equal the same request's uninterrupted run; the
    restore's page writes go through the scatter entry."""
    eng = engines[0] if arch == "internlm2-1.8b" else _engines(arch)[0]
    rng = np.random.default_rng(17)
    V = eng.cfg.vocab_size
    los = [Request(f"lo{i}", rng.integers(1, V, 10).astype(np.int32),
                   max_new_tokens=24, priority=1, seed=3 + i,
                   temperature=0.8 if i else None) for i in range(2)]
    hi = Request("hi", rng.integers(1, V, 6).astype(np.int32),
                 max_new_tokens=4, priority=0)
    ceng = ContinuousBatchingEngine(eng, **KW)
    backend = StubBackend()
    prog = ceng.round_program = RoundProgram(backend)
    want = {}
    for r in [*los, hi]:
        clone = Request(r.tenant, r.prompt.copy(), r.max_new_tokens,
                        temperature=r.temperature, seed=r.seed)
        want.update({q.tenant: t for q, t in ceng.run_all([clone])})
    keys, captured = dict(prog.rounds), len(backend.captured)
    replays0 = sum(c.replays for c in prog.rounds.values())
    pa.reset_counts()
    sched = MultiTenantScheduler(eng, mode="continuous",
                                 continuous_engine=ceng, preemption=True)
    for r in los:
        sched.submit(r)
    sched.step()
    sched.submit(hi)
    out = {r.tenant: r for r in sched.drain()}
    assert ceng.preemptions >= 1 and ceng.restores >= 1
    assert sum(r.preemptions for r in out.values()) >= 1
    for t, toks in want.items():
        np.testing.assert_array_equal(out[t].tokens, toks)
    assert prog.rounds == keys and len(backend.captured) == captured
    assert sum(c.replays for c in prog.rounds.values()) > replays0
    assert ceng.decode_traces == len(keys)
    if ceng.kv.attn_subs:      # one scatter call per sublayer per restore
        assert pa.plain_counts["paged_prefill_scatter_plain"] >= \
            2 * len(ceng.kv.attn_subs) * (ceng.restores + 1)
    ceng.assert_conserved()
