"""The port's serving path against the JAX package's, token for token.

Both packages serve reduced internlm2 (and reduced h2o-danube, sliding
window) from the same weights -- the reference's initialiser, converted by
``params_from_jax`` -- on the CPU, where the port's kernel wrappers take
their plain versions and the reference runs ``backend="jnp"``:

* ``ServingEngine.generate`` gives the same greedy tokens in both;
* ``ContinuousBatchingEngine`` gives the same tokens as the reference's and
  as ``generate`` on the padded prompt, through prefix sharing, copy-on-write
  forks, a prefill-skipping repeat, eviction and page reuse -- with the same
  page accounting (allocated, reused, shared, forks, skips);
* ``MultiTenantScheduler(mode="continuous")`` serves the same tokens per
  tenant, with its accounting, timelines and terminal rejections;
* ``launch.serve --device cpu --reduced`` runs end to end, and the flags of
  later slices raise.
"""
import io
import contextlib

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.distributed import fault as jfault
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import MultiTenantScheduler as JaxSched
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.distributed import fault
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request


def _engines(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, vals)
    return (ServingEngine(cfg, params_from_jax(cfg, tree), device="cpu"),
            JaxEngine(jcfg, vals))


@pytest.fixture(scope="module")
def engines():
    return _engines("internlm2-1.8b")


def _padded(ceng, req):
    b = ceng.bucket_len(req.prompt.size)
    padded = np.zeros((1, b), np.int32)
    padded[0, b - req.prompt.size:] = req.prompt
    return padded


def _twin(req):
    """The same request for the reference's scheduler."""
    return JaxRequest(req.tenant, req.prompt.copy(), req.max_new_tokens,
                      temperature=req.temperature, top_k=req.top_k,
                      seed=req.seed, priority=req.priority)


def _counters(ceng):
    kv = ceng.kv
    return (kv.pages_allocated, kv.pages_reused, kv.pages_shared,
            kv.cow_forks, kv.pristine_forks, ceng.prefill_calls,
            ceng.prefill_skips, kv.free_pages(), kv.cached_pages())


def test_generate_matches_jax(engines):
    eng, jeng = engines
    prompts = np.random.default_rng(1).integers(
        1, eng.cfg.vocab_size, (3, 16)).astype(np.int32)
    got = eng.generate(prompts, 8)
    want = jeng.generate(prompts, 8)
    assert got.tokens.shape == (3, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_continuous_sharing_cow_and_skip_match_jax(engines):
    """The reference's sharing lifecycle (tests/test_paged_attention.py
    ::test_pallas_backend_token_exact_with_sharing_and_cow): a shared
    system prompt, CoW forks on the first decode write, a full-prefix repeat
    that skips its prefill, churn that evicts the cached chain, a second
    wave -- tokens and page accounting equal to the reference's."""
    eng, jeng = engines
    cfg = eng.cfg
    rng = np.random.default_rng(37)
    sys_prompt = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    mk = lambda t: Request(f"t{t}", np.concatenate(
        [sys_prompt, rng.integers(1, cfg.vocab_size, 8).astype(np.int32)]),
        max_new_tokens=6)
    wave = [mk(t) for t in range(3)]
    batches = [wave, [Request("t0", wave[0].prompt.copy(), max_new_tokens=6)],
               [Request("x", rng.integers(1, cfg.vocab_size, 32).astype(
                   np.int32), max_new_tokens=2) for _ in range(6)],
               [mk(t) for t in range(3)]]
    kw = dict(capacity=3, page_size=8, inner_steps=4, max_prompt_len=32)
    ceng = ContinuousBatchingEngine(eng, **kw)
    jceng = JaxCont(jeng, backend="jnp", **kw)
    pa.reset_counts()
    fa.reset_counts()
    flash_calls = 0                  # the continuous engine's own prefills
    for batch in batches:
        before = fa.plain_counts["flash_attention_plain"]
        got = {id(r): t for r, t in ceng.run_all(batch)}
        flash_calls += fa.plain_counts["flash_attention_plain"] - before
        want = {id(r): t for r, t in jceng.run_all(batch)}
        for r in batch:
            np.testing.assert_array_equal(got[id(r)], want[id(r)])
            np.testing.assert_array_equal(got[id(r)], eng.generate(
                _padded(ceng, r), r.max_new_tokens).tokens[0])
        assert _counters(ceng) == _counters(jceng)
    assert ceng.kv.pages_shared > 0 and ceng.prefill_skips >= 1
    assert ceng.kv.cow_forks + ceng.kv.pristine_forks > 0
    ceng.kv.assert_conserved()
    assert pa.launch_counts == {"paged_attention_decode": 0,
                                "paged_prefill_scatter": 0}
    assert pa.plain_counts["paged_attention_decode_plain"] > 0
    assert pa.plain_counts["paged_prefill_scatter_plain"] > 0
    # every prefill's attention went through ops.flash_attention: on the
    # CPU its plain version, once per layer and prefill call
    assert fa.launch_counts == {"flash_attention": 0}
    assert flash_calls == ceng.prefill_calls * cfg.num_layers > 0


def test_continuous_eviction_and_reuse_match_jax(engines):
    """Pool pressure without sharing (tests/test_continuous.py::
    test_page_reuse_after_eviction_token_exact): five two-page requests
    through a four-page pool recycle freed pages, stale positions never
    leak, and the LIFO accounting equals the reference's."""
    eng, jeng = engines
    rng = np.random.default_rng(31)
    reqs = [Request("a", rng.integers(1, eng.cfg.vocab_size, 12).astype(
        np.int32), max_new_tokens=3) for _ in range(5)]
    kw = dict(capacity=4, page_size=8, num_pages=2 + 4, inner_steps=2,
              max_prompt_len=16, prefix_sharing=False)
    ceng = ContinuousBatchingEngine(eng, **kw)
    jceng = JaxCont(jeng, backend="jnp", **kw)
    got = ceng.run_all(reqs)
    want = {id(r): t for r, t in jceng.run_all(reqs)}
    assert len(got) == 5
    for r, t in got:
        np.testing.assert_array_equal(t, want[id(r)])
    assert ceng.kv.pages_allocated == 10 and ceng.kv.pages_reused >= 6
    assert _counters(ceng) == _counters(jceng)
    assert ceng.occupancy() == pytest.approx(jceng.occupancy())


def test_sliding_window_arch_matches_jax():
    """h2o-danube (window 8 in the reduced config): ring shorter than the
    bucket, window-phase chain keys, the decode's window mask."""
    eng, jeng = _engines("h2o-danube-1.8b")
    rng = np.random.default_rng(41)
    reqs = [Request("a", rng.integers(1, eng.cfg.vocab_size,
                                      6 + 4 * i).astype(np.int32),
                    max_new_tokens=4) for i in range(3)]
    kw = dict(capacity=2, page_size=4, inner_steps=3, max_prompt_len=16)
    ceng = ContinuousBatchingEngine(eng, **kw)
    assert ceng.prefix_sharing
    got = {id(r): t for r, t in ceng.run_all(reqs)}
    want = {id(r): t for r, t in JaxCont(jeng, backend="jnp",
                                         **kw).run_all(reqs)}
    for r in reqs:
        np.testing.assert_array_equal(got[id(r)], want[id(r)])
        np.testing.assert_array_equal(got[id(r)], eng.generate(
            _padded(ceng, r), r.max_new_tokens).tokens[0])


def test_per_request_sampling(engines):
    """top_k=1 collapses to greedy, temperature rows vary by seed and are
    reproducible from it, a greedy row among sampled ones stays token-exact
    with generate, and a sampled row draws what generate draws for the same
    seed (one key per row per local step)."""
    eng, _ = engines
    cfg = eng.cfg
    p = np.random.default_rng(2).integers(1, cfg.vocab_size, 10).astype(
        np.int32)
    mk = lambda **kw: Request("a", p.copy(), 6, **kw)
    reqs = [mk(), mk(temperature=0.9, top_k=1, seed=3),
            mk(temperature=1.2, seed=5), mk(temperature=1.2, seed=9)]
    ceng = ContinuousBatchingEngine(eng, capacity=4, page_size=8,
                                    inner_steps=4, max_prompt_len=16)
    done = {id(r): t for r, t in ceng.run_all(reqs)}
    out = [done[id(r)] for r in reqs]
    greedy = eng.generate(_padded(ceng, reqs[0]), 6).tokens[0]
    np.testing.assert_array_equal(out[0], greedy)
    np.testing.assert_array_equal(out[1], greedy)
    assert not np.array_equal(out[2], out[3])
    again = {id(r): t for r, t in ceng.run_all(reqs[2:])}
    np.testing.assert_array_equal(again[id(reqs[2])], out[2])
    hot = ServingEngine(cfg, eng.params, temperature=1.2, device="cpu")
    np.testing.assert_array_equal(
        hot.generate(_padded(ceng, reqs[2]), 6, seed=5).tokens[0], out[2])


def _drain_by_tenant(sched, reqs):
    for r in reqs:
        sched.submit(r)
    out = {}
    for resp in sched.drain():
        out.setdefault(resp.tenant, []).append(tuple(resp.tokens.tolist()))
    return {t: sorted(v) for t, v in out.items()}


def test_scheduler_continuous_matches_jax(engines):
    """mode="continuous" end to end: the same tokens per tenant as the
    reference's scheduler, complete accounting, well-formed timelines."""
    eng, jeng = engines
    cfg = eng.cfg
    rng = np.random.default_rng(3)
    reqs = [Request(f"t{i % 2}", rng.integers(1, cfg.vocab_size,
                                              8 + 5 * (i % 3)).astype(
        np.int32), max_new_tokens=3 + 2 * (i % 3)) for i in range(7)]
    kw = dict(capacity=3, page_size=8, inner_steps=4, max_prompt_len=64)
    sched = MultiTenantScheduler(eng, mode="continuous", continuous=kw)
    got = _drain_by_tenant(sched, reqs)
    jsched = JaxSched(jeng, mode="continuous",
                      continuous=dict(kw, backend="jnp"))
    want = _drain_by_tenant(jsched, [_twin(r) for r in reqs])
    assert got == want
    rep, jrep = sched.utilization_report(), jsched.utilization_report()
    for t in ("t0", "t1"):
        for key in ("requests", "tokens", "rejected"):
            assert rep[t][key] == jrep[t][key]
    assert sum(r["tokens"] for r in rep.values()) == \
        sum(r.max_new_tokens for r in reqs)
    ceng = sched.continuous_engine
    assert sched._cont_inflight is None and sched.pending() == 0
    assert len(sched.timeline) == ceng.rounds
    for e in sched.timeline:
        assert e.transfer_start <= e.transfer_end <= e.compute_start \
            <= e.compute_end
    assert len(sched.admission_timeline) == 7
    assert sched.heartbeat_suspects == 0


def test_unadmittable_request_rejects_not_spins(engines, monkeypatch):
    eng, _ = engines
    kw = dict(capacity=2, page_size=8, inner_steps=2, max_prompt_len=16)
    with pytest.raises(ValueError, match="cannot hold"):
        ContinuousBatchingEngine(eng, num_pages=2 + 1, **kw)
    prompt = np.arange(1, 17, dtype=np.int32)
    ceng = ContinuousBatchingEngine(eng, **kw)
    monkeypatch.setattr(ceng, "try_admit_batch",
                        lambda reqs: [False] * len(reqs))
    req = Request("a", prompt, 4)
    assert ceng.run_all([req]) == [] and ceng.rejected == [req]
    sched = MultiTenantScheduler(eng, mode="continuous", continuous=kw)
    monkeypatch.setattr(sched.continuous_engine, "try_admit_batch",
                        lambda reqs: [False] * len(reqs))
    sched.submit(Request("a", prompt.copy(), 4))
    out = sched.drain()
    assert [r.outcome for r in out] == ["rejected"]
    assert out[0].tokens.size == 0 and sched.stats["a"]["rejected"] == 1
    with pytest.raises(ValueError, match="max_prompt_len"):
        ContinuousBatchingEngine(eng, **kw).run_all(
            [Request("a", np.arange(1, 40, dtype=np.int32), 2)])


def test_what_later_slices_bring_raises(engines):
    """Nothing is left to a later slice (``--mesh`` runs in every mode,
    tests/test_torch_slot_mesh.py); swap, preemption and the backlog bound
    build, and the crash flags are validated as the reference validates
    them."""
    eng, jeng = engines
    modes = ContinuousBatchingEngine.supported_modes(eng.cfg)
    assert modes["continuous"]["supported"]
    assert modes["continuous"]["state_kinds"] == ["attn"]
    assert modes["continuous"]["preemptable"]
    assert modes == JaxCont.supported_modes(jeng.cfg)
    assert modes["overlapped"]["supported"] and modes["blocking"]["supported"]
    ceng = ContinuousBatchingEngine(eng, capacity=2, max_prompt_len=16,
                                    swap=True)
    assert ceng.can_preempt and ceng.swap_store is not None
    assert not ContinuousBatchingEngine(eng, capacity=2, max_prompt_len=16,
                                        swap=False).can_preempt
    for kw in (dict(preemption=True), dict(max_backlog=4)):
        MultiTenantScheduler(eng, mode="continuous", **kw)
    assert serve.LATER == {}
    for argv in (["--journal-dir", "j"], ["--recover"],
                 ["--mode", "continuous", "--checkpoint-every", "2"]):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu"] + argv)


def test_launch_serve_cpu_end_to_end():
    seen = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--device", "cpu", "--reduced", "--mode",
                         "continuous", "--requests", "6",
                         "--tenants", "2", "--prompt-len", "12",
                         "--new-tokens", "6", "--shared-prefix-len", "16",
                         "--priority", "3"],
                        observe=seen.append)
    assert rc == 0
    text = buf.getvalue()
    assert "served 6 requests (completed=6 rejected=0)" in text
    assert "nonfinite logit rows=0" in text
    sched = seen[0]
    assert all(s is sched for s in seen) and len(seen) > 2
    eng = sched.continuous_engine
    assert eng.kv.pages_shared > 0
    # every third request is tier 0, in its tenant's own lane
    assert sched.stats["tenant-0-hi"]["requests"] == 1
    assert sched.stats["tenant-1-hi"]["requests"] == 1


@pytest.mark.parametrize("argv,mode", [
    ([], "overlapped"), (["--mode", "overlapped", "--stage-depth", "2"],
                         "overlapped"),
    (["--mode", "blocking"], "blocking"), (["--blocking"], "blocking")])
def test_launch_serve_slot_modes_cpu_end_to_end(argv, mode):
    """With no --mode the driver serves what the reference's does, the
    overlapped slot schedule; --mode blocking and --blocking the A/B
    baseline.  Both give the same tokens per request."""
    seen = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--device", "cpu", "--reduced", "--requests", "6",
                         "--tenants", "2", "--prompt-len", "12",
                         "--new-tokens", "5", "--max-batch", "2"] + argv,
                        observe=seen.append)
    assert rc == 0
    text = buf.getvalue()
    assert "served 6 requests (completed=6 rejected=0)" in text
    assert f"schedule={mode} overlap_pairs=" in text
    sched = seen[0]
    assert sched.mode == mode and sched.continuous_engine is None
    assert len(sched.timeline) == 4          # 3 requests a tenant, 2 a slot
    assert all(st["tokens"] == 15 for st in sched.stats.values())


def test_fault_pieces_match_reference():
    det, jdet = fault.StragglerDetector(), jfault.StragglerDetector()
    rng = np.random.default_rng(0)
    for _ in range(30):
        times = {k: float(rng.gamma(2.0)) * (5 if k == 3 else 1)
                 for k in range(4)}
        assert det.update(times) == jdet.update(times)
    assert det.staging_priority() == jdet.staging_priority()
    hb = fault.HeartbeatMonitor(timeout_s=60.0)
    assert not hb.suspect()
    hb.last_beat -= 120.0
    assert hb.suspect() and hb.missed == 1
    hb.beat()
    assert not hb.suspect()
