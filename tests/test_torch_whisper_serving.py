"""Serving the encoder-decoder arch (whisper-base) through the port's
engines, against the JAX package's, on the CPU.

Reduced whisper in float32 on the reference's weights
(``params_from_jax``); requests carry frames from ``synth_extra_inputs``:

* the cross page space of ``PagedKVCache`` alone; the continuous
  engine's state kinds (``attn`` and ``cross``) and its cross space;
  tokens equal to the port's ``generate`` on the padded prompt and to the
  reference's continuous engine (the port's twin of
  ``tests/test_continuous.py::test_enc_dec_continuous_token_exact``), the
  pool and the cross space conserved after the drain, the cross counters
  equal to the reference's -- at 16 encoder frames and at 100 (13 cross
  pages of 8, the last ragged);
* a prompt repeated with identical frames is prefilled again (its cross
  pages are its own) and shares its attention pages; other frames never
  share a page;
* ``dispatch`` and both slot schedules with frames, token-identical to
  ``generate`` and to the reference's engine and scheduler (as
  ``tests/test_serving_overlap.py`` holds whisper);
* ``launch.serve.main --arch whisper-base --reduced --device cpu`` in the
  continuous and the overlapped schedule.
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.obs.telemetry import Telemetry as JaxTelemetry
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import MultiTenantScheduler as JaxSched
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.telemetry import Telemetry
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

ARCH = "whisper-base"
KW = dict(capacity=2, page_size=8, inner_steps=3, max_prompt_len=16)
_CACHE = {}


def _engines(s_enc=None, temperature=0.0):
    """(port engine, reference engine) on the reference's weights, reduced
    whisper with ``s_enc`` encoder frames (the reduced config's 16 if
    None)."""
    key = (s_enc, temperature)
    if key not in _CACHE:
        jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
        if s_enc is not None:
            jcfg = dataclasses.replace(jcfg, encoder_seq_len=s_enc)
            cfg = dataclasses.replace(cfg, encoder_seq_len=s_enc)
        vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
        tree = jax.tree.map(np.asarray, vals)
        _CACHE[key] = (ServingEngine(cfg, params_from_jax(cfg, tree),
                                     temperature=temperature, device="cpu"),
                       JaxEngine(jcfg, vals, temperature=temperature))
    return _CACHE[key]


def _twin(req):
    return JaxRequest(req.tenant, req.prompt.copy(), req.max_new_tokens,
                      extra_inputs=req.extra_inputs)


def _oracle(eng, ceng, req):
    """``generate`` under the continuous path's conventions: the prompt
    left-padded to its admission bucket, the request's frames."""
    b = ceng.bucket_len(req.prompt.size)
    padded = np.zeros((1, b), np.int32)
    padded[0, b - req.prompt.size:] = req.prompt
    return eng.generate(padded, max_new_tokens=req.max_new_tokens,
                        extra_inputs={"frames": req.extra_inputs["frames"][
                            None]}).tokens[0]


def _requests(cfg, rng, lens=(5, 9, 13), new=6):
    return [Request(f"t{i}", rng.integers(1, cfg.vocab_size, n).astype(
        np.int32), new, extra_inputs=serve.synth_extra_inputs(cfg, rng))
        for i, n in enumerate(lens)]


def test_cross_space_allocates_private_rows():
    """The cross page space on its own: a row of ``cross_blocks`` distinct
    pages per slot, never a reserved page; a second row for a slot raises;
    ``free`` returns the row; the audit holds throughout; an arch without
    cross pages has none."""
    cfg = get_config(ARCH).reduced()
    kv = PagedKVCache(cfg, capacity=2, page_size=8, max_blocks=2,
                      cross_blocks=3)
    assert [k.name for k in kv.state_kinds] == ["attn", "cross"]
    assert kv.num_cross_pages == PagedKVCache.RESERVED + 2 * 3
    rows = [kv.alloc_cross(c) for c in range(2)]
    got = sorted(int(p) for r in rows for p in r)
    assert got == list(range(PagedKVCache.RESERVED, kv.num_cross_pages))
    assert [kv.cross_pages_of(c) for c in range(2)] == [r.tolist()
                                                        for r in rows]
    kv.assert_conserved()
    with pytest.raises(ValueError, match="already owns cross pages"):
        kv.alloc_cross(0)
    assert kv.free(0) == 0                 # no attention pages to release
    assert kv.cross_pages_of(0) == [] and kv.cross_pages_freed == 3
    kv.assert_conserved()
    again = kv.alloc_cross(0)
    assert sorted(again.tolist()) == sorted(rows[0].tolist())
    assert kv.cross_pages_allocated == 9
    dense = PagedKVCache(get_config("internlm2-1.8b").reduced(), capacity=2,
                         page_size=8, max_blocks=2)
    assert dense.cross_blocks == dense.num_cross_pages == 0
    assert "cross" not in [k.name for k in dense.state_kinds]


@pytest.mark.parametrize("s_enc", [None, 100])
def test_continuous_matches_generate_and_reference(s_enc, rng):
    """Three ragged requests over two slots (eviction and refill
    mid-drain): tokens equal to ``generate`` and to the reference's
    continuous engine; both spaces conserved; the cross counters equal to
    the reference's, one row of ``cross_blocks`` a request."""
    eng, jeng = _engines(s_enc)
    cfg = eng.cfg
    modes = ContinuousBatchingEngine.supported_modes(cfg)["continuous"]
    jmodes = JaxCont.supported_modes(jeng.cfg)["continuous"]
    assert modes["state_kinds"] == jmodes["state_kinds"] == ["attn", "cross"]
    for k in ("prefix_sharing", "window_phase_keys", "exactness"):
        assert modes[k] == jmodes[k], k
    reqs = _requests(cfg, rng)
    tel, jtel = Telemetry(enabled=True), JaxTelemetry(enabled=True)
    ceng = ContinuousBatchingEngine(eng, telemetry=tel, **KW)
    jceng = JaxCont(jeng, backend="jnp", telemetry=jtel, **KW)
    assert [k.name for k in ceng.state_kinds] == ["attn", "cross"]
    assert ceng.cross_blocks == jceng.cross_blocks == \
        -(-cfg.encoder_seq_len // KW["page_size"]) > 0
    assert tuple(ceng.state["cross_pt"].shape) == (2, ceng.cross_blocks)
    assert tuple(ceng.state["caches"]["cross"]["k"].shape) == (
        cfg.num_layers, ceng.kv.num_cross_pages, KW["page_size"],
        cfg.num_kv_heads, cfg.head_dim)
    done = {r.tenant: t for r, t in ceng.run_all(list(reqs))}
    want = {r.tenant: t for r, t in jceng.run_all([_twin(r) for r in reqs])}
    assert not ceng.rejected and len(done) == 3
    for r in reqs:
        np.testing.assert_array_equal(done[r.tenant], want[r.tenant])
        np.testing.assert_array_equal(_oracle(eng, ceng, r), done[r.tenant])
    assert ceng.prefill_skips == jceng.prefill_skips == 0
    assert ceng.nonfinite_rows == 0
    ceng.assert_conserved()
    jceng.kv.assert_conserved(host_pages={"attn": 0, "cross": 0, "ssm": 0})
    n = 3 * ceng.cross_blocks
    assert ceng.kv.cross_pages_allocated == ceng.kv.cross_pages_freed == n
    assert jceng.kv.cross_pages_allocated == n
    got, ref = tel.counter_snapshot(), jtel.counter_snapshot()
    for name in ("kv.cross.pages_allocated", "kv.cross.pages_freed"):
        assert got[name] == ref[name] == n, name


def test_repeated_prompt_with_identical_frames_is_prefilled_again(rng):
    """A prompt repeated with the same frames after its slot retired: its
    chain is still registered (pristine pages kept), yet it is prefilled
    again -- its cross pages were freed with its slot -- and decodes the
    first admission's tokens; its attention pages are shared.  The
    reference's engine does the same."""
    eng, jeng = _engines()
    cfg = eng.cfg
    prompt = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    ex = serve.synth_extra_inputs(cfg, rng)
    waves = [[Request("a", prompt, 5, extra_inputs=ex)],
             [Request("a2", prompt.copy(), 5, extra_inputs=dict(ex))]]
    kw = dict(KW, capacity=1, max_prompt_len=32, preserve_pristine="always")
    ceng = ContinuousBatchingEngine(eng, **kw)
    got = [ceng.run_all(w)[0][1] for w in waves]
    assert ceng.prefill_skips == 0 and ceng.prefill_calls == 2
    assert ceng.kv.pages_shared > 0
    np.testing.assert_array_equal(got[0], got[1])
    jceng = JaxCont(jeng, backend="jnp", **kw)
    want = [jceng.run_all([_twin(r) for r in w])[0][1] for w in waves]
    assert jceng.prefill_skips == 0
    assert jceng.kv.pages_shared == ceng.kv.pages_shared
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ceng.assert_conserved()


def test_different_frames_never_share_pages(rng):
    """One admission of three requests with one prompt: the two with the
    same frames share their prompt's pages (the chain keys are salted with
    the frames' digest) and decode the same tokens; the one with other
    frames shares no page.  Cross pages are never shared."""
    eng, _ = _engines()
    cfg = eng.cfg
    prompt = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    ex = [serve.synth_extra_inputs(cfg, rng) for _ in range(2)]
    ceng = ContinuousBatchingEngine(eng, **dict(KW, capacity=3,
                                                max_prompt_len=32))
    reqs = [Request("a", prompt, 4, extra_inputs=ex[0]),
            Request("b", prompt.copy(), 4, extra_inputs=ex[1]),
            Request("c", prompt.copy(), 4, extra_inputs=dict(ex[0]))]
    assert all(ceng.try_admit_batch(reqs))
    assert ceng.prefill_calls == 1 and ceng.prefill_skips == 0
    assert ceng.kv.pages_shared == 2           # c on a's two prompt pages
    rows = [ceng.kv.cross_pages_of(c) for c in range(3)]
    assert all(len(r) == ceng.cross_blocks for r in rows)
    assert len({p for r in rows for p in r}) == 3 * ceng.cross_blocks
    done = {}
    while ceng.active_count():
        res = ceng.collect(ceng.dispatch_round())
        done.update((r.tenant, t) for r, t, _ in res.finished)
    np.testing.assert_array_equal(done["c"], done["a"])
    for r in reqs:
        np.testing.assert_array_equal(done[r.tenant], _oracle(eng, ceng, r))
    ceng.assert_conserved()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_dispatch_matches_generate_and_reference(temperature, rng):
    """The decode loop of ``dispatch`` with frames is token-exact with
    ``generate`` (one sampling schedule); greedy, it gives the reference's
    ``dispatch`` tokens."""
    eng, jeng = _engines(temperature=temperature)
    cfg = eng.cfg
    prompts = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    extra = {"frames": rng.normal(size=(2, cfg.encoder_seq_len,
                                        cfg.d_model)).astype(np.float32)}
    for seed in (0, 7):
        blocking = eng.generate(prompts, 6, extra_inputs=extra, seed=seed)
        split = eng.await_result(eng.dispatch(prompts, 6, extra_inputs=extra,
                                              seed=seed))
        np.testing.assert_array_equal(blocking.tokens, split.tokens)
    if temperature == 0.0:
        want = jeng.await_result(jeng.dispatch(prompts, 6,
                                               extra_inputs=extra))
        np.testing.assert_array_equal(split.tokens, np.asarray(want.tokens))


def test_slot_schedules_with_frames_match_reference(rng):
    """Blocking and overlapped serve a tenant mix with frames (stacked per
    batch by ``_batch_extras``) and give the reference's overlapped
    scheduler's tokens, request for request; each equals ``generate`` on
    its batch."""
    eng, jeng = _engines()
    cfg = eng.cfg
    mix = [(f"tenant-{i % 3}", rng.integers(1, cfg.vocab_size, 8).astype(
        np.int32), serve.synth_extra_inputs(cfg, rng)) for i in range(6)]

    def run(sched_cls, req_cls, engine, **kw):
        sched = sched_cls(engine, max_batch=2, **kw)
        for tenant, prompt, ex in mix:
            sched.submit(req_cls(tenant, prompt.copy(), max_new_tokens=3,
                                 extra_inputs=ex))
        return sched, sched.drain()

    _, blocking = run(MultiTenantScheduler, Request, eng, mode="blocking")
    sched, overlapped = run(MultiTenantScheduler, Request, eng)
    _, ref = run(JaxSched, JaxRequest, jeng)
    stacked = sched._batch_extras([Request(t, p, 3, extra_inputs=ex)
                                   for t, p, ex in mix[:2]])
    assert stacked["frames"].shape == (2, cfg.encoder_seq_len, cfg.d_model)
    assert sched.mode == "overlapped"
    assert len(blocking) == len(overlapped) == len(ref) == 6
    for rb, ro, rr in zip(blocking, overlapped, ref):
        assert rb.tenant == ro.tenant == rr.tenant
        np.testing.assert_array_equal(rb.tokens, ro.tokens)
        np.testing.assert_array_equal(ro.tokens, np.asarray(rr.tokens))
    by_tenant = {}
    for tenant, prompt, ex in mix:
        by_tenant.setdefault(tenant, []).append((prompt, ex["frames"]))
    got = {}
    for r in overlapped:
        got.setdefault(r.tenant, []).append(r.tokens)
    for tenant, rows in by_tenant.items():
        gen = eng.generate(np.stack([p for p, _ in rows]), 3, extra_inputs={
            "frames": np.stack([f for _, f in rows])}).tokens
        np.testing.assert_array_equal(np.stack(got[tenant]), gen)


@pytest.mark.parametrize("mode", ["continuous", "overlapped"])
def test_launch_serve_whisper_on_the_cpu(mode):
    buf = io.StringIO()
    seen = []
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--mode", mode, "--tenants", "2", "--requests", "4",
                         "--prompt-len", "8", "--new-tokens", "4",
                         "--capacity", "2", "--max-batch", "2"],
                        observe=seen.append)
    out = buf.getvalue()
    assert rc == 0
    assert "arch=whisper-base-reduced" in out
    assert "served 4 requests (completed=4" in out
    sched = seen[0]
    if mode == "continuous":
        ceng = sched.continuous_engine
        assert [k.name for k in ceng.state_kinds] == ["attn", "cross"]
        assert ceng.kv.cross_pages_allocated == \
            ceng.kv.cross_pages_freed == 4 * ceng.cross_blocks
        ceng.assert_conserved()
