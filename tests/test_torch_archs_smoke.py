"""Per-architecture smoke tests of the port (the JAX package's
``tests/test_archs_smoke.py`` for the archs ported so far), on the CPU at
reduced size in float32.

* prefill and decode give finite logits of the padded vocabulary, and
  decoding token S from the prefill cache equals the full forward over S+1
  (the reference's tolerance, ``rtol = atol = 2e-2``);
* the published block schedules (jamba's 1:7 interleave, llama4's MoE
  everywhere);
* the continuous engine serves every ported arch: three ragged requests
  over two slots, tokens equal to the reference's continuous engine on the
  same weights (``params_from_jax``), and to ``generate`` on the padded
  prompt where ``supported_modes`` says ``bitwise``;
* a hybrid arch never skips a prefill: a repeated prompt admitted after its
  slot retired is prefilled again (its SSM state is neither paged nor
  cached);
* llava's extra-inputs path: ``_merge_patches`` against the reference's,
  page sharing only under identical patch embeddings, a slot batch's
  stacked extras; ``synth_extra_inputs`` and ``list_archs`` against the
  reference's.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import ARCH_IDS, PORTED_ARCHS, get_config
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import pad_vocab
from repro_torch.models.model import build_model
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

LM_ARCHS = tuple(a for a in ARCH_IDS if a in PORTED_ARCHS)
JAMBA = "jamba-1.5-large-398b"
LLAVA = "llava-next-mistral-7b"


def _extras(cfg, rng, B):
    """A prefill batch's non-token inputs: patch embeddings (llava) or
    encoder frames (whisper)."""
    out = {}
    if cfg.num_patches:
        out["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_patches, 1024)).astype(np.float32))
    if cfg.enc_dec:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_prefill_decode(arch, rng):
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    params = bundle.init(0)
    B, S = 2, 32
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)), **_extras(cfg, rng, B)}
    logits, caches, idx = bundle.prefill_fn(params, batch)
    assert tuple(logits.shape) == (B, pad_vocab(cfg.vocab_size))
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all(), arch
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits2, _ = bundle.decode_fn(params, tok, caches, idx)
    assert logits2.shape == logits.shape
    assert torch.isfinite(logits2[:, :cfg.vocab_size]).all(), arch


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "mamba2-2.7b", JAMBA, "olmoe-1b-7b"])
def test_decode_consistent_with_full_forward(arch, rng):
    """Decoding token S with the prefill cache == full forward over S+1."""
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    params = bundle.init(0)
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (B, S + 1)).astype(np.int32))
    _, caches, idx = bundle.prefill_fn(params, {"tokens": toks[:, :S]})
    ld, _ = bundle.decode_fn(params, toks[:, S:S + 1], caches, idx)
    lf, _, _ = bundle.prefill_fn(params, {"tokens": toks})
    np.testing.assert_allclose(ld.numpy(), lf.numpy(), rtol=2e-2, atol=2e-2)


def test_block_schedules():
    jamba = get_config(JAMBA)
    sched = jamba.block_schedule()
    assert len(sched) == 72
    attn_layers = [i for i, (m, _) in enumerate(sched) if m == "attn"]
    assert len(attn_layers) == 9          # 1:7 interleave
    assert all(i % 8 == 4 for i in attn_layers)
    moe_layers = [i for i, (_, m) in enumerate(sched) if m == "moe"]
    assert len(moe_layers) == 36          # every other layer
    assert jamba.stage_period == 8

    mamba = get_config("mamba2-2.7b")
    assert all(m == "mamba" for m, _ in mamba.block_schedule())
    assert all(p == "none" for _, p in mamba.block_schedule())

    llama4 = get_config("llama4-maverick-400b-a17b")
    assert all(s == ("attn", "moe") for s in llama4.block_schedule())
    # the serve driver's depth cut: a prefix of the published schedule
    cut = dataclasses.replace(jamba, num_layers=5)
    assert cut.block_schedule() == sched[:5]
    assert cut.stage_period == 5


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """(port engine, reference engine) on the reference's weights."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, vals)
    return (ServingEngine(cfg, params_from_jax(cfg, tree), device="cpu"),
            JaxEngine(jcfg, vals))


def _oracle(eng, ceng, req):
    """``generate`` under the continuous path's conventions: the prompt
    left-padded to its admission bucket, the same extras."""
    b = ceng.bucket_len(req.prompt.size)
    padded = np.zeros((1, b), np.int32)
    padded[0, b - req.prompt.size:] = req.prompt
    extra = {k: np.asarray(v)[None]
             for k, v in (req.extra_inputs or {}).items()}
    return eng.generate(padded, max_new_tokens=req.max_new_tokens,
                        extra_inputs=extra or None).tokens[0]


def _twin(req):
    return JaxRequest(req.tenant, req.prompt.copy(), req.max_new_tokens,
                      extra_inputs=req.extra_inputs)


KW = dict(capacity=2, page_size=8, inner_steps=3, max_prompt_len=16)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_continuous_serving(arch, rng):
    """Three ragged requests over two slots force eviction and refill
    mid-drain (llava's each with its own patch embeddings): tokens equal to
    the reference's continuous engine on the same weights, and to
    ``generate`` where the arch is ``bitwise``; the pool conserved."""
    eng, jeng = _engines(arch)
    cfg = eng.cfg
    modes = ContinuousBatchingEngine.supported_modes(cfg)
    want_modes = JaxCont.supported_modes(jeng.cfg)
    for k in ("supported", "state_kinds", "prefix_sharing",
              "window_phase_keys", "exactness"):
        assert modes["continuous"][k] == want_modes["continuous"][k], k
    reqs = []
    for i, n in enumerate((5, 9, 13)):
        extra = serve.synth_extra_inputs(cfg, rng) or None
        reqs.append(Request(f"t{i}", rng.integers(
            1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=6,
            extra_inputs=extra))
    ceng = ContinuousBatchingEngine(eng, **KW)
    jceng = JaxCont(jeng, backend="jnp", **KW)
    done = {req.tenant: toks for req, toks in ceng.run_all(list(reqs))}
    want = {req.tenant: toks
            for req, toks in jceng.run_all([_twin(r) for r in reqs])}
    assert not ceng.rejected
    for req in reqs:
        toks = done[req.tenant]
        assert toks.shape == (req.max_new_tokens,)
        np.testing.assert_array_equal(toks, want[req.tenant], err_msg=arch)
        if modes["continuous"]["exactness"] == "bitwise":
            np.testing.assert_array_equal(_oracle(eng, ceng, req), toks,
                                          err_msg=arch)
    assert ceng.prefill_skips == jceng.prefill_skips == 0
    assert ceng.nonfinite_rows == 0
    ceng.assert_conserved()


def _dense_hybrid():
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), moe=None,
                              moe_period=0)
    return ServingEngine(cfg, build_model(cfg).init(0), device="cpu")


@pytest.mark.parametrize("which", ["jamba", "dense hybrid"])
def test_hybrid_repeated_prompt_is_prefilled(which, rng):
    """A hybrid row's SSM state is neither paged nor cached, so a prompt
    repeated after its slot retired is prefilled again, never admitted
    from the shared pages and cached logits alone (the reference's
    ``_pure_attn`` gate): no prefill skip, tokens equal to the
    reference's engine (jamba) or to ``generate`` (the dense hybrid, whose
    rows are independent); the attention pages are still shared."""
    if which == "jamba":
        eng, jeng = _engines(JAMBA)
    else:
        eng, jeng = _dense_hybrid(), None
    cfg = eng.cfg
    assert ContinuousBatchingEngine.supported_modes(cfg)["continuous"][
        "state_kinds"] == ["attn", "ssm"]
    prompt = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    other = rng.integers(1, cfg.vocab_size, 11).astype(np.int32)
    waves = [[Request("a", prompt, 5)], [Request("b", other, 7)],
             [Request("a2", prompt.copy(), 5)]]
    # every registered page kept pristine, so the repeat finds its whole
    # chain registered
    kw = dict(KW, capacity=1, max_prompt_len=32, preserve_pristine="always")
    ceng = ContinuousBatchingEngine(eng, **kw)
    got = [ceng.run_all(w)[0][1] for w in waves]
    assert ceng.prefill_skips == 0 and ceng.prefill_calls == 3
    assert ceng.kv.pages_shared > 0          # attention pages still shared
    np.testing.assert_array_equal(got[0], got[2])
    if jeng is not None:
        jceng = JaxCont(jeng, backend="jnp", **kw)
        want = [jceng.run_all([_twin(r) for r in w])[0][1] for w in waves]
        assert jceng.prefill_skips == 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        for g, w in zip(got, waves):
            np.testing.assert_array_equal(g, _oracle(eng, ceng, w[0]))
    ceng.assert_conserved()


def test_merge_patches_matches_jax(rng):
    eng, jeng = _engines(LLAVA)
    cfg = eng.cfg
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pe = rng.normal(size=(2, cfg.num_patches, 1024)).astype(np.float32)
    got = tmodel._merge_patches(eng.params, torch.from_numpy(x),
                                torch.from_numpy(pe), cfg)
    want = jmodel._merge_patches(jeng.params, jnp.asarray(x), jnp.asarray(pe),
                                 jeng.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[:, cfg.num_patches:].numpy(),
                                  x[:, cfg.num_patches:])


def test_patch_extras_share_pages_only_when_identical(rng):
    """One admission of three requests with one prompt: the two with the
    same patch embeddings share their prompt's pages (the chain keys are
    salted with the extras' digest) and decode the same tokens; the one
    with other embeddings shares no page."""
    eng, _ = _engines(LLAVA)
    cfg = eng.cfg
    prompt = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    ex = [serve.synth_extra_inputs(cfg, rng) for _ in range(2)]
    ceng = ContinuousBatchingEngine(eng, **dict(KW, capacity=3,
                                                max_prompt_len=32))
    reqs = [Request("a", prompt, 4, extra_inputs=ex[0]),
            Request("b", prompt.copy(), 4, extra_inputs=ex[1]),
            Request("c", prompt.copy(), 4, extra_inputs=dict(ex[0]))]
    done = {r.tenant: t for r, t in ceng.run_all(reqs)}
    assert ceng.prefill_calls == 1 and ceng.prefill_skips == 0
    assert ceng.kv.pages_shared == 2           # c on a's two prompt pages
    np.testing.assert_array_equal(done["c"], done["a"])
    # the embeddings change the prefill: pages shared across them would be
    # wrong
    logits = [eng.prefill(eng._make_batch(prompt[None], {
        "patch_embeds": e["patch_embeds"][None]}))[0] for e in ex]
    assert not torch.equal(*logits)
    for r in reqs:
        np.testing.assert_array_equal(done[r.tenant], _oracle(eng, ceng, r))
    ceng.assert_conserved()


def test_slot_batch_stacks_extras(rng):
    """The slot schedules stack a tenant batch's patch embeddings
    (``_batch_extras``): the overlapped tokens equal ``generate`` on each
    request alone with its own embeddings."""
    eng, _ = _engines(LLAVA)
    cfg = eng.cfg
    reqs = [Request("t", rng.integers(1, cfg.vocab_size, 12).astype(
        np.int32), 4, extra_inputs=serve.synth_extra_inputs(cfg, rng))
        for _ in range(3)]
    sched = MultiTenantScheduler(eng, max_batch=3, mode="overlapped")
    stacked = sched._batch_extras(reqs)
    assert stacked["patch_embeds"].shape == (3, cfg.num_patches, 1024)
    for r in reqs:
        sched.submit(r)
    got = [r.tokens.tolist() for r in sched.drain()]
    sched.close()
    want = [eng.generate(r.prompt[None], 4, extra_inputs={
        "patch_embeds": r.extra_inputs["patch_embeds"][None]}).tokens[0]
        .tolist() for r in reqs]
    assert len(got) == 3 and sorted(got) == sorted(want)


def test_synth_extra_inputs_match_reference():
    for arch in (LLAVA, "internlm2-1.8b"):
        for reduced in (False, True):
            cfg, jcfg = get_config(arch), jax_config(arch)
            if reduced:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            a = serve.synth_extra_inputs(cfg, np.random.default_rng(3))
            b = jserve.synth_extra_inputs(jcfg, np.random.default_rng(3))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_list_archs_rows_match_reference():
    """The port's capability table: each arch's row, whisper's among them,
    equals the reference's, the ``preempt`` column included; no model is
    built."""
    bufs = []
    for fn in (serve.main, jserve.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(["--list-archs"]) == 0
        bufs.append({ln.split()[0]: ln.split() for ln in
                     buf.getvalue().splitlines()[2:]})
    mine, ref = bufs
    assert set(mine) == set(ref) == set(ARCH_IDS)
    assert "whisper-base" in LM_ARCHS
    for arch in LM_ARCHS:
        a, b = mine[arch], ref[arch]
        assert a == b, arch
        assert a[3] == "yes"
    assert mine["whisper-base"][2] == "attn+cross"
