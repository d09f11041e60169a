"""The port's pure-SSM serving path against the JAX package's (reduced
mamba2: 2 layers, d_model 64, 16 heads x 8, N 16, chunk 16, float32).

Weights come from the reference's initialiser and cross as numpy through
``params_from_jax``; the reference's SSD scan runs as its Pallas kernel in
interpret mode (``kops.use_pallas(True)``, restored in a ``finally``) where
the mixer itself is compared, and as its jnp oracle elsewhere.  Outputs are
held at the SSD tolerance ``rtol = atol = 1e-4`` (the chunked scan sums in
another order than the reference's); tokens must be identical: ``generate``
greedy, and the continuous engine against the reference's continuous
engine and the port's own ``generate`` on the padded prompt.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import null_sharder
from repro.kernels import ops as jops
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan
from repro_torch.launch import serve
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, param_count, prepare_params
from repro_torch.models.transformer import init_lm
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import PagedKVCache, state_kinds
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

ARCH = "mamba2-2.7b"
SH = null_sharder()
TOL = dict(rtol=1e-4, atol=1e-4)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


@contextlib.contextmanager
def _pallas():
    jops.use_pallas(True)
    try:
        yield
    finally:
        jops.use_pallas(False)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, vals))
    return jcfg, cfg, vals, tp


@pytest.fixture(scope="module")
def engines(models):
    jcfg, cfg, vals, tp = models
    return ServingEngine(cfg, tp, device="cpu"), JaxEngine(jcfg, vals)


def test_configs_and_param_tree_match(models):
    """The config field for field (published and reduced), and the
    parameter tree at full width -- keys, shapes, dtypes (the meta device
    allocates nothing) -- with the mamba leaves converted unchanged."""
    jcfg, cfg, vals, tp = models
    for t, j in ((get_config(ARCH), jax_config(ARCH)), (cfg, jcfg)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.block_schedule() == j.block_schedule()
    shapes = jax.eval_shape(jax_build(jax_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = jax.tree.map(lambda b: b.value, shapes, is_leaf=jparams.is_boxed)
    got = init_lm(get_config(ARCH), 0, "meta")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == tuple(w.shape), k
        assert str(flat_g[k].dtype).split(".")[1] == str(w.dtype), k
    assert 2.6e9 < param_count(got) < 2.8e9          # ~2.70 B parameters
    m = tp["stages"]["sub0"]["mamba"]
    assert set(m) == {"in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
                      "d_skip", "norm_scale", "out_proj"}
    for k, v in m.items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(vals["stages"]["sub0"]["mamba"][k]))


@pytest.mark.parametrize("L", [16, 24])
def test_apply_ssm_matches_jax_pallas(models, L):
    """The mixer, output and returned state, against the reference's with
    its Pallas scan (L = 24 pads to two chunks of 16)."""
    jcfg, cfg, vals, tp = models
    sub_j = jax.tree.map(lambda a: a[0], vals["stages"]["sub0"]["mamba"])
    sub_t = {k: v[0] for k, v in tp["stages"]["sub0"]["mamba"].items()}
    x = np.random.default_rng(L).standard_normal(
        (2, L, cfg.d_model)).astype(np.float32)
    out_t, st_t = tssm.apply_ssm(sub_t, torch.from_numpy(x), cfg,
                                 return_state=True)
    with _pallas():
        out_j, st_j = jssm.apply_ssm(sub_j, jnp.asarray(x), jcfg, SH,
                                     return_state=True)
    _close(out_t, out_j)
    for k in ("ssm", "conv"):
        assert tuple(st_t[k].shape) == st_j[k].shape
        assert st_t[k].dtype == torch.float32
        _close(st_t[k], st_j[k])


def test_prefill_and_decode_match_jax(models):
    """Prefill logits and caches, then decode steps' logits and states."""
    jcfg, cfg, vals, tp = models
    jb, tb = jax_build(jcfg), build_model(cfg)
    tpp = prepare_params(cfg, tp)
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 24)).astype(np.int32)
    with _pallas():
        jl_, jc, jidx = jb.prefill_fn(vals, {"tokens": jnp.asarray(toks)}, SH)
    tl_, tc, tidx = tb.prefill_fn(tpp, {"tokens": torch.from_numpy(toks)})
    assert tidx == int(jidx) == 24
    _close(tl_, jl_)
    for k in ("ssm", "conv"):
        _close(tc["sub0"][k], jc["sub0"][k])
    rng = np.random.default_rng(1)
    for step in range(3):
        nt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl_, jc = jb.decode_fn(vals, jnp.asarray(nt), jc, jidx + step, SH)
        tl_, tc = tb.decode_fn(tpp, torch.from_numpy(nt), tc, tidx + step)
        _close(tl_, jl_)
    for k in ("ssm", "conv"):
        _close(tc["sub0"][k], jc["sub0"][k])


def test_generate_matches_jax(engines):
    eng, jeng = engines
    prompts = np.random.default_rng(2).integers(
        1, eng.cfg.vocab_size, (3, 16)).astype(np.int32)
    got = eng.generate(prompts, 8)
    want = jeng.generate(prompts, 8)
    assert got.tokens.shape == (3, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_continuous_matches_jax_and_generate(engines):
    """tests/test_continuous.py::test_continuous_token_exact_ssm_family:
    ragged prompts, capacity 2, more requests than slots -- the slot-table
    SSM state carries the whole cache; no page is allocated."""
    eng, jeng = engines
    rng = np.random.default_rng(3)
    reqs = [Request("a", rng.integers(1, eng.cfg.vocab_size,
                                      6 + 3 * i).astype(np.int32),
                    max_new_tokens=4 + i) for i in range(4)]
    kw = dict(capacity=2, page_size=8, inner_steps=3, max_prompt_len=32)
    ceng = ContinuousBatchingEngine(eng, **kw)
    jceng = JaxCont(jeng, backend="jnp", **kw)
    ssd_scan.reset_counts()
    got = {id(r): t for r, t in ceng.run_all(reqs)}
    want = {id(r): t for r, t in jceng.run_all(reqs)}
    assert ssd_scan.launch_counts["ssd_chunked"] == 0
    assert ssd_scan.plain_counts["ssd_chunked_plain"] == \
        ceng.prefill_calls * eng.cfg.num_layers
    for r in reqs:
        b = ceng.bucket_len(r.prompt.size)
        padded = np.zeros((1, b), np.int32)
        padded[0, b - r.prompt.size:] = r.prompt
        np.testing.assert_array_equal(got[id(r)], want[id(r)])
        np.testing.assert_array_equal(
            got[id(r)], eng.generate(padded, r.max_new_tokens).tokens[0])
    assert ceng.kv.pages_allocated == 0 and not ceng.prefix_sharing
    assert ceng.nonfinite_rows == 0
    ceng.kv.assert_conserved()


def test_supported_modes_and_state_kinds(engines):
    eng, jeng = engines
    mine = ContinuousBatchingEngine.supported_modes(eng.cfg)["continuous"]
    ref = JaxCont.supported_modes(jeng.cfg)["continuous"]
    assert mine["state_kinds"] == ref["state_kinds"] == ["ssm"]
    for k in ("supported", "prefix_sharing", "window_phase_keys",
              "exactness", "preemptable"):
        assert mine[k] == ref[k], k
    assert mine["preemptable"]
    assert [k.name for k in state_kinds(eng.cfg)] == ["ssm"]


def test_page_space_and_fair_share_without_attention(engines):
    """No attention sublayer: no page space.  blocks_for gives 0, nothing
    is allocated or registered, the audit holds, and the scheduler's
    fair-share accounting sees zero pages held and nobody over share."""
    eng, _ = engines
    kv = PagedKVCache(eng.cfg, capacity=3, page_size=8, max_blocks=4)
    assert kv.blocks_for(40) == 0
    assert kv.num_pages == PagedKVCache.RESERVED and kv.available() == 0
    assert kv.make_pools(2) == {}
    kv.assert_conserved()
    sched = MultiTenantScheduler(eng, mode="continuous", continuous=dict(
        capacity=2, page_size=8, inner_steps=2, max_prompt_len=32))
    rng = np.random.default_rng(4)
    for i in range(3):
        sched.submit(Request(f"t{i % 2}", rng.integers(
            1, eng.cfg.vocab_size, 10).astype(np.int32), 3))
    sched.step()
    held = sched._tenant_pages()
    assert sum(held.values()) == 0
    assert not any(sched._over_share(held).values())
    out = sched.drain()
    assert [r.outcome for r in out] == ["completed"] * 3


def test_launch_serve_cpu_end_to_end():
    seen = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--mode", "continuous",
                         "--requests", "5", "--tenants", "2",
                         "--prompt-len", "20", "--new-tokens", "6",
                         "--capacity", "2", "--shared-prefix-len", "8"],
                        observe=seen.append)
    assert rc == 0
    text = buf.getvalue()
    assert "arch=mamba2-2.7b-reduced" in text
    assert "served 5 requests (completed=5 rejected=0)" in text
    assert "nonfinite logit rows=0" in text
    assert "prefix sharing=off: pages allocated=0" in text
    eng = seen[0].continuous_engine
    assert eng.prefill_calls > 0 and eng.kv.pages_allocated == 0


def test_prepare_params_casts_once_and_ties_the_unembedding():
    """bf16 compute: the mamba leaves the reference casts at each use are
    cast once (a_log, dt_bias, d_skip, norm_scale stay float32), the tied
    unembedding is stored once as a contiguous float32 operand, and prefill
    logits are bit-identical to casting at every use."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="bfloat16")
    assert cfg.tie_embeddings
    bundle = build_model(cfg)
    raw = bundle.init(3)
    prep = prepare_params(cfg, raw)
    m = prep["stages"]["sub0"]["mamba"]
    for k in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert m[k].dtype == torch.bfloat16, k
    for k in ("a_log", "dt_bias", "d_skip", "norm_scale"):
        assert m[k].dtype == torch.float32, k
    w = prep["embed"]["unembed_f32"]
    assert w.dtype == torch.float32 and w.is_contiguous()
    assert tuple(w.shape) == (cfg.d_model, tl.pad_vocab(cfg.vocab_size))
    assert tl.unembed_operand(prep["embed"], cfg) is w
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))}
    a = bundle.prefill_fn(raw, toks)[0]
    b = bundle.prefill_fn(prep, toks)[0]
    assert torch.equal(a, b)
    assert b[:, cfg.vocab_size:].eq(tl.NEG_INF).all()
