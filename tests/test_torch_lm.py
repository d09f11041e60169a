"""The port's decoder-only LM against the JAX package's, on the same weights.

Weights come from the reference's own initialiser (``jax.random``), cross to
the port as numpy through ``models.convert.params_from_jax``, and both
models run the same seeded tokens.  Held at rtol/atol 1e-5 in float32
(reduced configs): prefill and decode logits of internlm2 (plain GQA),
h2o-danube (sliding window: window-clipped caches, a ring that wraps),
qwen3 (per-head qk-norm), olmoe (qk-norm, every MLP a top-k routed MoE
with capacity), mistral-large (dense), jamba (Mamba-2 and attention layers,
MoE every other layer), llama4 (routed experts beside a shared one) and
llava (patch embeddings merged into the prompt), the layer library and the
attention primitives.
The configs and the parameter tree's layout are compared at full width
(shapes only: JAX's ``eval_shape``, the port's meta device).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.distributed.sharding import null_sharder
from repro.models import attention_core as jac
from repro.models import layers as jl
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro_torch.configs import ARCH_IDS, PORTED_ARCHS, get_config
from repro_torch.models import attention_core as tac
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, param_count, prepare_params
from repro_torch.models.transformer import (_stack, init_lm, init_stage,
                                            tree_map)

ARCHS = ("internlm2-1.8b", "h2o-danube-1.8b", "qwen3-32b", "olmoe-1b-7b",
         "mistral-large-123b", "jamba-1.5-large-398b",
         "llama4-maverick-400b-a17b", "llava-next-mistral-7b")
SH = null_sharder()
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def _jax_params(cfg):
    vals, _ = jparams.split(jax_build(cfg).init(jax.random.PRNGKey(0)))
    return vals


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_for_field(arch):
    for t, j in ((get_config(arch), jax_config(arch)),
                 (get_config(arch).reduced(), jax_config(arch).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.block_schedule() == j.block_schedule()
        assert t.stage_period == j.stage_period


def test_registry_and_unported_archs():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        if arch in PORTED_ARCHS:
            assert get_config(arch).name == jax_config(arch).name
        else:
            with pytest.raises(NotImplementedError, match="slice 4"):
                get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_layout_matches_at_full_width(arch):
    """The port's initialiser builds the reference's tree -- keys, shapes,
    dtypes -- at the published width (the meta device allocates nothing)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda b: b.value, shapes,
                        is_leaf=jparams.is_boxed)
    got = init_lm(cfg, 0, "meta")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == tuple(w.shape), k
        assert str(flat_g[k].dtype).split(".")[1] == str(w.dtype), k
    assert param_count(got) == sum(int(np.prod(w.shape))
                                   for w in flat_w.values())


def test_params_from_jax_checks_keys_and_shapes():
    cfg = get_config("internlm2-1.8b").reduced()
    tree = jax.tree.map(np.asarray, _jax_params(jax_config(
        "internlm2-1.8b").reduced()))
    params_from_jax(cfg, tree)
    bad = dict(tree, embed=dict(tree["embed"]))
    del bad["embed"]["unembed"]
    with pytest.raises(KeyError, match="embed"):
        params_from_jax(cfg, bad)
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_jax(cfg, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals = _jax_params(jcfg)
    jb, tb = jax_build(jcfg), build_model(cfg)
    tp = prepare_params(cfg, params_from_jax(
        cfg, jax.tree.map(np.asarray, vals)))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, (2, 24)).astype(np.int32)
    extra = {}
    if cfg.num_patches:                      # llava: merged patch embeddings
        extra["patch_embeds"] = rng.normal(
            size=(2, cfg.num_patches, 1024)).astype(np.float32)
    jl_, jcache, jidx = jb.prefill_fn(vals, {"tokens": jnp.asarray(toks), **{
        k: jnp.asarray(v) for k, v in extra.items()}}, SH)
    tl_, tcache, tidx = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                           **{k: torch.from_numpy(v)
                                              for k, v in extra.items()}})
    assert tidx == int(jidx) == 24
    assert tl_.dtype == torch.float32 and tuple(tl_.shape) == jl_.shape
    _close(tl_.numpy(), jl_)
    for step in range(3):                    # SWA: the ring wraps at once
        nt = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl_, jcache = jb.decode_fn(vals, jnp.asarray(nt), jcache,
                                   jidx + step, SH)
        tl_, tcache = tb.decode_fn(tp, torch.from_numpy(nt), tcache,
                                   tidx + step)
        _close(tl_.numpy(), jl_)
    for name, sub in tcache.items():
        if "pos" not in sub:                 # a Mamba-2 sublayer's state
            for k, a in sub.items():
                _close(a.float().numpy(), np.asarray(jcache[name][k],
                                                     np.float32))
            continue
        np.testing.assert_array_equal(sub["pos"].numpy(),
                                      np.asarray(jcache[name]["pos"]))
        for kind in ("k", "v"):
            np.testing.assert_allclose(
                sub[kind].float().numpy(),
                np.asarray(jcache[name][kind].astype(jnp.float32)),
                rtol=1e-2, atol=1e-2)        # one bf16 ulp either way


def test_prepared_params_give_the_same_numbers():
    """Casting the compute leaves once (prepare_params) equals the
    reference's cast at every use, in bf16 compute too."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              compute_dtype="bfloat16")
    bundle = build_model(cfg)
    raw = bundle.init(3)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))}
    a = bundle.prefill_fn(raw, toks)[0]
    b = bundle.prefill_fn(prepare_params(cfg, raw), toks)[0]
    assert torch.equal(a, b)
    assert b[:, cfg.vocab_size:].eq(tl.NEG_INF).all()


def test_layer_library_matches_jax():
    cfg, jcfg = get_config("qwen3-32b").reduced(), jax_config(
        "qwen3-32b").reduced()
    vals = _jax_params(jcfg)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, vals))
    sub_j = jax.tree.map(lambda a: a[0], vals["stages"]["sub0"])
    sub_t = jax.tree.map(lambda a: a[0], tp["stages"]["sub0"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tl.apply_rmsnorm(sub_t["norm1"], xt).numpy(),
           jl.apply_rmsnorm(sub_j["norm1"], xj))
    _close(tl.apply_mlp(sub_t["mlp"], xt, cfg).numpy(),
           jl.apply_mlp(sub_j["mlp"], xj, jcfg, SH))
    _close(tl.apply_attention(sub_t["attn"], xt, cfg).numpy(),
           jl.apply_attention(sub_j["attn"], xj, jcfg, SH))
    h = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos2 = rng.integers(0, 500, (2, 12)).astype(np.int32)
    for pos in (np.arange(12, dtype=np.int32), pos2):
        _close(tl.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                             1e4).numpy(),
               jl.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e4))
    _close(tl.rope_frequencies(16, 1e6).numpy(), jl.rope_frequencies(16, 1e6))
    tok = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    _close(tl.apply_embedding(tp["embed"], torch.from_numpy(tok),
                              cfg).numpy(),
           jl.apply_embedding(vals["embed"], jnp.asarray(tok), jcfg, SH))
    _close(tl.apply_unembed(tp["embed"], xt, cfg).numpy(),
           jl.apply_unembed(vals["embed"], xj, jcfg, SH))
    for v in (1, 255, 256, 92544):
        assert tl.pad_vocab(v) == jl.pad_vocab(v)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_attention_primitives_match_jax(causal, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 24, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(tac.naive_attention(tq, tk, tv, causal=causal,
                               window=window).numpy(),
           jac.naive_attention(jq, jk, jv, causal=causal, window=window))
    # blocks smaller than the sequence: the online softmax across blocks
    _close(tac.blockwise_attention(tq, tk, tv, causal=causal, window=window,
                                   block_q=8, block_kv=8).numpy(),
           jac.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=8, block_kv=8))
    _close(tac.blockwise_attention(tq, tk, tv, causal=causal,
                                   window=window).numpy(),
           tac.naive_attention(tq, tk, tv, causal=causal,
                               window=window).numpy())


@pytest.mark.parametrize("arch,piece", [
    ("internlm2-1.8b", None), ("mamba2-2.7b", None), ("olmoe-1b-7b", None),
    ("jamba-1.5-large-398b", None),
    # every leaf over 1,000 elements drawn in pieces, as a 400 B arch's are
    ("jamba-1.5-large-398b", 1000)])
def test_init_lm_in_place_draws_are_bit_identical(arch, piece, monkeypatch):
    """``init_lm`` allocates each stacked leaf once and draws each stage's
    leaves straight into their slices: the same bits, from the same
    generator in the same order, as drawing the stages one by one and
    stacking them -- with leaves drawn in pieces too."""
    if piece is not None:
        monkeypatch.setattr(tl, "DRAW_PIECE", piece)
    cfg = get_config(arch).reduced()
    n_stages = cfg.num_layers // cfg.stage_period
    gen = torch.Generator().manual_seed(5)
    tl.init_embedding(gen, cfg, None)             # drawn first in both
    old = _stack([init_stage(gen, cfg, None) for _ in range(n_stages)])
    new = init_lm(cfg, 5)["stages"]
    flat_old, flat_new = [], []
    tree_map(flat_old.append, old)
    tree_map(flat_new.append, new)
    assert len(flat_new) == len(flat_old) > 0
    for a, b in zip(flat_new, flat_old):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.is_contiguous()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
