"""The port's encoder-decoder model (whisper-base) against the JAX package's,
on the same weights.

Reduced whisper in float32 (2 + 2 layers, d_model 64, 16 encoder frames;
one case at 100 frames, so that the encoder crosses a ragged block edge),
weights from the reference's initialiser through ``params_from_jax``,
seeded numpy tokens and frames:

* the config field for field, and the parameter tree's layout at full
  width (shapes only);
* ``sinusoidal_positions`` and ``_sinusoid_at`` at atol 1e-6;
* ``encode``, ``precompute_cross_kv`` and ``apply_cross_attention`` at
  rtol = atol = 1e-5 (the encoder against the reference's layer functions
  composed as its ``encode`` composes them);
* ``prefill_fn``'s logits, self caches and cross caches, then 4
  ``decode_fn`` steps, at 1e-4;
* greedy ``generate`` token-exact with the reference's, with zero and with
  random frames;
* every prefill attention (encoder, decoder self, cross) through
  ``ops.flash_attention``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import null_sharder
from repro.models import layers as jl
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, param_count, prepare_params
from repro_torch.models.transformer import init_footprint, tree_map
from repro_torch.serving.engine import ServingEngine

ARCH = "whisper-base"
SH = null_sharder()
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _configs(s_enc=None):
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    if s_enc is not None:
        jcfg = dataclasses.replace(jcfg, encoder_seq_len=s_enc)
        cfg = dataclasses.replace(cfg, encoder_seq_len=s_enc)
    return jcfg, cfg


def _models(s_enc=None):
    """(port config, prepared port params, reference config, reference
    values) on the reference's weights, built once per frame count."""
    if s_enc not in _CACHE:
        jcfg, cfg = _configs(s_enc)
        vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
        tp = prepare_params(cfg, params_from_jax(
            cfg, jax.tree.map(np.asarray, vals)))
        _CACHE[s_enc] = (cfg, tp, jcfg, vals)
    return _CACHE[s_enc]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _stage(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _jax_encode(vals, frames, jcfg):
    """The reference's ``encode`` (``models/model.py:165-177``) written with
    its public layer functions, stage by stage."""
    x = frames.astype(jl.dtype_of(jcfg.compute_dtype))
    x = x + jl.sinusoidal_positions(x.shape[1], jcfg.d_model).astype(
        x.dtype)[None]
    for i in range(jcfg.num_encoder_layers):
        sp = _stage(vals["enc_stages"], i)
        x = x + jl.apply_attention(sp["attn"],
                                   jl.apply_rmsnorm(sp["norm1"], x), jcfg,
                                   SH, causal=False)
        x = x + jl.apply_mlp(sp["mlp"], jl.apply_rmsnorm(sp["norm2"], x),
                             jcfg, SH)
    return jl.apply_rmsnorm(vals["enc_norm"], x)


def test_config_equals_reference_field_for_field():
    for t, j in ((get_config(ARCH), jax_config(ARCH)),
                 _configs()[::-1]):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.block_schedule() == j.block_schedule()
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.num_encoder_layers, cfg.d_model,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.encoder_seq_len) == (6, 6, 512, 8, 8, 64,
                                                     2048, 51865, 1500)
    assert cfg.enc_dec and not cfg.use_rope


def test_param_tree_layout_matches_at_full_width():
    """The port's initialiser builds the reference's enc-dec tree -- keys,
    shapes, dtypes -- at the published width (the meta device allocates
    nothing); the footprint reckons that tree."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda b: b.value, shapes, is_leaf=jparams.is_boxed)
    got = build_model(cfg).init(0, "meta")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == tuple(w.shape), k
        assert str(flat_g[k].dtype).split(".")[1] == str(w.dtype), k
    n = sum(int(np.prod(w.shape)) for w in flat_w.values())
    assert param_count(got) == n
    weights, peak = init_footprint(cfg)
    assert weights == 4 * n                       # float32 parameters
    # the largest draw is the embedding's (padded vocab x d_model)
    assert peak == weights + 4 * tl.pad_vocab(cfg.vocab_size) * cfg.d_model


def test_params_from_jax_checks_the_enc_dec_tree():
    cfg, _, jcfg, vals = _models()
    tree = jax.tree.map(np.asarray, vals)
    params_from_jax(cfg, tree)
    bad = dict(tree, dec_stages=dict(tree["dec_stages"]))
    del bad["dec_stages"]["cross"]
    with pytest.raises(KeyError, match="dec_stages"):
        params_from_jax(cfg, bad)
    bad = dict(tree, enc_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="enc_norm/scale"):
        params_from_jax(cfg, bad)


@pytest.mark.parametrize("seq_len", [16, 100])
def test_sinusoids_match_jax(seq_len):
    _, cfg = _configs()
    d = cfg.d_model
    _close(tl.sinusoidal_positions(seq_len, d).numpy(),
           jl.sinusoidal_positions(seq_len, d), dict(rtol=0, atol=1e-6))
    pos = np.arange(seq_len, dtype=np.int32)[::-3].copy()
    # per-row positions (C, 1, 1), as a decode round reads them
    got = tmodel._sinusoid_at(torch.from_numpy(pos)[:, None, None], d)
    want = jmodel._sinusoid_at(jnp.asarray(pos)[:, None, None], d)
    assert tuple(got.shape) == want.shape == (pos.size, 1, d)
    _close(got.numpy(), want, dict(rtol=0, atol=1e-6))
    # a 0-d position, as the dense decode reads it
    got = tmodel._sinusoid_at(torch.tensor(int(pos[0])), d)
    want = jmodel._sinusoid_at(jnp.asarray(int(pos[0])), d)
    assert tuple(got.shape) == want.shape == (d,)
    _close(got.numpy(), want, dict(rtol=0, atol=1e-6))


@pytest.mark.parametrize("s_enc", [None, 100])
def test_encode_and_cross_attention_match_jax(s_enc, rng):
    cfg, tp, jcfg, vals = _models(s_enc)
    bundle = build_model(cfg)
    frames = rng.normal(size=(2, cfg.encoder_seq_len,
                              cfg.d_model)).astype(np.float32)
    enc = bundle.encode(tp, torch.from_numpy(frames))
    jenc = _jax_encode(vals, jnp.asarray(frames), jcfg)
    assert tuple(enc.shape) == jenc.shape
    _close(enc.numpy(), jenc)
    # every decoder layer's cross K/V, and the cross attention of a
    # prefill (16 queries, through ops.flash_attention) and of a decode
    # step (one query, naive_attention)
    ck, cv = bundle.cross_kv_all(tp, enc)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    for i in range(cfg.num_layers):
        sp, jsp = (tree_map(lambda a: a[i], tp["dec_stages"]),
                   _stage(vals["dec_stages"], i))
        k, v = tl.precompute_cross_kv(sp["cross"], enc, cfg)
        jk, jv = jl.precompute_cross_kv(jsp["cross"], jenc, jcfg, SH)
        _close(k.numpy(), jk)
        _close(v.numpy(), jv)
        assert torch.equal(ck[i], k) and torch.equal(cv[i], v)
        for sq, decode in ((16, False), (1, True)):
            got = tl.apply_cross_attention(sp["cross"],
                                           torch.from_numpy(x[:, :sq]),
                                           (k, v), cfg, decode=decode)
            want = jl.apply_cross_attention(jsp["cross"],
                                            jnp.asarray(x[:, :sq]),
                                            (jk, jv), jcfg, SH)
            _close(got.numpy(), want)


@pytest.mark.parametrize("s_enc", [None, 100])
def test_prefill_and_decode_match_jax(s_enc, rng):
    """Prefill logits, self caches and cross caches, then 4 decode steps,
    against the reference at 1e-4."""
    cfg, tp, jcfg, vals = _models(s_enc)
    jb, tb = jax_build(jcfg), build_model(cfg)
    toks = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    frames = rng.normal(size=(2, cfg.encoder_seq_len,
                              cfg.d_model)).astype(np.float32)
    jlog, jcache, jidx = jb.prefill_fn(
        vals, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        SH)
    tlog, tcache, tidx = tb.prefill_fn(
        tp, {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})
    assert tidx == int(jidx) == 16
    _close(tlog.numpy(), jlog, STEP_TOL)
    for kind, leaves in (("self", ("k", "v", "pos")), ("cross", ("k", "v"))):
        for leaf in leaves:
            got, want = tcache[kind][leaf], jcache[kind][leaf]
            assert tuple(got.shape) == want.shape, (kind, leaf)
            assert str(got.dtype).split(".")[1] == str(want.dtype)
            _close(got.float().numpy(), np.asarray(want, np.float32),
                   STEP_TOL)
    for step in range(4):
        nt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jb.decode_fn(vals, jnp.asarray(nt), jcache,
                                    jidx + step, SH)
        tlog, tcache = tb.decode_fn(tp, torch.from_numpy(nt), tcache,
                                    tidx + step)
        _close(tlog.numpy(), jlog, STEP_TOL)
    _close(tcache["self"]["k"].float().numpy(),
           np.asarray(jcache["self"]["k"], np.float32), STEP_TOL)


@pytest.mark.parametrize("frames", ["zero", "random"])
def test_generate_token_exact_with_reference(frames, rng):
    cfg, _, jcfg, vals = _models()
    eng = ServingEngine(cfg, params_from_jax(
        cfg, jax.tree.map(np.asarray, vals)), device="cpu")
    jeng = JaxEngine(jcfg, vals)
    prompts = rng.integers(1, cfg.vocab_size, (3, 16)).astype(np.int32)
    extra = None
    if frames == "random":
        extra = {"frames": rng.normal(size=(3, cfg.encoder_seq_len,
                                            cfg.d_model)).astype(np.float32)}
    else:
        # the request without frames: both engines' default zero frames
        extra = {"frames": np.zeros((3, cfg.encoder_seq_len, cfg.d_model),
                                    np.float32)}
    got = eng.generate(prompts, max_new_tokens=8, extra_inputs=extra).tokens
    want = np.asarray(jeng.generate(prompts, max_new_tokens=8,
                                    extra_inputs=extra).tokens)
    np.testing.assert_array_equal(got, want)
    if frames == "random":
        # the frames reach the decoder: zero frames give other logits
        logits = [eng.prefill(eng._make_batch(prompts, {"frames": f}))[0]
                  for f in (extra["frames"], np.zeros_like(extra["frames"]))]
        assert not torch.equal(*logits)


def test_every_prefill_attention_goes_through_ops(rng):
    """A prefill calls ``ops.flash_attention`` once per encoder layer and
    twice per decoder layer (self, causal; cross, non-causal at Sq != Skv);
    a decode step's cross attention calls it not at all."""
    cfg, tp, _, _ = _models()
    bundle = build_model(cfg)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (2, 16)).astype(np.int32))
    frames = torch.from_numpy(rng.normal(size=(
        2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    fa.reset_counts()
    logits, caches, idx = bundle.prefill_fn(tp, {"tokens": toks,
                                                 "frames": frames})
    assert fa.plain_counts["flash_attention_plain"] == \
        cfg.num_encoder_layers + 2 * cfg.num_layers
    bundle.decode_fn(tp, logits.argmax(-1)[:, None].to(torch.int32),
                     caches, idx)
    assert fa.plain_counts["flash_attention_plain"] == \
        cfg.num_encoder_layers + 2 * cfg.num_layers
    assert fa.launch_counts["flash_attention"] == 0
