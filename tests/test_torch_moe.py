"""The port's MoE serving path against the JAX package's (reduced olmoe: 2
layers, d_model 64, 4 heads / 2 kv heads x 16 with qk-norm, 4 experts top-2
with d_ff 64, routing groups of 32, float32).

Weights come from the reference's initialiser and cross as numpy through
``params_from_jax``; inputs are drawn with numpy from a seed (olmoe's
prefill and decode logits are held in ``tests/test_torch_lm.py`` with the
other archs).  MoE outputs
and the aux/z losses are held at ``rtol = 1e-5`` (``atol = 1e-6``): the
same routing on the same float32 router logits, and expert products summed
in another order.  Routing metadata (ids, positions, keep) must be equal.
Tokens must be identical: ``generate`` against the reference's ``generate``
on the same batch, and the continuous engine against the reference's
continuous engine on the same schedule -- capacity routing couples rows, so
engine against engine on identical admissions is the contract, not
engine against ``generate``.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ArchConfig as JaxArch
from repro.configs import MoEConfig as JaxMoE
from repro.configs import get_config as jax_config
from repro.distributed.sharding import null_sharder
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import ArchConfig, MoEConfig, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, prepare_params
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import Request

ARCH = "olmoe-1b-7b"
SH = null_sharder()
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def _moe_cfgs(E=4, k=2, cf=8.0, gs=64, shared=0):
    """tests/test_moe.py::_cfg in both packages."""
    kw = dict(name="moe-test", family="moe", num_layers=2, d_model=32,
              num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0,
              vocab_size=128, moe_period=1, param_dtype="float32",
              compute_dtype="float32")
    mk = dict(num_experts=E, top_k=k, d_ff_expert=16,
              num_shared_experts=shared, capacity_factor=cf, group_size=gs)
    return (ArchConfig(moe=MoEConfig(**mk), **kw),
            JaxArch(moe=JaxMoE(**mk), **kw))


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


# (E, k, capacity factor, group size, B, S, shared experts): tests/test_moe.py's
# ample-capacity cases, its drop case, a token count that is no multiple of
# the group size (the group halves until it divides), and a shared expert
# (also under llama4's top-1 routing)
@pytest.mark.parametrize("E,k,cf,gs,B,S,shared", [
    (4, 1, 4.0, 64, 2, 16, 0),
    (4, 2, 4.0, 64, 2, 16, 0),
    (8, 4, 8.0, 64, 2, 16, 0),
    (4, 2, 0.25, 64, 2, 32, 0),       # capacity 8 of 32 choices: drops
    (4, 2, 1.25, 16, 2, 12, 0),       # T 24: groups of 8
    (4, 2, 1.0, 64, 1, 8, 1),
    # llama4's routing: top-1 of many experts at its capacity factor, with
    # drops, beside one shared expert
    (16, 1, 1.25, 64, 2, 32, 1),
])
def test_apply_moe_matches_jax(E, k, cf, gs, B, S, shared):
    cfg, jcfg = _moe_cfgs(E=E, k=k, cf=cf, gs=gs, shared=shared)
    params, _ = jparams.split(jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    x = np.random.default_rng(1).standard_normal((B, S, 32)).astype(
        np.float32)
    y, losses = jmoe.apply_moe(params, jnp.asarray(x), jcfg, SH)
    ty, tlosses = tmoe.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(ty.numpy(), y)
    assert set(tlosses) == set(losses) == {"moe_aux", "moe_z"}
    for name in losses:
        _close(tlosses[name].numpy(), losses[name])
    gsz, G, cap = tmoe.group_shape(B * S, cfg.moe)
    assert G * gsz == B * S and (B * S) % gsz == 0
    if cf < 1.0:
        assert cap * E < gsz * k          # some choices are dropped


def test_routing_metadata_equal():
    """ids, gates, positions in expert, keep and the losses of ``_routing``
    on the same float32 logits, with drops."""
    _, jcfg = _moe_cfgs(E=4, k=2)
    cfg, _ = _moe_cfgs(E=4, k=2)
    logits = np.random.default_rng(2).standard_normal((3, 16, 4)).astype(
        np.float32)
    want = jmoe._routing(jnp.asarray(logits), jcfg.moe, 5)
    got = tmoe._routing(torch.from_numpy(logits), cfg.moe, 5)
    for g, w in zip(got[:1] + got[2:4], want[:1] + want[2:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[3].all()                # capacity 5 of 8 per expert
    for g, w in (got[1], want[1]), (got[4], want[4]), (got[5], want[5]):
        _close(g.numpy(), w)


def test_moe_layer_on_reduced_olmoe_matches_jax(models):
    jcfg, cfg, vals, tp = models
    sub_j = jax.tree.map(lambda a: a[1], vals["stages"]["sub0"]["moe"])
    sub_t = {k: v[1] for k, v in tp["stages"]["sub0"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal((4, 24, 64)).astype(
        np.float32)
    y, losses = jmoe.apply_moe(sub_j, jnp.asarray(x), jcfg, SH)
    ty, tlosses = tmoe.apply_moe(sub_t, torch.from_numpy(x), cfg)
    _close(ty.numpy(), y)
    for name in losses:
        _close(tlosses[name].numpy(), losses[name])


def test_generate_matches_jax(engines):
    eng, jeng = engines
    prompts = np.random.default_rng(2).integers(
        1, eng.cfg.vocab_size, (3, 16)).astype(np.int32)
    got = eng.generate(prompts, 8)
    want = jeng.generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_continuous_matches_jax_engine(engines):
    """Same admissions, same schedule: the port's continuous engine and the
    reference's (``backend="jnp"``) emit the same tokens and keep the same
    page accounting -- through batched admission, a shared system prompt
    with copy-on-write forks, a prefill-skipping repeat, churn and ragged
    prompts; the decode's masked rows compete for expert capacity in both."""
    eng, jeng = engines
    V = eng.cfg.vocab_size
    rng = np.random.default_rng(37)
    sys_prompt = rng.integers(1, V, 16).astype(np.int32)
    mk = lambda t: Request(f"t{t}", np.concatenate(
        [sys_prompt, rng.integers(1, V, 8).astype(np.int32)]),
        max_new_tokens=6)
    wave = [mk(t) for t in range(3)]
    batches = [wave, [Request("t0", wave[0].prompt.copy(), max_new_tokens=6)],
               [Request("x", rng.integers(1, V, 32).astype(np.int32),
                        max_new_tokens=2) for _ in range(5)],
               [Request(f"r{i}", rng.integers(1, V, 5 + 7 * i).astype(
                   np.int32), max_new_tokens=3 + 4 * i) for i in range(4)]]
    kw = dict(capacity=3, page_size=8, inner_steps=4, max_prompt_len=32)
    ceng = ContinuousBatchingEngine(eng, **kw)
    jceng = JaxCont(jeng, backend="jnp", **kw)
    pa.reset_counts()
    fa.reset_counts()
    for batch in batches:
        got = {id(r): t for r, t in ceng.run_all(batch)}
        want = {id(r): t for r, t in jceng.run_all(batch)}
        assert len(got) == len(batch)
        for r in batch:
            np.testing.assert_array_equal(got[id(r)], want[id(r)])
        kv, jkv = ceng.kv, jceng.kv
        assert (kv.pages_allocated, kv.pages_reused, kv.pages_shared,
                kv.cow_forks, kv.pristine_forks, ceng.prefill_calls,
                ceng.prefill_skips) == (
            jkv.pages_allocated, jkv.pages_reused, jkv.pages_shared,
            jkv.cow_forks, jkv.pristine_forks, jceng.prefill_calls,
            jceng.prefill_skips)
    assert ceng.kv.pages_shared > 0 and ceng.prefill_skips >= 1
    assert ceng.nonfinite_rows == 0
    ceng.kv.assert_conserved()
    assert fa.plain_counts["flash_attention_plain"] == \
        ceng.prefill_calls * eng.cfg.num_layers
    assert not any(fa.launch_counts.values())
    assert not any(pa.launch_counts.values())


def test_supported_modes_say_statistical(engines):
    eng, jeng = engines
    mine = ContinuousBatchingEngine.supported_modes(eng.cfg)["continuous"]
    ref = JaxCont.supported_modes(jeng.cfg)["continuous"]
    assert mine["exactness"] == ref["exactness"] == "statistical"
    for k in ("supported", "state_kinds", "prefix_sharing",
              "window_phase_keys"):
        assert mine[k] == ref[k], k
    dense = ContinuousBatchingEngine.supported_modes(
        get_config("internlm2-1.8b"))["continuous"]
    assert dense["exactness"] == "bitwise"


def test_prepare_params_casts_experts_once_keeps_the_router():
    """bf16 compute: the experts are cast once, the router stays float32,
    and prefill logits are bit-identical to casting at every use."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="bfloat16")
    bundle = build_model(cfg)
    raw = bundle.init(3)
    prep = prepare_params(cfg, raw)
    m = prep["stages"]["sub0"]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        assert m[k].dtype == torch.bfloat16, k
    assert m["router"].dtype == torch.float32
    assert m["router"] is raw["stages"]["sub0"]["moe"]["router"]
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 16)).astype(np.int32))}
    assert torch.equal(bundle.prefill_fn(raw, toks)[0],
                       bundle.prefill_fn(prep, toks)[0])


def test_params_from_jax_carries_the_moe_leaves(models):
    jcfg, cfg, vals, tp = models
    moe = tp["stages"]["sub0"]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down"}
    assert tuple(moe["w_gate"].shape) == (cfg.num_layers, 4, 64, 64)
    np.testing.assert_array_equal(
        moe["router"].numpy(), np.asarray(vals["stages"]["sub0"]["moe"][
            "router"]))
    tree = jax.tree.map(np.asarray, vals)
    bad = jax.tree.map(lambda a: a, tree)
    bad["stages"]["sub0"]["moe"]["router"] = \
        tree["stages"]["sub0"]["moe"]["router"].astype(np.float64)
    with pytest.raises(TypeError, match="router"):
        params_from_jax(cfg, bad)
    bad["stages"]["sub0"]["moe"]["router"] = \
        tree["stages"]["sub0"]["moe"]["router"][..., :3]
    with pytest.raises(ValueError, match="router"):
        params_from_jax(cfg, bad)


def test_launch_serve_cpu_end_to_end():
    seen = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--mode", "continuous",
                         "--requests", "5", "--tenants", "2",
                         "--prompt-len", "12", "--new-tokens", "6",
                         "--capacity", "3", "--shared-prefix-len", "16"],
                        observe=seen.append)
    assert rc == 0
    text = buf.getvalue()
    assert "arch=olmoe-1b-7b-reduced" in text
    assert "served 5 requests (completed=5 rejected=0)" in text
    assert "nonfinite logit rows=0" in text
    eng = seen[0].continuous_engine
    assert eng.prefill_calls > 0 and eng.kv.pages_shared > 0
    eng.kv.assert_conserved()
