"""The port's training path against the JAX package's, on the same weights
and the same seeded numpy batches (CPU: the kernel wrappers take their
plain versions).

* ``loss_fn`` (loss, xent and aux) at rtol 1e-5 and the gradient of every
  parameter leaf against ``jax.grad`` of the reference's loss through
  ``params_from_jax``: reduced internlm2 here, the other archs in
  tests/test_torch_train_archs.py.  Attention
  leaves (wq, wk, wv, wo, q_norm, k_norm) at 2e-3, the rest at 1e-4, each
  leaf's absolute part that tolerance times its largest |grad|;
* (the autograd Functions against the reference's custom VJPs:
  tests/test_torch_train_functions.py)
* ``build_train_step``: 4 tenant microbatches against 1 (loss 2e-3 and
  params 5e-3 as tests/test_system.py holds the reference, grads at
  1e-5), the loss falling on reduced internlm2 (30 steps at lr 5e-3),
  restart bit-exactness after a checkpoint, ``run_with_recovery``
  (tests/test_checkpoint.py's cases) and the metrics' names;
* remat ``full`` and ``dots`` give the gradients of ``none``;
* ``grad_compression`` against the reference's; ``launch.train.main``
  reduced on the CPU (``param_axes`` and ``input_specs``: tests/
  test_torch_params.py).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import null_sharder
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.training import grad_compression as jgc
from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig, synth_batch
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault import run_with_recovery
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.training import grad_compression as tgc
from repro_torch.training.optimizer import Optimizer, make_optimizer
from repro_torch.training.train_loop import (build_eval_step,
                                             build_train_step,
                                             init_train_state)

ATTN_LEAVES = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
ATTN_TOL, OTHER_TOL = 2e-3, 1e-4


def _leaf_items(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def hold_loss_and_grads(arch: str, batch_shape=(2, 32)) -> None:
    """loss_fn and every leaf's grad of reduced ``arch`` against the
    reference's on its own initial weights."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jb = jax_build(jcfg)
    jp, _ = jparams.split(jb.init(jax.random.PRNGKey(0)))
    nb = synth_batch(DataConfig(*batch_shape, cfg.vocab_size), 0, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jb.loss_fn(p, jbatch, null_sharder()), has_aux=True))(jp)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    leaves = [t.requires_grad_() for _, t in _leaf_items(tp)]
    loss, m = build_model(cfg).loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in nb.items()})
    grads = torch.autograd.grad(loss, leaves)
    loss, m = loss.detach(), {k: v.detach() for k, v in m.items()}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)
    for (path, _), g in zip(_leaf_items(tp), grads):
        want = np.asarray(_get(jg, path), np.float32)
        tol = ATTN_TOL if path.split("/")[-1] in ATTN_LEAVES else OTHER_TOL
        np.testing.assert_allclose(
            g.float().numpy(), want, rtol=tol,
            atol=tol * float(np.abs(want).max()), err_msg=path)


def test_loss_and_grads_match_reference():
    hold_loss_and_grads("internlm2-1.8b")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _capture(opt: Optimizer, store: list) -> Optimizer:
    def update(grads, state, params, lr):
        store.append({k: v for k, v in _leaf_items(grads)})
        return opt.update(grads, state, params, lr)
    return Optimizer(opt.init, update, opt.state_axes)


def test_microbatch_tenancy_matches_single_shot():
    cfg1 = get_config("internlm2-1.8b").reduced()
    cfg4 = dataclasses.replace(cfg1, microbatches=4)
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(
        DataConfig(8, 32, cfg1.vocab_size), 0).items()}
    init = build_model(cfg1).init(0, "cpu")
    out = {}
    for cfg in (cfg1, cfg4):
        bundle = build_model(cfg)
        grads: list = []
        opt = _capture(make_optimizer(cfg), grads)
        params = jax.tree.map(lambda t: t.clone(), init)
        state = init_train_state(bundle, opt, params)
        state, m = build_train_step(
            bundle, None, opt, lr_fn=lambda s: torch.tensor(1e-3))(state,
                                                                   batch)
        assert sorted(m) == ["aux", "grad_norm", "loss", "lr", "xent"]
        out[cfg.microbatches] = (float(m["loss"]), grads[0], state)
    (l1, g1, s1), (l4, g4, s4) = out[1], out[4]
    assert abs(l1 - l4) < 2e-3
    for k in g1:
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g1[k].abs().max()))
    for (_, a), (_, b) in zip(_leaf_items(s1["params"]),
                              _leaf_items(s4["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-3, atol=5e-3)
    assert int(s1["step"]) == int(s4["step"]) == 1


def test_lm_trains_and_loss_falls():
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              microbatches=2)
    bundle = build_model(cfg)
    opt = make_optimizer(cfg)
    state = init_train_state(bundle, opt, bundle.init(0, "cpu"))
    step = build_train_step(bundle, None, opt,
                            lr_fn=lambda s: torch.tensor(5e-3))
    dc = DataConfig(8, 32, cfg.vocab_size)
    losses = []
    for i in range(30):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in synth_batch(dc, i).items()})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    ev = build_eval_step(bundle)(state["params"], {
        k: torch.from_numpy(v) for k, v in synth_batch(dc, 99).items()})
    assert np.isfinite(float(ev["loss"])) and ev["loss"].grad_fn is None


def _h2o_setup():
    cfg = get_config("h2o-danube-1.8b").reduced()
    bundle = build_model(cfg)
    opt = make_optimizer(cfg)
    step = build_train_step(bundle, None, opt)
    dc = DataConfig(4, 16, cfg.vocab_size)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in synth_batch(dc, i).items()}

    def fresh():
        return init_train_state(bundle, opt, bundle.init(0, "cpu"))
    return step, batch, fresh


def test_train_checkpoint_restart_bitexact(tmp_path):
    """Save after step 3, restore, continue: the same state as an
    uninterrupted run (tests/test_system.py's case)."""
    step, batch, fresh = _h2o_setup()

    def advance(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, batch(i))
        return state

    ref = advance(fresh(), 0, 6)
    mid = advance(fresh(), 0, 3)
    ckpt.save(tmp_path, 3, mid)
    final = advance(ckpt.restore(tmp_path, 3, mid), 3, 6)
    for path, a in _leaf_items(ref["params"]):
        np.testing.assert_allclose(a.detach().numpy(),
                                   _get(final["params"], path).detach().numpy(),
                                   atol=1e-6)
    assert int(final["step"]) == 6


def test_run_with_recovery_restarts_and_matches_uninterrupted(tmp_path):
    """A failure injected at step 4 of 6 (checkpoints every 2): restored
    from step 4, the final parameters equal an uninterrupted run's."""
    step, batch, fresh = _h2o_setup()
    ref = fresh()
    for i in range(6):
        ref, _ = step(ref, batch(i))
    crashed = {"done": False}

    def step_fn(state, i):
        if i == 4 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected device loss")
        return step(state, batch(i))[0]

    rep = run_with_recovery(step_fn, fresh(), 6, tmp_path, save_every=2,
                            max_failures=2)
    assert (rep.steps_done, rep.failures, rep.restarts) == (6, 1, [4])
    final = ckpt.restore(tmp_path, 6, ref)
    for path, a in _leaf_items(ref["params"]):
        np.testing.assert_allclose(a.detach().numpy(),
                                   _get(final["params"], path).numpy(),
                                   atol=1e-6)


def test_run_with_recovery_reference_cases(tmp_path):
    """tests/test_checkpoint.py's two cases: restart at 7 from 5, and a
    permanent failure given up on."""
    crashed = {"done": False}

    def step_fn(state, i):
        if i == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected device loss")
        return {"x": state["x"] + 1.0}

    state = {"x": torch.tensor(0.0)}
    rep = run_with_recovery(step_fn, state, num_steps=10,
                            ckpt_dir=tmp_path / "a", save_every=5,
                            max_failures=2)
    assert (rep.steps_done, rep.failures, rep.restarts) == (10, 1, [7])
    assert float(ckpt.restore(tmp_path / "a", 10, state)["x"]) == 10.0

    def perma(state, i):
        if i >= 3:
            raise RuntimeError("permafail")
        return state

    ckpt.save(tmp_path / "b", 3, {"x": torch.tensor(0.0)})
    with pytest.raises(RuntimeError):
        run_with_recovery(perma, {"x": torch.tensor(0.0)}, 10, tmp_path / "b",
                          save_every=100, max_failures=2)


# ---------------------------------------------------------------------------
# gradient compression, axes, the entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 33), 64),
                                         ((4, 256), 256)])
def test_grad_compression_matches_reference(shape, block):
    rng = np.random.default_rng(7)
    g = rng.standard_normal(shape).astype(np.float32)
    r = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    jq, js = jgc.quantize_int8(jnp.asarray(g), block)
    tq, ts = tgc.quantize_int8(torch.from_numpy(g), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        tgc.dequantize_int8(tq, ts, shape).numpy(),
        np.asarray(jgc.dequantize_int8(jq, js, shape)), rtol=1e-7)
    jq2, js2, jr = jgc.compress_with_feedback(jnp.asarray(g), jnp.asarray(r),
                                              block)
    tq2, ts2, tr = tgc.compress_with_feedback(torch.from_numpy(g),
                                              torch.from_numpy(r), block)
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-7)
    tree = {"a": g, "b": {"c": g[..., :1] * 3}}
    jg_, jr_ = jgc.compressed_grad_tree(
        jax.tree.map(jnp.asarray, tree),
        jgc.init_residuals(jax.tree.map(jnp.asarray, tree)), block)
    ttree = jax.tree.map(torch.from_numpy, tree)
    tg_, tr_ = tgc.compressed_grad_tree(ttree, tgc.init_residuals(ttree),
                                        block)
    for path, w in _leaf_items(jax.tree.map(np.asarray, jg_)):
        np.testing.assert_allclose(_get(tg_, path).numpy(), w, rtol=1e-7)
    for path, w in _leaf_items(jax.tree.map(np.asarray, jr_)):
        np.testing.assert_allclose(_get(tr_, path).numpy(), w, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(remat):
    """A checkpointed stage (``full``) or one keeping only its matmul
    outputs (``dots``) recomputes in the backward and gives the same
    loss and gradients as no remat (reduced olmoe: attention, MoE aux)."""
    base = get_config("olmoe-1b-7b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in synth_batch(
        DataConfig(2, 16, base.vocab_size), 0).items()}
    init = build_model(base).init(0, "cpu")
    out = {}
    for r in ("none", remat):
        cfg = dataclasses.replace(base, remat=r)
        params = jax.tree.map(lambda t: t.clone().requires_grad_(), init)
        fa.reset_counts()
        loss, m = build_model(cfg).loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in _leaf_items(params)])
        out[r] = (float(loss.detach()), float(m["aux"].detach()), grads,
                  fa.plain_counts["flash_attention_plain"])
    (l0, a0, g0, n0), (l1, a1, g1, n1) = out["none"], out[remat]
    assert (l1, a1) == (l0, a0) and a0 > 0
    assert n1 == 2 * n0                  # the forward, then the recompute
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_launch_train_reduced_on_the_cpu(tmp_path, capsys):
    rc = train_cli.main(["--arch", "internlm2-1.8b", "--reduced", "--device",
                         "cpu", "--steps", "4", "--batch", "4", "--seq",
                         "16", "--ckpt-dir", str(tmp_path), "--save-every",
                         "2", "--log-every", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = out["train"]
    assert res["steps"] == res["final_step"] == 4
    assert np.isfinite(res["losses"]).all() and res["peak_mem_gb"] is None
    assert res["step_ms_by"] == "host clock"
    assert ckpt.available_steps(tmp_path) == [2, 4]


def test_launch_train_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--reduced", "--steps", "1"])
