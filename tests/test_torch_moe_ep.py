"""The port's expert-parallel MoE against the JAX package's own
``apply_moe_ep`` and its sharded train step.

The reference runs in one module-scoped subprocess with eight host devices
(``XLA_FLAGS`` set before ``jax`` is imported) on meshes built with
``axis_types=(AxisType.Auto,) * 2``: ``apply_moe_ep`` (forward, aux, z and
the gradients of ``sum(y^2) + aux + z``) on tests/test_moe_ep.py's
configuration (8 experts top-2, d_model 32) at (2, 4) with its capacity
factor 8 and at the published 1.25 (choices dropped) at (2, 4) and (1, 2);
and one ``jax.jit(build_train_step(bundle, Sharder(mesh, fsdp=True),
opt))`` step of reduced olmoe-1b-7b with ``dispatch="ep"`` at 2x4.  The
port runs in-process on meshes of ``torch.device("cpu")`` repeated.

* the layer at tests/test_torch_moe.py's tolerance (rtol 1e-5, atol
  1e-6): the same routing, the same capacity buckets, the exchange's sums
  in another order;
* ``_capacity_scatter`` bit for bit (``pos``, ``keep`` and the buffer,
  with drops and with an invalid-row mask);
* dispatch selection: ``"ep"`` with no mesh, with S, B or E the mesh does
  not divide, or M = 1, is the scatter path bit for bit;
  ``REPRO_MOE_DISPATCH`` overrides the config both ways;
* EP against the scatter path within tests/test_moe_ep.py's own bounds;
* reduced olmoe's EP step against the reference's: loss and grad norm at
  rtol 1e-5, parameters at rtol = atol = 5e-3 (tests/test_torch_train.py's
  step tolerance);
* ``dropped_log``: the scatter path's count is its routing's dropped
  choices; EP with one expert a shard drops none at factor 8, with two it
  drops choices (the reference counts empty exchange slots into local
  expert 0's capacity), and the layer stays within the reference's own
  scatter bound either way.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ArchConfig as JaxArch
from repro.configs import MoEConfig as JaxMoE
from repro.models import moe as jmoe
from repro_torch.configs import ArchConfig, MoEConfig, get_config
from repro_torch.distributed.sharding import (Mesh, Sharder, ShardedTensor,
                                              param_shardings)
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.params import param_axes
from repro_torch.models.transformer import tree_leaves, tree_map2
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import build_train_step, init_train_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
# (tag, mesh shape, capacity factor)
CASES = [("2x4_cf8", (2, 4), 8.0), ("2x4_cf1.25", (2, 4), 1.25),
         ("1x2_cf1.25", (1, 2), 1.25)]

REF_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import ArchConfig, MoEConfig, get_config
    from repro.distributed.sharding import Sharder, param_shardings
    from repro.models import params as pp
    from repro.models.model import build_model
    from repro.models.moe import apply_moe_ep, init_moe
    from repro.training.optimizer import make_optimizer
    from repro.training.train_loop import build_train_step, init_train_state

    def flat(tree, pre, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, pre + k + "/", out)
            else:
                out[pre + k] = np.asarray(v)

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    out = {}
    x = np.random.default_rng(1).standard_normal((4, 16, 32)).astype(
        np.float32)
    out["x"] = x
    for tag, shape, cf in CASES:
        cfg = ArchConfig(name="t", family="moe", num_layers=2, d_model=32,
            num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0,
            vocab_size=128, moe_period=1,
            moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16,
                          capacity_factor=cf, group_size=64),
            param_dtype="float32", compute_dtype="float32")
        params, _ = pp.split(init_moe(jax.random.PRNGKey(0), cfg))
        sh = Sharder(mesh_of(shape))
        def loss(p, x):
            y, l = apply_moe_ep(p, x, cfg, sh)
            return jnp.sum(y ** 2) + sum(l.values()), (y, l)
        (_, (y, l)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, x)
        flat(params, tag + "/params/", out)
        out[tag + "/y"] = np.asarray(y)
        out[tag + "/aux"] = np.asarray(l["moe_aux"])
        out[tag + "/z"] = np.asarray(l["moe_z"])
        flat(g, tag + "/grads/", out)

    cfg = get_config("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           dispatch="ep"))
    bundle = build_model(cfg)
    params, axes = pp.split(bundle.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("tokens", "labels"):
        out["olmoe/batch/" + k] = rng.integers(
            1, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {k: out["olmoe/batch/" + k] for k in ("tokens", "labels")}
    flat(params, "olmoe/init/", out)
    sh = Sharder(mesh_of((2, 4)), fsdp=True)
    shards = param_shardings(sh, axes, jax.eval_shape(lambda: params))
    placed = jax.tree.map(jax.device_put, params, shards)
    opt = make_optimizer(cfg)
    state = init_train_state(bundle, opt, placed)
    step = jax.jit(build_train_step(bundle, sh, opt,
                                    lr_fn=lambda s: jnp.float32(LR)))
    state, m = step(state, batch)
    for k in ("loss", "grad_norm", "aux"):
        out["olmoe/" + k] = np.asarray(m[k])
    flat(state["params"], "olmoe/params/", out)
    np.savez(sys.argv[1], **out)
""").replace("CASES", repr(CASES)).replace("LR)", repr(LR) + ")")


def unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "moe_ep.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_MOE_DISPATCH", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as f:
        return dict(f)


def cpu_mesh(shape) -> Mesh:
    return Mesh([torch.device("cpu")] * int(np.prod(shape)), shape,
                ("data", "model"))


def moe_cfgs(E=8, k=2, cf=8.0, gs=64, dispatch="scatter"):
    """tests/test_moe_ep.py's configuration in both packages."""
    kw = dict(name="t", family="moe", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=128,
              moe_period=1, param_dtype="float32", compute_dtype="float32")
    mk = dict(num_experts=E, top_k=k, d_ff_expert=16, capacity_factor=cf,
              group_size=gs, dispatch=dispatch)
    return ArchConfig(moe=MoEConfig(**mk), **kw), JaxArch(moe=JaxMoE(**mk),
                                                          **kw)


def torch_params(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


@pytest.mark.parametrize("tag,shape,cf", CASES)
def test_ep_layer_matches_reference(ref, tag, shape, cf):
    cfg, _ = moe_cfgs(cf=cf, dispatch="ep")
    p = torch_params(unflat(ref, f"{tag}/params/"))
    for t in p.values():
        t.requires_grad_(True)
    x = torch.from_numpy(ref["x"])
    y, losses = tmoe.apply_moe_ep(p, x, cfg, Sharder(cpu_mesh(shape)))
    _close(y.detach().numpy(), ref[f"{tag}/y"])
    _close(losses["moe_aux"].detach().numpy(), ref[f"{tag}/aux"])
    _close(losses["moe_z"].detach().numpy(), ref[f"{tag}/z"])
    loss = torch.sum(y ** 2) + losses["moe_aux"] + losses["moe_z"]
    grads = torch.autograd.grad(loss, list(p.values()))
    for (name, _), g in zip(p.items(), grads):
        want = ref[f"{tag}/grads/{name}"]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(np.abs(
                                       want).max())), err_msg=name)


def test_capacity_drops_happen_at_published_factor(ref):
    """At 1.25 the capacity drops choices: EP is not the scatter path."""
    cfg, _ = moe_cfgs(cf=1.25)
    p = torch_params(unflat(ref, "2x4_cf1.25/params/"))
    y_sc, _ = tmoe.apply_moe_scatter(p, torch.from_numpy(ref["x"]), cfg)
    assert float((y_sc - torch.from_numpy(ref["2x4_cf1.25/y"])).abs()
                 .max()) > 1e-5


@pytest.mark.parametrize("n_bins,cap,valid", [(4, 5, False), (4, 2, False),
                                              (3, 3, True), (1, 40, True)])
def test_capacity_scatter_bit_for_bit(n_bins, cap, valid):
    rng = np.random.default_rng(n_bins * 10 + cap)
    N, d = 24, 6
    x = rng.standard_normal((N, d)).astype(np.float32)
    ids = rng.integers(0, n_bins, N).astype(np.int32)
    mask = rng.random(N) > 0.3 if valid else None
    want = jmoe._capacity_scatter(jnp.asarray(x), jnp.asarray(ids), n_bins,
                                  cap, None if mask is None else
                                  jnp.asarray(mask))
    got = tmoe._capacity_scatter(torch.from_numpy(x),
                                 torch.from_numpy(ids), n_bins, cap,
                                 None if mask is None else
                                 torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert cap * n_bins >= N or not bool(got[2].all())


def _scatter_equal(p, x, cfg, sh):
    y0, l0 = tmoe.apply_moe_scatter(p, x, cfg)
    y1, l1 = tmoe.apply_moe(p, x, cfg, sh)
    return torch.equal(y0, y1) and all(torch.equal(l0[k], l1[k])
                                       for k in l0)


def test_dispatch_selection_takes_scatter_where_the_reference_does(
        monkeypatch):
    monkeypatch.delenv("REPRO_MOE_DISPATCH", raising=False)
    cfg, jcfg = moe_cfgs(dispatch="ep")
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, cfg, "cpu")
    x = torch.randn(4, 16, 32, generator=g)
    # no mesh: the reference's apply_moe returns its scatter path
    from repro.distributed.sharding import null_sharder
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    y, losses = jmoe.apply_moe(jp, jnp.asarray(x.numpy()), jcfg,
                               null_sharder())
    ty, tl = tmoe.apply_moe(p, x, cfg)
    _close(ty.numpy(), y)
    for k in losses:
        _close(tl[k].numpy(), losses[k])
    assert _scatter_equal(p, x, cfg, None)
    assert _scatter_equal(p, x, cfg, Sharder(None))
    # shapes the mesh does not divide, and M = 1
    assert not tmoe.ep_applies((4, 15, 32), cfg, Sharder(cpu_mesh((2, 4))))
    assert _scatter_equal(p, x[:, :15], cfg, Sharder(cpu_mesh((2, 4))))
    assert _scatter_equal(p, x[:3], cfg, Sharder(cpu_mesh((2, 4))))
    assert _scatter_equal(p, x, cfg, Sharder(cpu_mesh((8, 1))))
    cfg3 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=6))
    p3 = tmoe.init_moe(torch.Generator().manual_seed(1), cfg3, "cpu")
    assert _scatter_equal(p3, x, cfg3, Sharder(cpu_mesh((1, 4))))
    assert tmoe.ep_applies(x.shape, cfg, Sharder(cpu_mesh((2, 4))))
    assert not _scatter_equal(p, x, cfg, Sharder(cpu_mesh((2, 4))))
    # the environment overrides the config, both ways
    cfg_sc, _ = moe_cfgs(dispatch="scatter")
    sh = Sharder(cpu_mesh((1, 4)))
    assert not tmoe.ep_applies(x.shape, cfg_sc, sh)
    monkeypatch.setenv("REPRO_MOE_DISPATCH", "ep")
    assert tmoe.ep_applies(x.shape, cfg_sc, sh)
    y_env, _ = tmoe.apply_moe(p, x, cfg_sc, sh)
    assert torch.equal(y_env, tmoe.apply_moe_ep(p, x, cfg_sc, sh)[0])
    monkeypatch.setenv("REPRO_MOE_DISPATCH", "scatter")
    assert _scatter_equal(p, x, cfg, sh)


@pytest.mark.parametrize("shape", [(2, 4), (1, 2), (1, 8)])
def test_ep_matches_scatter_within_the_reference_test_bounds(shape):
    """tests/test_moe_ep.py's three checks (forward 5e-3, aux 1e-6, grads
    1e-3) on the port, at capacity factor 8."""
    cfg, _ = moe_cfgs(dispatch="ep")
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, cfg, "cpu")
    x = torch.randn(4, 16, 32, generator=g)
    out = {}
    for name, fn in (("scatter", lambda q: tmoe.apply_moe_scatter(q, x, cfg)),
                     ("ep", lambda q: tmoe.apply_moe(
                         q, x, cfg, Sharder(cpu_mesh(shape))))):
        q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, losses = fn(q)
        loss = torch.sum(y ** 2) + sum(losses.values())
        out[name] = (y.detach(), losses["moe_aux"].detach(),
                     torch.autograd.grad(loss, list(q.values())))
    (y1, a1, g1), (y2, a2, g2) = out["scatter"], out["ep"]
    assert float((y1 - y2).abs().max()) < 5e-3
    assert abs(float(a1) - float(a2)) < 1e-6
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 1e-3


def test_olmoe_ep_step_matches_reference(ref):
    cfg = get_config("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           dispatch="ep"))
    init = params_from_jax(cfg, unflat(ref, "olmoe/init/"))
    sh = Sharder(cpu_mesh((2, 4)), fsdp=True)
    params = tree_map2(sh.place_named, init,
                       param_shardings(sh, param_axes(cfg), init))
    bundle = build_model(cfg)
    opt = make_optimizer(cfg)
    state = init_train_state(bundle, opt, params, sh)
    batch = {k: torch.from_numpy(ref[f"olmoe/batch/{k}"])
             for k in ("tokens", "labels")}
    assert tmoe.ep_applies((4, 32, cfg.d_model), cfg, sh)
    state, m = build_train_step(bundle, sh, opt,
                                lr_fn=lambda s: torch.tensor(LR))(state,
                                                                  batch)
    for k in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(float(m[k]), ref[f"olmoe/{k}"],
                                   rtol=1e-5, err_msg=k)
    want = params_from_jax(cfg, unflat(ref, "olmoe/params/"))
    for p, w in zip(tree_leaves(state["params"]), tree_leaves(want)):
        assert isinstance(p, ShardedTensor)
        np.testing.assert_allclose(p.full().numpy(), w.numpy(), rtol=5e-3,
                                   atol=5e-3)


def test_dropped_log_counts_what_each_path_drops(monkeypatch):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 16, 32, generator=g)
    cfg, _ = moe_cfgs(cf=0.5, dispatch="ep")
    p = tmoe.init_moe(g, cfg, "cpu")
    log: list = []
    monkeypatch.setattr(tmoe, "dropped_log", log)
    tmoe.apply_moe(p, x, cfg)
    gsz, G, cap = tmoe.group_shape(64, cfg.moe)
    logits = torch.matmul(x.reshape(G, gsz, 32), p["router"])
    keep = tmoe._routing(logits, cfg.moe, cap)[3]
    assert int(log[-1]) == int((~keep).sum()) > 0
    cfg8, _ = moe_cfgs(cf=8.0, dispatch="ep")
    tmoe.apply_moe(p, x, cfg8, Sharder(cpu_mesh((1, 8))))      # e_loc 1
    tmoe.apply_moe(p, x, cfg8, Sharder(cpu_mesh((1, 4))))      # e_loc 2
    assert int(log[-2]) == 0 and int(log[-1]) > 0
    monkeypatch.setattr(tmoe, "dropped_log", None)
    y, _ = tmoe.apply_moe(p, x, cfg8, Sharder(cpu_mesh((1, 4))))
    assert float((y - tmoe.apply_moe_scatter(p, x, cfg8)[0]).abs().max()) \
        < 5e-3
