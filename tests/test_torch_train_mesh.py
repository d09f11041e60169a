"""The port's training mesh against the JAX package's own mesh code.

The reference's sharded step runs in one module-scoped subprocess with
eight host devices (``XLA_FLAGS`` set before ``jax`` is imported) on
meshes built with ``axis_types=(AxisType.Auto,) * 2``, under which its
``with_sharding_constraint`` specs run unchanged: reduced internlm2-1.8b,
``jax.jit(build_train_step(bundle, Sharder(mesh, fsdp=True), opt))`` with
the parameters placed by ``param_shardings``, one step at a constant
learning rate 1e-3 on a seeded numpy batch, at 1x1, 1x2 and 2x4.  The port
runs in-process on meshes of ``torch.device("cpu")`` repeated, from the
same weights (``params_from_jax``).

* against the reference: loss and grad norm at rtol 1e-5 (the no-mesh
  step's loss tolerance in tests/test_torch_train.py) and every parameter
  after the step at rtol = atol = 5e-3 (its step's parameter tolerance),
  fsdp on and off;
* inside the port, against no mesh, AdamW at ``microbatches=2``, two
  steps: loss, grad norm, every gradient and every parameter bit for bit
  at 1x1, 1x2, 1x4 and 2x4 (no exception was needed on this CPU);
  Adafactor at rtol 1e-6 (absolute part 1e-6 of the leaf's largest
  value): its row, column and RMS means are summed across shards;
* the optimizer state placed by ``state_axes`` (it exists only as shards),
  the factored Adafactor update of split leaves, the step's grads cut into
  the parameters' shards;
* ``make_state_and_step(cfg, device, seed, mesh=)``; a placed state's
  checkpoint (the global tensors, the same files as with no mesh) read back
  with no mesh and placed again on a mesh;
* ``compressed_psum`` bit for bit against the reference's under
  ``jax.vmap(..., axis_name=)`` at 2 and 4 members and a 2x2x2 mesh, with
  a ragged last block; the collectives the step and EP use
  (``all_to_all``, ``pmean``, ``relayout``, the gather's backward).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import grad_compression as jgc
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import (Mesh, Sharder, ShardedTensor,
                                              all_to_all, layout,
                                              param_shardings, pmean)
from repro_torch.launch.train import make_state_and_step
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.params import param_axes
from repro_torch.models.transformer import tree_leaves, tree_map, tree_map2
from repro_torch.training import grad_compression as tgc
from repro_torch.training.optimizer import Optimizer, adafactor, adamw
from repro_torch.training.train_loop import (build_eval_step,
                                             build_train_step,
                                             init_train_state)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
LR = 1e-3
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x4": (2, 4)}

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed.sharding import Sharder, param_shardings
    from repro.models import params as pp
    from repro.models.model import build_model
    from repro.training.optimizer import make_optimizer
    from repro.training.train_loop import build_train_step, init_train_state

    def flat(tree, pre, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, pre + k + "/", out)
            else:
                out[pre + k] = np.asarray(v)

    cfg = get_config("internlm2-1.8b").reduced()
    bundle = build_model(cfg)
    params, axes = pp.split(bundle.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    out = {k: rng.integers(1, cfg.vocab_size, (8, 32)).astype(np.int32)
           for k in ("batch/tokens", "batch/labels")}
    batch = {k.split("/")[1]: v for k, v in out.items()}
    flat(params, "init/", out)
    for tag in sys.argv[2:]:
        shape = tuple(int(n) for n in tag.split("x"))
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        sh = Sharder(mesh, fsdp=True)
        shards = param_shardings(sh, axes, jax.eval_shape(lambda: params))
        placed = jax.tree.map(jax.device_put, params, shards)
        opt = make_optimizer(cfg)
        state = init_train_state(bundle, opt, placed)
        step = jax.jit(build_train_step(bundle, sh, opt,
                                        lr_fn=lambda s: jnp.float32(%r)))
        state, m = step(state, batch)
        out[tag + "/loss"] = np.asarray(m["loss"])
        out[tag + "/grad_norm"] = np.asarray(m["grad_norm"])
        flat(state["params"], tag + "/params/", out)
    np.savez(sys.argv[1], **out)
""" % LR)


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
    out = tmp_path_factory.mktemp("ref") / "train_mesh.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                        *MESHES], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def cfg():
    return get_config(ARCH).reduced()


def cpu_mesh(shape, names=("data", "model")) -> Mesh:
    return Mesh([torch.device("cpu")] * int(np.prod(shape)), shape, names)


def placed_params(cfg, init, sh):
    params = tree_map(lambda t: t.clone(), init)
    if sh is None or sh.mesh is None:
        return params
    return tree_map2(sh.place_named, params,
                     param_shardings(sh, param_axes(cfg), params))


def full(t):
    return (t.full() if isinstance(t, ShardedTensor) else t).detach()


def capture(opt: Optimizer, store: list) -> Optimizer:
    """``opt`` whose update first keeps the global grads it is given."""
    def update(grads, state, params, lr):
        store.append([full(g).clone() for g in tree_leaves(grads)])
        return opt.update(grads, state, params, lr)
    return Optimizer(opt.init, update, opt.state_axes)


def run_steps(cfg, init, batch, sh, opt, steps=1):
    grads: list = []
    opt = capture(opt, grads)
    bundle = build_model(cfg)
    state = init_train_state(bundle, opt, placed_params(cfg, init, sh), sh)
    step = build_train_step(bundle, sh, opt,
                            lr_fn=lambda s: torch.tensor(LR))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads, [full(p) for p in tree_leaves(state["params"])], \
        state


# ---------------------------------------------------------------------------
# against the reference's sharded step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_step_matches_reference(ref, cfg, tag, fsdp):
    init = params_from_jax(cfg, unflat(ref, "init/"))
    batch = {k: torch.from_numpy(ref[f"batch/{k}"]) for k in ("tokens",
                                                             "labels")}
    sh = Sharder(cpu_mesh(MESHES[tag]), fsdp=fsdp)
    metrics, _, params, _ = run_steps(cfg, init, batch, sh, adamw(
        weight_decay=cfg.weight_decay))
    np.testing.assert_allclose(metrics[0]["loss"], ref[f"{tag}/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics[0]["grad_norm"],
                               ref[f"{tag}/grad_norm"], rtol=1e-5)
    want = params_from_jax(cfg, unflat(ref, f"{tag}/params/"))
    moved = 0
    for p, w, p0 in zip(params, tree_leaves(want), tree_leaves(init)):
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=5e-3,
                                   atol=5e-3)
        moved += int((w != p0).sum())
    assert moved > 0                       # the reference's step moved them


def test_reference_meshes_agree(ref):
    """The reference's own step gives one loss at every mesh."""
    losses = [float(ref[f"{t}/loss"]) for t in MESHES]
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# inside the port: a mesh against no mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mb2():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), microbatches=2)
    init = build_model(cfg).init(0, "cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 32))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    return cfg, init, batch


@pytest.fixture(scope="module")
def no_mesh_adamw(mb2):
    cfg, init, batch = mb2
    return run_steps(cfg, init, batch, None, adamw(), steps=2)


@pytest.mark.parametrize("shape,fsdp", [((1, 1), False), ((1, 2), False),
                                        ((1, 4), True), ((2, 4), False),
                                        ((2, 4), True)])
def test_adamw_mesh_step_bit_for_bit(mb2, no_mesh_adamw, shape, fsdp):
    cfg, init, batch = mb2
    want_m, want_g, want_p, _ = no_mesh_adamw
    got_m, got_g, got_p, state = run_steps(
        cfg, init, batch, Sharder(cpu_mesh(shape), fsdp=fsdp), adamw(),
        steps=2)
    assert got_m == want_m                 # loss, xent, aux, grad norm, lr
    for gs, ws in zip(got_g, want_g):
        for g, w in zip(gs, ws):
            assert torch.equal(g, w)
    for p, w in zip(got_p, want_p):
        assert torch.equal(p, w)
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2


@pytest.mark.parametrize("momentum,steps", [(None, 2), (0.9, 1)])
@pytest.mark.parametrize("shape,fsdp", [((1, 2), False), ((2, 4), True)])
def test_adafactor_mesh_step_close(mb2, shape, fsdp, momentum, steps):
    """With bf16 momentum one step: from the second a momentum element may
    round to its other bf16 neighbour (tests/test_torch_optimizer.py)."""
    cfg, init, batch = mb2
    opt = lambda: adafactor(weight_decay=0.0, min_dim_factored=16,
                            momentum=momentum)
    want_m, _, want_p, _ = run_steps(cfg, init, batch, None, opt(),
                                     steps=steps)
    got_m, _, got_p, state = run_steps(
        cfg, init, batch, Sharder(cpu_mesh(shape), fsdp=fsdp), opt(),
        steps=steps)
    assert got_m[0] == want_m[0]           # the first step's loss: same bits
    np.testing.assert_allclose(got_m[-1]["loss"], want_m[-1]["loss"],
                               rtol=1e-6)
    for p, w in zip(got_p, want_p):
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))
    factored = [v for v in tree_leaves(state["opt"]["v"])
                if isinstance(v, ShardedTensor) and v.ndim == 2]
    assert factored                        # vr / vc of stacked matrices


def test_adafactor_factored_split_rows_and_columns():
    """Factored leaves split on rows, on columns and on both (2x4 mesh):
    three updates against the unplaced optimizer at rtol 1e-6 (without the
    bf16 momentum, whose rounding may flip from the second step)."""
    rng = np.random.default_rng(3)
    shapes = {"rows": (256, 128), "cols": (128, 256), "both": (2, 256, 160),
              "vec": (96,)}
    axes = {"rows": ("fsdp", None), "cols": (None, "heads"),
            "both": (None, "fsdp", "ff"), "vec": ("inner",)}
    p0 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                              * 0.02) for k, s in shapes.items()}
    gs = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for k, s in shapes.items()} for _ in range(3)]
    opt = adafactor(momentum=None)
    plain = tree_map(lambda t: t.clone(), p0)
    st = opt.init(plain)
    sh = Sharder(cpu_mesh((2, 4)), fsdp=True)
    placed = {k: sh.place(t.clone(), axes[k]) for k, t in p0.items()}
    pst = opt.init(placed, sh, axes)
    assert pst["v"]["rows"]["vr"].spec == (("data",))
    assert pst["v"]["cols"]["vc"].spec == ("model",)
    for g in gs:
        opt.update(g, st, plain, 1e-2)
        opt.update({k: layout(t, sh.mesh, placed[k].spec)
                    for k, t in g.items()}, pst, placed, 1e-2)
    for k in shapes:
        w = plain[k]
        np.testing.assert_allclose(placed[k].full().numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6 * float(
                                       w.abs().max()), err_msg=k)


def test_state_lives_as_shards(cfg):
    sh = Sharder(cpu_mesh((2, 4)), fsdp=True)
    bundle = build_model(cfg)
    params = placed_params(cfg, bundle.init(0, "cpu"), sh)
    opt = adamw()
    state = init_train_state(bundle, opt, params, sh)
    want = opt.state_axes(param_axes(cfg), params)
    for name in ("m", "v"):
        for st, p, ax in zip(tree_leaves(state["opt"][name]),
                             tree_leaves(params), tree_leaves(want[name])):
            assert isinstance(st, ShardedTensor)
            assert st.spec == sh.spec(ax, st.shape) == p.spec
            assert st.dtype == torch.float32
            split = any(e is not None for e in st.spec)
            assert all(t.numel() < st.numel() for t in st.locals) == split
    assert not isinstance(state["opt"]["count"], ShardedTensor)
    wq = state["params"]["stages"]["sub0"]["attn"]["wq"]
    assert wq.spec == (None, "data", "model")


def test_make_state_and_step_places_by_param_shardings(cfg):
    bundle, state, step_fn, sh = make_state_and_step(cfg, "cpu", seed=0)
    assert sh.mesh is None
    assert not any(isinstance(t, ShardedTensor)
                   for t in tree_leaves(state["params"]))
    mesh = cpu_mesh((1, 2))
    bundle, state, step_fn, sh = make_state_and_step(cfg, "cpu", seed=0,
                                                     mesh=mesh)
    assert sh.mesh is mesh
    assert sh.rules["fsdp"] is None and sh.rules["seq"] is None  # cfg.fsdp
    shards = param_shardings(sh, param_axes(cfg), bundle.init(0, "meta"))
    for p, s in zip(tree_leaves(state["params"]), tree_leaves(
            shards, )):
        assert isinstance(p, ShardedTensor) and p.spec == s.spec
    batch = {k: torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 16)).astype(np.int32)) for k in ("tokens",
                                                               "labels")}
    state, m = step_fn(state, batch)
    assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1
    ev = build_eval_step(bundle, sh)(state["params"], batch)
    ev0 = build_eval_step(bundle)(tree_map(full, state["params"]), batch)
    assert float(ev["loss"]) == float(ev0["loss"])


def test_placed_checkpoint_roundtrip(cfg, tmp_path):
    """A placed state writes its global tensors (the very files of the
    same state with no mesh); read back with no mesh it is the gathered
    state, and placed again on a mesh the same shards."""
    sh = Sharder(cpu_mesh((2, 2)), fsdp=True)
    bundle = build_model(cfg)
    state = init_train_state(bundle, adamw(),
                             placed_params(cfg, bundle.init(0, "cpu"), sh),
                             sh)
    batch = {k: torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (4, 16)).astype(np.int32)) for k in ("tokens",
                                                               "labels")}
    state, _ = build_train_step(bundle, sh, adamw())(state, batch)
    plain = tree_map(full, state)
    ckpt.save(tmp_path / "mesh", 1, state)
    ckpt.save(tmp_path / "plain", 1, plain)
    for a, b in zip(sorted((tmp_path / "mesh" / "step_1").iterdir()),
                    sorted((tmp_path / "plain" / "step_1").iterdir())):
        assert a.read_bytes() == b.read_bytes(), a.name
    back = ckpt.restore(tmp_path / "mesh", 1, plain)
    tree_map2(lambda b, a: (not isinstance(a, ShardedTensor)
                            and torch.equal(a, b)) or pytest.fail("leaf"),
              plain, back)
    again = ckpt.restore(tmp_path / "mesh", 1, state)
    placed = []
    tree_map2(lambda b, a: placed.append((a, b)), state, again)
    for a, b in placed:
        if isinstance(b, ShardedTensor):
            assert isinstance(a, ShardedTensor) and a.spec == b.spec
            for x, y in zip(a.locals, b.locals):
                assert torch.equal(x, y)
        else:
            assert torch.equal(a, b)
    assert sum(isinstance(b, ShardedTensor) for _, b in placed) > 0


def test_cuda_mesh_refuses_cpu_locals():
    mesh = Mesh([torch.device("cuda", 0)] * 2, (1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="local on cpu"):
        ShardedTensor.from_locals(mesh, (None,), [torch.zeros(4)] * 2)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def test_all_to_all_and_pmean():
    mesh = cpu_mesh((2, 3))
    locs = [torch.arange(3.0) + 10 * p for p in range(6)]
    out = all_to_all(mesh, locs, "model")
    for p in range(6):
        d, c = divmod(p, 3)
        want = torch.stack([locs[3 * d + i][c] for i in range(3)])
        assert torch.equal(out[p], want)
    means = pmean(mesh, [torch.tensor(float(p)) for p in range(6)])
    assert all(float(m) == 2.5 for m in means)
    rows = pmean(mesh, [torch.tensor(float(p)) for p in range(6)],
                 ("model",))
    assert [float(m) for m in rows] == [1.0] * 3 + [4.0] * 3


def test_relayout_and_gather_backward_cut_the_gradient():
    sh = Sharder(cpu_mesh((2, 2)))
    x = torch.randn(4, 6, requires_grad=True)
    st = sh.relayout(x, ("data", "model"))
    assert [tuple(t.shape) for t in st.locals] == [(2, 3)] * 4
    re = sh.relayout(st, ("model", None))
    assert torch.equal(re.full(), x.detach())
    w = torch.randn(4, 6)
    (re.full() * w).sum().backward()
    assert torch.equal(x.grad, w)
    y = torch.randn(4, 6, requires_grad=True)
    g = torch.randn(4, 6)
    parts = layout(y, sh.mesh, ("data", "model"))
    (parts.full() * g).sum().backward()
    assert torch.equal(y.grad, g)


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(1000,), (3, 300), (64, 128)])
def test_compressed_psum_matches_reference(n, shape):
    """(1000,) and (3, 300) end in a ragged block of 256."""
    rng = np.random.default_rng(n)
    xs = (rng.standard_normal((n,) + shape) * rng.uniform(
        0.1, 10, (n,) + (1,) * len(shape))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda x: jgc.compressed_psum(x, "pod"),
                               axis_name="pod")(jnp.asarray(xs)))
    mesh = cpu_mesh((n, 1, 1), ("pod", "data", "model"))
    st = ShardedTensor.from_locals(mesh, (None,) * len(shape), [
        torch.from_numpy(xs[i].copy()) for i in range(n)])
    got = tgc.compressed_psum(st, "pod")
    for i in range(n):
        np.testing.assert_array_equal(got.locals[i].numpy(), want[i])


def test_compressed_psum_on_a_2x2x2_mesh():
    """Four (data, model) groups of two pods each, every group held
    against the reference's vmap over its two members."""
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((8, 5, 77)).astype(np.float32)
    mesh = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    st = ShardedTensor.from_locals(mesh, (None, None), [
        torch.from_numpy(xs[p].copy()) for p in range(8)])
    got = tgc.compressed_psum(st, "pod", block=64)
    for p in range(4):                      # (data, model) = divmod(p, 2)
        pair = xs[[p, p + 4]]
        want = np.asarray(jax.vmap(
            lambda x: jgc.compressed_psum(x, "pod", block=64),
            axis_name="pod")(jnp.asarray(pair)))
        np.testing.assert_array_equal(got.locals[p].numpy(), want[0])
        np.testing.assert_array_equal(got.locals[p + 4].numpy(), want[1])
