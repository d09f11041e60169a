"""The port's optimizers against the JAX package's, on the same numpy
parameters and gradients.

* AdamW and Adafactor (factored and unfactored leaves, with and without
  its bf16 momentum, a bf16 parameter) for 3 steps against the
  reference's ``update``, at rtol 1e-6 on parameters and state, the
  absolute part 1e-6 of the leaf's largest value (a parameter the step
  takes across zero has no relative error to speak of).  With bf16
  momentum the second moments hold at 1e-6 for all 3 steps and the
  parameters after the first; from the second step a momentum element
  may round to the other bf16 neighbour (its float32 input differs in
  the last bit, the row and column means being summed in another order),
  which moves its parameter by lr x 0.9 x 2^-8 |m|: the parameters and
  the momentum then hold at 2^-8 of the leaf's largest value;
* ``lr_schedule`` over warmup and decay, ``make_optimizer`` by config;
* state shapes and dtypes, and ``state_axes`` against the reference's;
* the counterparts of tests/test_optimizer.py: convergence on the
  quadratic, the first AdamW step lr-sized, decoupled weight decay.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.training import optimizer as topt

RTOL = 1e-6


def _tree(rng):
    """Numpy params: factored (256 x 128, a stacked 2 x 128 x 160),
    unfactored (a vector, a narrow matrix) leaves."""
    p = {"w": rng.standard_normal((256, 128)).astype(np.float32) * 0.02,
         "stack": {"k": rng.standard_normal((2, 128, 160)).astype(
             np.float32) * 0.02},
         "b": rng.standard_normal((7,)).astype(np.float32),
         "narrow": rng.standard_normal((5, 300)).astype(np.float32)}
    return p


def _grads(rng, p):
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), p)


def _to_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)
                                                   ).to(dtype or torch.float32),
                        tree)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL):
    """Leaf by leaf at ``rtol``, the absolute part ``rtol`` times the
    leaf's largest |value|."""
    flat_w, td = jax.tree.flatten(want)
    flat_g = td.flatten_up_to(got)
    for g, w in zip(flat_g, flat_w):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adafactor_nomom"])
def test_updates_match_reference_for_three_steps(name):
    rng = np.random.default_rng(3)
    p = _tree(rng)
    make = {"adamw": (lambda m: m.adamw(weight_decay=0.1)),
            "adafactor": (lambda m: m.adafactor(weight_decay=0.01)),
            "adafactor_nomom": (lambda m: m.adafactor(momentum=None))}[name]
    jo, to = make(jopt), make(topt)
    jp = jax.tree.map(jnp.asarray, p)
    tp = _to_torch(p)
    js, ts = jo.init(jp), to.init(tp)
    bf16_m = name == "adafactor"
    for step in range(3):
        g = _grads(rng, p)
        lr = 1e-2 * (step + 1)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.float32(lr))
        tp, ts = to.update(_to_torch(g), ts, tp, torch.tensor(lr))
        if step == 0 or not bf16_m:
            _close(tp, jp)
        for k in ("m", "v"):
            if k in js and (k == "v" or not bf16_m):
                _close(ts[k], js[k])
    if bf16_m:
        _close(tp, jp, rtol=2.0 ** -8)
        _close(ts["m"], js["m"], rtol=2.0 ** -8)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_bf16_parameter_stays_bf16_and_matches():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((8, 8)) * 0.1).astype(np.float32)
    g = rng.standard_normal((8, 8)).astype(np.float32)
    jo, to = jopt.adamw(), topt.adamw()
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    js, ts = jo.init(jp), to.init(tp)
    assert ts["m"]["w"].dtype == torch.float32
    jp, js = jo.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp,
                       jnp.float32(0.1))
    tp, ts = to.update({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp,
                       0.1)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tp["w"]), _np(jp["w"]))


def test_state_shapes_dtypes_and_axes_match_reference():
    shapes = {"big": (256, 128), "small": (3,), "stack": (2, 128, 256)}
    axes = {"big": ("fsdp", "heads"), "small": (None,),
            "stack": ("layers", "fsdp", "ff")}
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    for make in (lambda m: m.adamw(), lambda m: m.adafactor()):
        js, ts = make(jopt).init(jp), make(topt).init(tp)
        flat_j, td = jax.tree.flatten(js)
        flat_t = td.flatten_up_to(ts)
        for a, b in zip(flat_j, flat_t):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        want = make(jopt).state_axes(axes, jp)
        assert make(topt).state_axes(axes, tp) == want
    st = topt.adafactor().init(tp)
    assert st["v"]["big"]["vr"].shape == (256,)
    assert st["v"]["big"]["vc"].shape == (128,)
    assert st["v"]["stack"]["vr"].shape == (2, 128)
    assert st["v"]["small"]["v"].shape == (3,)
    assert st["m"]["big"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mistral-large-123b"])
def test_lr_schedule_and_make_optimizer_match(arch):
    jl = jopt.lr_schedule(jax_config(arch), warmup=10, total=100)
    tl = topt.lr_schedule(get_config(arch), warmup=10, total=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(tl(torch.tensor(s, dtype=torch.int32))),
            float(jl(jnp.int32(s))), rtol=RTOL)
    # the defaults (warmup 100 of 10,000)
    for s in (0, 37, 100, 5000, 10000):
        np.testing.assert_allclose(
            float(topt.lr_schedule(get_config(arch))(torch.tensor(s))),
            float(jopt.lr_schedule(jax_config(arch))(jnp.int32(s))),
            rtol=RTOL)
    st = topt.make_optimizer(get_config(arch)).init(
        {"w": torch.zeros(256, 256)})
    jst = jopt.make_optimizer(jax_config(arch)).init(
        {"w": jnp.zeros((256, 256))})
    assert isinstance(st["v"]["w"], dict) == isinstance(jst["v"]["w"], dict)
    assert sorted(st) == sorted(jst)


@pytest.mark.parametrize("make", [lambda: topt.adamw(weight_decay=0.0),
                                  lambda: topt.adafactor()])
def test_optimizers_converge_on_quadratic(make):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = make()
    state = opt.init(params)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(g, state, params, 0.05)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.15)


def test_adamw_first_step_is_lr_sized_and_decay_decoupled():
    opt = topt.adamw(weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    g = {"w": torch.tensor([1.0, -1.0, 2.0, -3.0])}
    new_p, _ = opt.update(g, opt.init(params), params, 0.1)
    np.testing.assert_allclose(new_p["w"].numpy(),
                               -0.1 * np.sign(g["w"].numpy()), rtol=1e-3)
    opt = topt.adamw(weight_decay=0.5)
    params = {"w": torch.ones(2)}
    new_p, _ = opt.update({"w": torch.zeros(2)}, opt.init(params), params,
                          0.1)
    np.testing.assert_allclose(new_p["w"].numpy(), 1.0 - 0.1 * 0.5,
                               rtol=1e-5)
