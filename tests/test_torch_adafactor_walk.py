"""Adafactor's update walked one stage slice at a time.

The port's Adafactor updates a stacked leaf (stage axis first) a slice at
a time in two passes -- the second moment and the sum of ``u^2``, then
``u`` again clipped by the whole leaf's RMS -- so that olmoe-1b-7b's
(16, 64, 2048, 1024) expert leaves train on one card.  Held here:

* against the JAX package's ``adafactor`` over 3 steps at rtol 1e-6 (the
  absolute part 1e-6 of the leaf's largest value, as
  ``tests/test_torch_optimizer.py``), on reduced olmoe's parameter tree
  (stacked 4-D expert leaves) plus a stacked factored leaf, without
  momentum and, for its first step, with the bf16 momentum;
* against the whole-leaf update (every temporary the leaf's size, the
  formula the walk replaced) at float32 rounding;
* that no operator of the update makes a tensor larger than a stage slice
  of a stacked leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.models.transformer import tree_map
from repro_torch.training import optimizer as topt

RTOL = 1e-6


def _tree(seed: int = 0):
    """Numpy parameters: reduced olmoe's tree (shapes from the meta init)
    and a stacked factored leaf (3, 2, 256, 128)."""
    rng = np.random.default_rng(seed)
    shapes = tree_map(lambda t: tuple(t.shape),
                      build_model(get_config("olmoe-1b-7b").reduced()).init(
                          0, "meta"))
    p = tree_map(lambda s: (rng.standard_normal(s) * 0.02).astype(
        np.float32), shapes)
    p["stacked_factored"] = (rng.standard_normal((3, 2, 256, 128))
                             * 0.02).astype(np.float32)
    return p


def _grads(rng, p):
    return tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), p)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    tree)


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(np.asarray(tree.float() if isinstance(tree, torch.Tensor)
                              else tree, np.float32))
    return out


def _close(got, want, rtol=RTOL):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


def _whole_leaf_adafactor(momentum):
    """The update with whole-leaf temporaries: g^2, the reconstructed
    denominator and u each the leaf's size."""
    opt = topt.adafactor(momentum=momentum)
    eps, decay_pow = 1e-30, 0.8

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["count"] += 1
        beta2 = 1.0 - state["count"].float() ** (-decay_pow)

        def upd(p, g, v, m=None):
            g = g.float()
            g2 = g * g + eps
            if "vr" in v:
                v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1))
                v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2))
                denom = v["vr"][..., :, None] * v["vc"][..., None, :]
                denom = denom / torch.clamp(
                    v["vr"].mean(dim=-1)[..., None, None], min=1e-30)
                u = g * torch.rsqrt(torch.clamp(denom, min=1e-30))
            else:
                v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
                u = g * torch.rsqrt(torch.clamp(v["v"], min=1e-30))
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            if m is not None:
                u = momentum * m.float() + (1 - momentum) * u
                m.copy_(u)
            p.copy_(p.float() - lr * u)

        ms = state.get("m")
        topt._each(upd, params, grads, state["v"],
                   *([ms] if ms is not None else []))
        return params, state

    return opt.init, update


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_walk_matches_reference_adafactor(momentum):
    rng = np.random.default_rng(1)
    p = _tree()
    jo, to = jopt.adafactor(momentum=momentum), topt.adafactor(
        momentum=momentum)
    jp, tp = jax.tree.map(jnp.asarray, p), _t(p)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3 if momentum is None else 1):
        g = _grads(rng, p)
        lr = 1e-2 * (step + 1)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.float32(lr))
        tp, ts = to.update(_t(g), ts, tp, torch.tensor(lr))
        _close(tp, jp)
        _close(ts["v"], js["v"])
    assert int(ts["count"]) == int(js["count"])


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_walk_matches_whole_leaf_update(momentum):
    rng = np.random.default_rng(2)
    p = _tree(3)
    walk = topt.adafactor(momentum=momentum)
    init, whole = _whole_leaf_adafactor(momentum)
    a, b = _t(p), _t(p)
    sa, sb = walk.init(a), init(b)
    for step in range(3 if momentum is None else 1):
        g = _grads(rng, p)
        walk.update(_t(g), sa, a, torch.tensor(1e-2))
        whole(_t(g), sb, b, torch.tensor(1e-2))
        _close(a, b)
        _close(sa["v"], sb["v"])


class _Largest(TorchDispatchMode):
    """The largest tensor any non-view operator returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("factored", [True, False])
def test_no_temporary_larger_than_a_stage_slice(factored):
    shape = (4, 3, 256, 128) if factored else (4, 3, 64, 32)
    p = {"w": torch.randn(shape) * 0.02}
    opt = topt.adafactor()
    st = opt.init(p)
    assert ("vr" in st["v"]["w"]) == factored
    g, lr = {"w": torch.randn(shape)}, torch.tensor(1e-2)
    with _Largest() as seen:
        opt.update(g, st, p, lr)
    assert seen.largest == p["w"][0].numel()


class _SizedOutputs(TorchDispatchMode):
    """How many new tensors of exactly ``numel`` elements operators make
    (an in-place operator's output, its own input, is not new)."""

    def __init__(self, numel: int):
        super().__init__()
        self.numel, self.count = numel, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        seen = {t.untyped_storage().data_ptr() for t in
                torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.numel() == self.numel \
                    and t.untyped_storage().data_ptr() not in seen:
                self.count += 1
        return out


def test_train_step_makes_one_tensor_of_an_expert_leafs_size():
    """Reduced olmoe with Adafactor at batch 1 x 4 tokens (the expert
    leaves are the largest tensors of the step): a step makes one tensor
    of an expert leaf's size per expert leaf, its gradient -- the stages'
    gradients land in it a stage at a time (no per-stage zero leaf, no
    stack) and the update walks it a slice at a time."""
    import dataclasses

    from repro_torch.launch.train import make_state_and_step
    from repro_torch.models.transformer import tree_leaves

    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              optimizer="adafactor")
    _, state, step, _ = make_state_and_step(cfg, "cpu", 0)
    experts = state["params"]["stages"]["sub0"]["moe"]
    n = experts["w_gate"].numel()
    same = [t for t in tree_leaves(state["params"]) if t.numel() == n]
    assert len(same) == 3 and n > 8 * 4 * cfg.vocab_size
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (1, 5)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
             "labels": torch.from_numpy(toks[:, 1:]).int()}
    with _SizedOutputs(n) as seen:
        state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert seen.count == len(same)
