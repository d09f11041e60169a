"""Optimizers on nested dicts of tensors: AdamW and Adafactor.

The JAX package's ``repro/training/optimizer.py``, formula for formula.
PyTorch idiom: :meth:`Optimizer.update` runs under ``torch.no_grad()`` and
writes the parameters and the state in place (the reference returns new
trees from a donated state); the learning rate may be a 0-d device tensor,
so an update needs no host synchronisation.  Both optimizers keep their
state in the parameters' layout, so ``state_axes`` reuses the parameters'
logical axes: ZeRO-style state sharding.  On a mesh, ``init(params, sh,
axes)`` places every state leaf by ``state_axes`` (each exists only as
shards), the parameters and gradients come as
:class:`repro_torch.distributed.sharding.ShardedTensor`, and ``update``
runs shard by shard on each shard's device: AdamW elementwise (each shard
is bit for bit its slice of the unsharded update), Adafactor with its row,
column and RMS sums combined across a tensor's shards before use.

* AdamW -- float32 moments, bias correction, decoupled weight decay.
* Adafactor -- factored second moment over the last two axes (row and
  column means of ``g^2``), RMS update clipping and optional bf16
  momentum; the choice for the 100B+ archs.  A stacked leaf is updated one
  stage slice at a time, in two passes (the second moment and the sum of
  ``u^2``; then ``u`` again, clipped by the whole leaf's RMS), so no float32
  temporary is larger than a slice: olmoe's (16, 64, 2048, 1024) expert
  leaves would need 3 x 8.6 GB at once otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed.sharding import (Sharder, ShardedTensor,
                                              home_device)
from repro_torch.models.transformer import tree_leaves, tree_map, tree_map2


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _each(fn, params, *trees) -> None:
    """``fn(p, *leaves)`` for every leaf ``p`` of ``params``, the other
    trees read at the same keys (a restored state may order its keys
    otherwise)."""
    if isinstance(params, dict):
        for k, v in params.items():
            _each(fn, v, *(t[k] for t in trees))
    else:
        fn(params, *trees)


def _per_shard(fn):
    """``fn(p, *leaves)`` of one tensor leaf, run on every distinct storage
    of a placed leaf with the other trees' locals at its position."""
    def run(p, *others):
        if not isinstance(p, ShardedTensor):
            return fn(p, *others)
        for q, t, _ in p.unique():
            fn(t, *(o.locals[q] for o in others))
    return run


def _on(x, dev):
    """A scalar operand for a shard on ``dev``: a device tensor moved there
    (a number or a 0-d host tensor serves any device as it is)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu" \
            and x.device != dev:
        return x.to(dev)
    return x


def _meta(params):
    return tree_map(lambda p: torch.empty(tuple(p.shape), dtype=p.dtype,
                                          device="meta"), params)


def _place_state(state_meta, axes, sh: Sharder, dev):
    """Zeros of ``state_meta``'s shapes and types, each leaf placed by its
    logical ``axes`` (``state_axes``' tree); a 0-d leaf (the step count) a
    plain tensor on ``dev``."""
    if _is_axes(axes):
        if not axes:
            return torch.zeros((), dtype=state_meta.dtype, device=dev)
        return sh.zeros(tuple(state_meta.shape), axes, state_meta.dtype)
    return {k: _place_state(v, axes[k], sh, dev)
            for k, v in state_meta.items()}


def _initialiser(init_plain, state_axes):
    """``init(params, sh=None, axes=None)``: ``init_plain`` off-mesh; on
    ``sh``'s mesh the state placed by ``state_axes(axes, params)``."""
    def init(params, sh: Optional[Sharder] = None, axes=None):
        if sh is None or sh.mesh is None:
            return init_plain(params)
        meta = _meta(params)
        return _place_state(init_plain(meta), state_axes(axes, meta), sh,
                           home_device(tree_leaves(params)[0]))
    return init


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # update(grads, opt_state, params, lr) -> (params, opt_state), both
    # written in place
    update: Callable[[Any, Any, Any, Any], Any]
    # state_axes(param_axes_tree, param_shape_tree) -> logical axes of state
    state_axes: Callable[[Any, Any], Any] = None


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init_plain(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["count"] += 1
        cf = state["count"].float()
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf

        def upd(p, g, m, v):
            dev = p.device
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / _on(bc1, dev)).div_(
                torch.sqrt(v / _on(bc2, dev)).add_(eps))
            pf = p.float()
            step.add_(pf, alpha=weight_decay)
            p.copy_(pf - _on(lr, dev) * step)

        _each(_per_shard(upd), params, grads, state["m"], state["v"])
        return params, state

    def state_axes(p_axes, p_shapes):
        del p_shapes
        return {"m": p_axes, "v": p_axes, "count": ()}

    return Optimizer(_initialiser(init_plain, state_axes), update,
                     state_axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, optional bf16 momentum)
# ---------------------------------------------------------------------------
def adafactor(decay_pow: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_factored: int = 128,
              momentum: Optional[float] = 0.9,
              weight_decay: float = 0.0) -> Optimizer:
    def factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_factored
                and shape[-2] >= min_dim_factored)

    def init_plain(params):
        def state_for(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        st = {"v": tree_map(state_for, params),
              "count": torch.zeros((), dtype=torch.int32,
                                   device=tree_leaves(params)[0].device)}
        if momentum is not None:
            st["m"] = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
        return st

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["count"] += 1
        beta2 = 1.0 - state["count"].float() ** (-decay_pow)

        def second_moment(g, v, fac: bool) -> torch.Tensor:
            """Update one slice's second moment from its gradient ``g``,
            in place; returns the slice's unclipped update."""
            g = g.float()
            g2 = g * g + eps
            if fac:
                v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1))
                v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2))
            else:
                v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
            del g2
            return _unclipped(g, v, fac)

        def upd(p, g, v, m=None):             # v: {vr, vc} or {v}
            fac = factored(p.shape)
            # a stacked leaf (stage axis first; the factored axes are the
            # last two) is walked one stage slice at a time, so no
            # temporary is larger than a slice: pass 1 updates the second
            # moment and sums u^2, pass 2 recomputes u from it, clips by the
            # whole leaf's RMS and applies momentum and the step
            parts = range(p.shape[0]) if p.dim() >= 3 else [slice(None)]
            total = 0.0
            for i in parts:
                u = second_moment(g[i], tree_map(lambda t: t[i], v), fac)
                total = total + torch.sum(u * u)
                del u
            rms = torch.sqrt(total / p.numel() + 1e-30)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            for i in parts:
                u = _unclipped(g[i].float(), tree_map(lambda t: t[i], v),
                               fac) / scale
                if m is not None:
                    u = momentum * m[i].float() + (1 - momentum) * u
                    m[i].copy_(u)
                pf = p[i].float()
                p[i].copy_(pf - lr * (u + weight_decay * pf))

        def upd_any(p, g, v, m=None):
            if isinstance(p, ShardedTensor):
                _adafactor_sharded(p, g, v, m, beta2, lr, eps, clip_threshold,
                                   momentum, weight_decay, factored(p.shape))
            else:
                upd(p, g, v, m)

        if state.get("m") is not None:
            _each(upd_any, params, grads, state["v"], state["m"])
        else:
            _each(upd_any, params, grads, state["v"])
        return params, state

    def state_axes(p_axes, p_shapes):
        def v_axes(axes, shp):
            if factored(tuple(shp.shape)):
                return {"vr": tuple(axes[:-1]),
                        "vc": tuple(axes[:-2]) + tuple(axes[-1:])}
            return {"v": tuple(axes)}

        st = {"v": tree_map2(v_axes, p_axes, p_shapes), "count": ()}
        if momentum is not None:
            st["m"] = p_axes
        return st

    return Optimizer(_initialiser(init_plain, state_axes), update,
                     state_axes)


def _unclipped(g: torch.Tensor, v, fac: bool) -> torch.Tensor:
    """Adafactor's update ``g / sqrt(v)`` before clipping, ``v`` the second
    moment -- factored, the rank-1 reconstruction from its row and column
    means, each matrix over its mean row mean."""
    if not fac:
        return g * torch.rsqrt(torch.clamp(v["v"], min=1e-30))
    vr, vc = v["vr"], v["vc"]
    denom = vr[..., :, None] * vc[..., None, :]
    denom = denom / torch.clamp(vr.mean(dim=-1)[..., None, None], min=1e-30)
    return g * torch.rsqrt(torch.clamp(denom, min=1e-30))


def _sum_at(parts, shape, dev) -> torch.Tensor:
    """The global float32 tensor of ``shape`` on ``dev`` that sums the
    partial ``(slices, tensor)`` pieces at their slices, in their order."""
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    for sl, t in parts:
        out[sl] += t.to(dev)
    return out


def _aligned(state: ShardedTensor, p: ShardedTensor, keep) -> None:
    """Raise unless each position's ``state`` local covers the slices
    ``keep(p's slices)`` -- a state leaf placed as its parameter is."""
    for a, b in zip(state.slices, p.slices):
        if tuple(a) != tuple(keep(b)):
            raise ValueError(f"state spec {state.spec} does not follow the "
                             f"parameter's {p.spec}")


@torch.no_grad()
def _adafactor_sharded(p: ShardedTensor, g: ShardedTensor, v, m, beta2, lr,
                       eps, clip_threshold, momentum, weight_decay,
                       factored: bool) -> None:
    """Adafactor's update of a placed leaf: the means of ``g^2`` over rows
    and columns, the mean of ``vr`` and the update's RMS summed across the
    distinct shards (each slice set counted once) on the mesh's first
    device, then every storage updated on its device."""
    dev0 = p.mesh.position_devices()[0]
    shape = p.shape
    g2 = {q: g.locals[q].float() ** 2 + eps for q, _, _ in p.unique()}
    u = {}
    if factored:
        vr, vc = v["vr"], v["vc"]
        _aligned(vr, p, lambda sl: sl[:-1])
        _aligned(vc, p, lambda sl: sl[:-2] + sl[-1:])
        # a distinct slice set's first position is its storage's first
        rows = _sum_at([(sl[:-1], g2[q].sum(dim=-1))
                        for q, _, sl in p.distinct()],
                       shape[:-1], dev0) / shape[-1]
        cols = _sum_at([(sl[:-2] + sl[-1:], g2[q].sum(dim=-2))
                        for q, _, sl in p.distinct()],
                       shape[:-2] + shape[-1:], dev0) / shape[-2]
        for st, mean in ((vr, rows), (vc, cols)):
            for _, t, sl in st.unique():
                b2 = _on(beta2, t.device)
                t.copy_(b2 * t + (1 - b2) * mean[sl].to(t.device))
        vr_mean = vr.full().mean(dim=-1)
        for q, t, sl in p.unique():
            dev = t.device
            denom = vr.locals[q][..., :, None] * vc.locals[q][..., None, :]
            denom = denom / torch.clamp(
                vr_mean[sl[:-2]].to(dev)[..., None, None], min=1e-30)
            u[q] = g.locals[q].float() * torch.rsqrt(
                torch.clamp(denom, min=1e-30))
    else:
        for q, t, _ in p.unique():
            vl = v["v"].locals[q]
            b2 = _on(beta2, t.device)
            vl.copy_(b2 * vl + (1 - b2) * g2[q])
            u[q] = g.locals[q].float() * torch.rsqrt(
                torch.clamp(vl, min=1e-30))
    total = torch.zeros((), dtype=torch.float32, device=dev0)
    for q, _, _ in p.distinct():
        total = total + torch.sum(u[q] * u[q]).to(dev0)
    rms = torch.sqrt(total / p.numel() + 1e-30)
    scale = torch.clamp(rms / clip_threshold, min=1.0)
    for q, t, _ in p.unique():
        dev = t.device
        uq = u[q] / scale.to(dev)
        if m is not None:
            uq = momentum * m.locals[q].float() + (1 - momentum) * uq
            m.locals[q].copy_(uq)
        pf = t.float()
        t.copy_(pf - _on(lr, dev) * (uq + weight_decay * pf))


def make_optimizer(cfg: ArchConfig) -> Optimizer:
    if cfg.optimizer == "adafactor":
        return adafactor(weight_decay=0.0)
    return adamw(weight_decay=cfg.weight_decay)


def lr_schedule(cfg: ArchConfig, warmup: int = 100, total: int = 10000):
    """Linear warmup then cosine decay to a tenth: ``lr(step)`` of an
    integer step tensor (or int) is a float32 tensor on its device."""
    def lr(step):
        s = torch.as_tensor(step).float()
        warm = cfg.learning_rate * torch.clamp(s / warmup, max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * (0.1 + 0.9 * cos)
    return lr
