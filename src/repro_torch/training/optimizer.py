"""Optimizers on nested dicts of tensors: AdamW and Adafactor.

The JAX package's ``repro/training/optimizer.py``, formula for formula.
PyTorch idiom: :meth:`Optimizer.update` runs under ``torch.no_grad()`` and
writes the parameters and the state in place (the reference returns new
trees from a donated state); the learning rate may be a 0-d device tensor,
so an update needs no host synchronisation.  Both optimizers keep their
state in the parameters' layout, so ``state_axes`` reuses the parameters'
logical axes (ZeRO-style state sharding for slice 6's mesh).

* AdamW -- float32 moments, bias correction, decoupled weight decay.
* Adafactor -- factored second moment over the last two axes (row and
  column means of ``g^2``), RMS update clipping and optional bf16
  momentum; the choice for the 100B+ archs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import tree_leaves, tree_map, tree_map2


def _each(fn, params, *trees) -> None:
    """``fn(p, *leaves)`` for every leaf ``p`` of ``params``, the other
    trees read at the same keys (a restored state may order its keys
    otherwise)."""
    if isinstance(params, dict):
        for k, v in params.items():
            _each(fn, v, *(t[k] for t in trees))
    else:
        fn(params, *trees)


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
    def init(params):
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
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            pf = p.float()
            step.add_(pf, alpha=weight_decay)
            p.copy_(pf - lr * step)

        _each(upd, params, grads, state["m"], state["v"])
        return params, state

    def state_axes(p_axes, p_shapes):
        del p_shapes
        return {"m": p_axes, "v": p_axes, "count": ()}

    return Optimizer(init, update, state_axes)


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

    def init(params):
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

        def upd(p, g, v, m=None):             # v: {vr, vc} or {v}
            g = g.float()
            g2 = g * g + eps
            if factored(p.shape):
                v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1))
                v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2))
                # rank-1 reconstruction of the second moment
                denom = v["vr"][..., :, None] * v["vc"][..., None, :]
                denom = denom / torch.clamp(
                    v["vr"].mean(dim=-1)[..., None, None], min=1e-30)
                u = g * torch.rsqrt(torch.clamp(denom, min=1e-30))
            else:
                v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
                u = g * torch.rsqrt(torch.clamp(v["v"], min=1e-30))
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if m is not None:
                u = momentum * m.float() + (1 - momentum) * u
                m.copy_(u)
            pf = p.float()
            p.copy_(pf - lr * (u + weight_decay * pf))

        if state.get("m") is not None:
            _each(upd, params, grads, state["v"], state["m"])
        else:
            _each(upd, params, grads, state["v"])
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

    return Optimizer(init, update, state_axes)


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
