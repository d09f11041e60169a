"""Train-step builder with tenant-microbatch accumulation.

The JAX package's ``repro/training/train_loop.py``.  The paper's
multi-tenancy maps to training as the microbatch loop: the global batch is
split into ``cfg.microbatches`` tenant chunks processed one after another,
their float32 gradients summed, so each tenant's host->device staging can
overlap the previous tenant's compute (the feed's side of that overlap is
:class:`repro_torch.data.tokens.PrefetchFeed`) and activation memory stays
bounded.

A step is value and grad of ``bundle.loss_fn`` (``torch.autograd.grad``
over the parameter leaves, one backward per chunk), the global-norm clip
at 1.0, the learning rate of the state's step, and the optimizer's update,
written in place.  Nothing in a step waits for the device: the metrics come
back as device tensors, and the caller reads them after the step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.models.model import ModelBundle
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.training.optimizer import (Optimizer, lr_schedule,
                                            make_optimizer)


def init_train_state(bundle: ModelBundle, opt: Optimizer, params
                     ) -> Dict[str, Any]:
    """{"params", "opt", "step"}; the step is an int32 0-d tensor on the
    parameters' device."""
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def build_train_step(bundle: ModelBundle, opt: Optional[Optimizer] = None,
                     lr_fn: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place and returned; metrics ``loss``, ``xent``, ``aux``,
    ``grad_norm`` and ``lr`` are 0-d device tensors."""
    cfg = bundle.cfg
    opt = opt or make_optimizer(cfg)
    lr_fn = lr_fn or lr_schedule(cfg)
    n_mb = max(1, cfg.microbatches)

    def value_and_grad(leaves, params, batch):
        loss, metrics = bundle.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics["aux"].detach(), metrics, grads

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        if n_mb == 1:
            loss, _, metrics, grads = value_and_grad(leaves, params, batch)
            metrics = {"xent": metrics["xent"].detach(),
                       "aux": metrics["aux"].detach()}
        else:
            mbs = []
            for k, x in batch.items():
                b = x.shape[0]
                if b % n_mb:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"{n_mb} microbatches")
                mbs.append((k, x.reshape((n_mb, b // n_mb) + x.shape[1:])))
            acc: List[torch.Tensor] = []
            loss_sum = aux_sum = 0.0
            for i in range(n_mb):
                loss, aux, _, g = value_and_grad(
                    leaves, params, {k: x[i] for k, x in mbs})
                if acc:
                    for a, gi in zip(acc, g):
                        a.add_(gi)
                else:
                    acc = [gi.float() if gi.dtype != torch.float32 else gi
                           for gi in g]
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + aux
            grads = [a.div_(n_mb) for a in acc]
            loss = loss_sum / n_mb
            metrics = {"xent": loss - aux_sum / n_mb, "aux": aux_sum / n_mb}

        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        # global-norm clip at 1.0
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = [g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
                 for g in grads]
        lr = lr_fn(state["step"])
        it = iter(grads)
        opt.update(tree_map(lambda _: next(it), params), state["opt"], params,
                   lr)
        state["step"] += 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return state, metrics

    return train_step


def build_eval_step(bundle: ModelBundle) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = bundle.loss_fn(params, batch)
        return dict(metrics, loss=loss)
    return eval_step
