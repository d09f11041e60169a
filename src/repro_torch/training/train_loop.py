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

On a mesh (``sh.mesh``) the parameters and the optimizer state live as
shards (:class:`repro_torch.distributed.sharding.ShardedTensor`).  A step
gathers the parameters on the mesh's first device, runs the loss and the
backward there over the whole batch (the routed experts per position where
the dispatch is expert-parallel), takes the global norm from the full
gradients in the same order as with no mesh (the clip scale is the same
bits), cuts the clipped gradients into the parameters' shards and updates
each shard on its device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed.sharding import (Sharder, ShardedTensor,
                                              home_device, layout,
                                              null_sharder)
from repro_torch.models.model import ModelBundle
from repro_torch.models.params import param_axes
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.training.optimizer import (Optimizer, lr_schedule,
                                            make_optimizer)


def init_train_state(bundle: ModelBundle, opt: Optimizer, params,
                     sh: Optional[Sharder] = None) -> Dict[str, Any]:
    """{"params", "opt", "step"}; the step is an int32 0-d tensor on the
    parameters' (first) device.  On ``sh``'s mesh the parameters are
    placed already and the optimizer state is placed by its
    ``state_axes``."""
    on_mesh = sh is not None and sh.mesh is not None
    return {"params": params,
            "opt": (opt.init(params, sh, param_axes(bundle.cfg)) if on_mesh
                    else opt.init(params)),
            "step": torch.zeros((), dtype=torch.int32,
                                device=home_device(tree_leaves(params)[0]))}


def build_train_step(bundle: ModelBundle, sh: Optional[Sharder] = None,
                     opt: Optional[Optimizer] = None,
                     lr_fn: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place and returned; metrics ``loss``, ``xent``, ``aux``,
    ``grad_norm`` and ``lr`` are 0-d device tensors.  ``sh`` None is the
    null sharder (no mesh)."""
    cfg = bundle.cfg
    sh = sh or null_sharder()
    opt = opt or make_optimizer(cfg)
    lr_fn = lr_fn or lr_schedule(cfg)
    n_mb = max(1, cfg.microbatches)

    def value_and_grad(leaves, params, batch):
        loss, metrics = bundle.loss_fn(params, batch, sh)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics["aux"].detach(), metrics, grads

    def train_step(state, batch):
        placed = state["params"]
        on_mesh = isinstance(tree_leaves(placed)[0], ShardedTensor)
        # on a mesh: the global parameters on the first device (no copy of
        # a leaf the mesh does not split)
        params = tree_map(lambda t: t.full().detach(), placed) if on_mesh \
            else placed
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
        if on_mesh:
            del params, leaves
            # each clipped gradient cut into its parameter's shards
            grads = [layout(g, p.mesh, p.spec)
                     for g, p in zip(grads, tree_leaves(placed))]
        lr = lr_fn(state["step"])
        it = iter(grads)
        opt.update(tree_map(lambda _: next(it), placed), state["opt"], placed,
                   lr)
        state["step"] += 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return state, metrics

    return train_step


def build_eval_step(bundle: ModelBundle, sh: Optional[Sharder] = None
                    ) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        params = tree_map(lambda t: t.full()
                          if isinstance(t, ShardedTensor) else t, params)
        loss, metrics = bundle.loss_fn(params, batch, sh)
        return dict(metrics, loss=loss)
    return eval_step
