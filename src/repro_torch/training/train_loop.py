"""Train-step builder with tenant-microbatch accumulation.

The JAX package's ``repro/training/train_loop.py``.  The paper's
multi-tenancy maps to training as the microbatch loop: the global batch is
split into ``cfg.microbatches`` tenant chunks processed one after another,
their float32 gradients summed, so each tenant's host->device staging can
overlap the previous tenant's compute (the feed's side of that overlap is
:class:`repro_torch.data.tokens.PrefetchFeed`) and activation memory stays
bounded.

A step is value and grad of ``bundle.loss_fn`` (one backward per chunk),
the global-norm clip at 1.0, the learning rate of the state's step, and
the optimizer's update, written in place.  A stacked leaf's stages enter
the forward as leaves of their own, and the backward writes each stage's
gradient into the leaf's float32 gradient, allocated before the forward,
the moment it is complete: no stage's gradient is kept beside it and none
is stacked (olmoe-1b-7b's (16, 64, 2048, 1024) expert leaves would
otherwise need a second 8 GiB block each at the end of the backward).  Nothing in a step waits for the device: the metrics come
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

import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed.sharding import (Sharder, ShardedTensor,
                                              home_device, layout,
                                              null_sharder)
from repro_torch.models.model import ModelBundle
from repro_torch.models.params import param_axes
from repro_torch.models.transformer import (STACKED, stage_leaves,
                                            tree_leaves, tree_map)
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


def _take_grad(dst: torch.Tensor, first: list, leaf: torch.Tensor) -> None:
    """A stage leaf's post-accumulate hook: its gradient written into
    ``dst`` (the step's first backward) or added to it, then freed."""
    if first[0]:
        dst.copy_(leaf.grad)
    else:
        dst.add_(leaf.grad)
    leaf.grad = None


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
        # a stacked leaf's stages enter the forward as leaves of their own;
        # the backward writes each stage's gradient into the leaf's float32
        # buffer as soon as it is complete and frees it: no stage-sized
        # gradient outlives its stage, and none is stacked
        stacked = {id(t) for k in STACKED if k in params
                   for t in tree_leaves(params[k])}
        grads = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
                 if id(p) in stacked else None for p in leaves]
        stages_of, first = {}, [True]
        for j, p in enumerate(leaves):
            if id(p) not in stacked:
                continue
            stages_of[id(p)] = []
            for i in range(p.shape[0]):
                v = p[i].detach().requires_grad_(True)
                v.register_post_accumulate_grad_hook(
                    functools.partial(_take_grad, grads[j][i], first))
                stages_of[id(p)].append(v)
        inputs = [v for vs in stages_of.values() for v in vs] + \
            [p for p in leaves if id(p) not in stacked]

        def value_and_grad(batch):
            """The loss and aux of ``batch``; the gradients added into
            ``grads`` (written, on the first call)."""
            for p in leaves:
                p.grad = None
            with stage_leaves(stages_of):
                loss, metrics = bundle.loss_fn(params, batch, sh)
            loss.backward(inputs=inputs)
            for j, p in enumerate(leaves):
                if id(p) in stacked:
                    continue
                g = p.grad.float()
                if first[0]:
                    grads[j] = g
                else:
                    grads[j].add_(g)
                p.grad = None
            first[0] = False
            return loss.detach(), metrics

        if n_mb == 1:
            loss, metrics = value_and_grad(batch)
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
            loss_sum = aux_sum = 0.0
            for i in range(n_mb):
                loss, m = value_and_grad({k: x[i] for k, x in mbs})
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + m["aux"].detach()
            grads = [g.div_(n_mb) for g in grads]
            loss = loss_sum / n_mb
            metrics = {"xent": loss - aux_sum / n_mb, "aux": aux_sum / n_mb}

        # a stacked leaf's square sum a stage at a time (no leaf-sized
        # temporary)
        gnorm = torch.sqrt(sum(
            sum(torch.sum(s * s) for s in g) if id(p) in stacked
            else torch.sum(g ** 2) for p, g in zip(leaves, grads)))
        # global-norm clip at 1.0
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = [g.mul_(scale) for g in grads]
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
