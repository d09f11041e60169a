"""Mixture-of-Experts with capacity-based scatter dispatch.

The JAX package's ``repro/models/moe.py`` (``init_moe``, ``_routing``,
``apply_moe_scatter``): tokens are routed top-k, cut into routing groups,
and *scattered* into a per-group ``(E, capacity)`` buffer; every expert's
SwiGLU runs as one batched product over its rows of the buffer (no Pallas
kernel in the reference: three einsums, here three ``torch.bmm``); the
results are gathered back and combined with the renormalised gates.  A
Switch-style load-balance loss and the router z-loss come back beside the
output, as the reference returns them.

What decides token equality with the reference:

* the router product in float32;
* ``jax.lax.top_k``'s order is ``torch.topk(sorted=True)``'s;
* a choice's position in its expert is the exclusive running count over the
  group's row-major ``(token, k)`` choices; ``capacity = max(1,
  ceil(gsz * k * capacity_factor / E))`` with the group size halved until it
  divides the token count;
* a choice at or past capacity is dropped (the reference's
  ``mode="drop"``): here it lands in one spare row past the buffer, which no
  expert reads;
* the gather-back reads a dropped choice's row at ``capacity - 1`` (the
  reference's indexing clamps) and multiplies it by ``keep = 0``.  No index
  is ever out of range.

Only the scatter dispatch is here: the reference's shard_map expert
parallelism (``apply_moe_ep``) needs a mesh and comes with slice 6 of the
port; ``dispatch="ep"`` raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, MoEConfig
from repro_torch.models.layers import apply_mlp, dtype_of, init_mlp, normal


def init_moe(gen, cfg: ArchConfig, device,
             out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The reference's parameters, scales and layout (the port's own draws;
    the router is float32 whatever the parameter type), written into
    ``out``'s leaves when given."""
    mc = cfg.moe
    dt = dtype_of(cfg.param_dtype)
    d, ff, E = cfg.d_model, mc.d_ff_expert, mc.num_experts
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    o = out or {}
    p = {"router": normal(gen, (d, E), 0.02, torch.float32, device,
                          o.get("router")),
         "w_gate": normal(gen, (E, d, ff), s_in, dt, device, o.get("w_gate")),
         "w_up": normal(gen, (E, d, ff), s_in, dt, device, o.get("w_up")),
         "w_down": normal(gen, (E, ff, d), s_out, dt, device,
                          o.get("w_down"))}
    if mc.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=mc.d_ff_expert * mc.num_shared_experts,
                               out=o.get("shared"))
    return p


def _routing(router_logits: torch.Tensor, mc: MoEConfig, capacity: int):
    """router_logits ``(G, S, E)`` float32 -> ids, gates, pos, keep ``(G,
    S * top_k)`` and the aux and z losses (the reference's results)."""
    G, S, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    gates, ids = torch.topk(probs, mc.top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    ids_flat = ids.reshape(G, S * mc.top_k)
    gates_flat = gates.reshape(G, S * mc.top_k)
    # a choice's position in its expert: the choices of that expert before
    # it -- the reference's exclusive cumsum of the (G, N, E) one-hot over
    # N, taken here as an inclusive cumsum of the (G, E, N) one-hot along
    # its contiguous last axis, read back at the choice's own expert, minus
    # one (the scan over the middle axis took 2.8 ms a layer at olmoe's
    # width-8 prefill on an H100, a quarter of the call)
    experts = torch.arange(E, device=ids.device)[None, :, None]
    onehot = (ids_flat[:, None, :] == experts).to(torch.int32)   # (G, E, N)
    pos = torch.gather(torch.cumsum(onehot, dim=-1, dtype=torch.int32), 1,
                       ids_flat[:, None, :])[:, 0] - 1            # (G, N)
    keep = pos < capacity
    # Switch aux loss: E * sum_e f_e * p_e (f: share dispatched first-choice,
    # p: mean probability)
    f = F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))
    pmean = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f * pmean)
    zloss = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    return ids_flat, gates_flat, pos, keep, aux, zloss


def group_shape(T: int, mc: MoEConfig) -> Tuple[int, int, int]:
    """(group size, groups, capacity per expert and group) for ``T``
    tokens, as the reference derives them."""
    gsz = min(mc.group_size, T)
    while T % gsz:
        gsz //= 2
    capacity = max(1, int(math.ceil(gsz * mc.top_k * mc.capacity_factor
                                    / mc.num_experts)))
    return gsz, T // gsz, capacity


def apply_moe_scatter(p, x: torch.Tensor, cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(B, S, d)`` -> (y ``(B, S, d)``, {"moe_aux", "moe_z"}).  No host
    synchronisation: drops are arithmetic, so a decode step may call it."""
    mc = cfg.moe
    cdt = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    T = B * S
    E, k = mc.num_experts, mc.top_k
    gsz, G, cap = group_shape(T, mc)
    xg = x.reshape(G, gsz, d)
    logits = torch.matmul(xg.float(), p["router"].float())   # (G, gsz, E)
    ids, gates, pos, keep, aux, zloss = _routing(logits, mc, cap)
    N = gsz * k
    dev = x.device
    gidx = torch.arange(G, device=dev)[:, None]               # (G, 1)
    tok = torch.arange(N, device=dev) // k                    # (N,)
    # the buffer is laid out (E, G, cap, d) so each expert's rows are one
    # matrix; row E * G * cap is the spare that takes every dropped choice
    slot = (ids * G + gidx) * cap                             # (G, N)
    dst = torch.where(keep, slot + pos,
                      torch.full((), E * G * cap, device=dev))
    xe = torch.zeros((E * G * cap + 1, d), dtype=cdt, device=dev)
    xe.index_copy_(0, dst.reshape(-1),
                   xg[:, tok].to(cdt).reshape(G * N, d))
    xe = xe[:E * G * cap].view(E, G * cap, d)
    g = torch.bmm(xe, p["w_gate"].to(cdt))
    u = torch.bmm(xe, p["w_up"].to(cdt))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(cdt))      # (E, G*cap, d)
    # gather back: a dropped choice reads row cap - 1 (clamped, as the
    # reference's indexing does) and is zeroed by keep
    src = slot + torch.clamp(pos, max=cap - 1)
    yt = ye.reshape(E * G * cap, d)[src.reshape(-1)].view(G, N, d)
    yt = yt * (gates * keep).to(cdt)[..., None]
    y = yt.reshape(G, gsz, k, d).sum(dim=2).reshape(B, S, d)
    if mc.num_shared_experts and "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    losses = {"moe_aux": aux * mc.aux_loss_weight, "moe_z": zloss * 1e-3}
    return y, losses


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(B, S, d)`` -> (y, aux losses), by scatter dispatch."""
    if cfg.moe.dispatch == "ep":
        raise NotImplementedError(
            "MoE expert parallelism (dispatch='ep', the reference's "
            "apply_moe_ep) needs a mesh and comes with slice 6 of the port "
            "(ROADMAP.md)")
    return apply_moe_scatter(p, x, cfg)
