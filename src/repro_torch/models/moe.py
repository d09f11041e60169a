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

Expert parallelism (``apply_moe_ep``, the reference's shard_map path) runs
on a mesh: every position routes its own block of tokens (batch over
``("pod", "data")``, sequence over ``"model"``), buckets its choices by the
``"model"`` shard that holds their expert, exchanges them along its
``"model"`` row (:func:`repro_torch.distributed.sharding.all_to_all`),
dispatches what it received to its ``E/M`` local experts, and sends the
results back to be combined with its gates.  :func:`apply_moe` takes that
path exactly where the reference does (``dispatch == "ep"`` or
``REPRO_MOE_DISPATCH=ep``, a mesh, and shapes the mesh divides) and the
scatter path everywhere else.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, MoEConfig
from repro_torch.distributed.sharding import (Sharder, ShardedTensor,
                                              all_to_all, pmean,
                                              spec_index_map)
from repro_torch.models.layers import apply_mlp, dtype_of, init_mlp, normal

# when a list, every routed call appends the choices it dropped (a 0-d
# int64 tensor on the input's device: no host synchronisation)
dropped_log: Optional[List[torch.Tensor]] = None


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


def apply_moe_scatter(p, x: torch.Tensor, cfg: ArchConfig,
                      sh: Optional[Sharder] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(B, S, d)`` -> (y ``(B, S, d)``, {"moe_aux", "moe_z"}).  No host
    synchronisation: drops are arithmetic, so a decode step may call it.
    Computed once, over the whole batch, on a mesh too (``sh`` unused: the
    reference only constrains its layout)."""
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
    if dropped_log is not None:
        dropped_log.append((~keep).sum())
    yt = ye.reshape(E * G * cap, d)[src.reshape(-1)].view(G, N, d)
    yt = yt * (gates * keep).to(cdt)[..., None]
    y = yt.reshape(G, gsz, k, d).sum(dim=2).reshape(B, S, d)
    if mc.num_shared_experts and "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    losses = {"moe_aux": aux * mc.aux_loss_weight, "moe_z": zloss * 1e-3}
    return y, losses


def _dispatch_mode(mc: MoEConfig) -> str:
    return os.environ.get("REPRO_MOE_DISPATCH", mc.dispatch)


def ep_applies(x_shape, cfg: ArchConfig, sh: Optional[Sharder]) -> bool:
    """Whether :func:`apply_moe` takes the expert-parallel path for an
    input of ``x_shape``: the reference's test -- dispatch ``"ep"``, a
    mesh, ``M > 1`` and B, S and E divisible by the data extent, M and M."""
    if _dispatch_mode(cfg.moe) != "ep" or sh is None or sh.mesh is None:
        return False
    B, S = x_shape[0], x_shape[1]
    shape = dict(sh.mesh.shape)
    M = shape.get("model", 1)
    n_dp = math.prod(v for a, v in shape.items() if a in ("pod", "data"))
    return (M > 1 and B % max(n_dp, 1) == 0 and S % M == 0
            and cfg.moe.num_experts % M == 0)


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig,
              sh: Optional[Sharder] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``(B, S, d)`` -> (y, aux losses): expert-parallel where
    :func:`ep_applies`, else by scatter dispatch."""
    if ep_applies(x.shape, cfg, sh):
        return apply_moe_ep(p, x, cfg, sh)
    return apply_moe_scatter(p, x, cfg, sh)


# ---------------------------------------------------------------------------
# expert parallelism over the "model" mesh axis
# ---------------------------------------------------------------------------
def _capacity_scatter(x: torch.Tensor, ids: torch.Tensor, n_bins: int,
                      cap: int, valid: Optional[torch.Tensor] = None):
    """Rows of ``x`` ``(N, d)`` into a ``(n_bins, cap, d)`` buffer by bin id,
    each at its exclusive running count in its bin; returns (buffer, pos,
    keep), ``pos`` clipped to ``cap`` where not kept.  A row not ``valid``
    still takes its place in the count (the reference's one-hot counts
    every row), and is never kept."""
    onehot = (ids[:, None] == torch.arange(n_bins, device=ids.device)
              ).to(torch.int32)                                  # (N, bins)
    pos = torch.sum((torch.cumsum(onehot, dim=0, dtype=torch.int32)
                     - onehot) * onehot, dim=-1)
    keep = pos < cap
    if valid is not None:
        keep = keep & valid
    pos_c = torch.where(keep, pos, torch.full_like(pos, cap))
    # the spare row n_bins * cap takes every row not kept
    dst = torch.where(keep, ids.long() * cap + pos_c.long(),
                      torch.full_like(pos_c, n_bins * cap, dtype=torch.long))
    buf = torch.zeros((n_bins * cap + 1, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_add(0, dst, torch.where(keep[:, None], x,
                                            torch.zeros((), dtype=x.dtype,
                                                        device=x.device)))
    return buf[:n_bins * cap].view(n_bins, cap, x.shape[-1]), pos_c, keep


def apply_moe_ep(p, x: torch.Tensor, cfg: ArchConfig, sh: Sharder
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's shard_map expert parallelism, position by position
    on each position's device.  ``x`` ``(B, S, d)`` is cut into the
    positions' blocks; the output blocks are gathered back on the mesh's
    first device.  Autograd goes back through every exchange.  The aux and
    z losses are the reference's: the per-position dispatch fractions, mean
    probabilities and z terms averaged over every position first."""
    mc = cfg.moe
    mesh = sh.mesh
    cdt = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    k, E = mc.top_k, mc.num_experts
    axes = tuple(mesh.axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    M = mesh.shape.get("model", 1)
    if E % M:
        raise ValueError(f"{E} experts do not split {M} ways")
    e_loc = E // M
    t_loc = B * S // mesh.size
    # per-destination-shard send capacity and per-expert local capacity
    cap_s = max(1, int(math.ceil(t_loc * k * mc.capacity_factor / M)))
    cap_e = max(1, int(math.ceil(M * cap_s / e_loc)))
    blk_spec = (dp_axes if len(dp_axes) != 1 else dp_axes[0],
                "model" if "model" in axes else None, None)
    ew_spec = ("model" if "model" in axes else None, None, None)
    # the fsdp gather of the expert weights, then each position's E/M
    ws = [sh.relayout(p[n].to(cdt), ew_spec).locals
          for n in ("w_gate", "w_up", "w_down")]
    devs = mesh.position_devices()
    blocks = spec_index_map(mesh, blk_spec, x.shape)
    n_pos = mesh.size

    routed = []                # per position: (dest, pos_s, keep_s, gates)
    sends, eids, stats = [], [], []
    for q in range(n_pos):
        dev = devs[q]
        xb = x[blocks[q]].to(dev)
        b_loc, s_loc = xb.shape[0], xb.shape[1]
        xt = xb.reshape(b_loc * s_loc, d)
        logits = torch.matmul(xt.float(), p["router"].float().to(dev))
        probs = torch.softmax(logits, dim=-1)
        gates, ids = torch.topk(probs, k, dim=-1, sorted=True)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        first = ids[:, 0, None] == torch.arange(E, device=dev)
        stats.append((first.float().mean(dim=0),
                      probs.mean(dim=0),
                      torch.mean(torch.logsumexp(logits, dim=-1) ** 2)))
        ids_f = ids.reshape(-1)
        xk = xt.to(cdt).repeat_interleave(k, dim=0)
        dest = ids_f // e_loc
        send, pos_s, keep_s = _capacity_scatter(xk, dest, M, cap_s)
        # the local expert id rides beside the payload, +1 so 0 is empty
        eid = torch.zeros(M * cap_s + 1, dtype=torch.int32, device=dev)
        slot = torch.where(keep_s, dest * cap_s + pos_s,
                           torch.full_like(pos_s, M * cap_s))
        eid = eid.index_add(0, slot.long(), torch.where(
            keep_s, (ids_f % e_loc + 1).to(torch.int32),
            torch.zeros((), dtype=torch.int32, device=dev)))
        sends.append(send)
        eids.append(eid[:M * cap_s].view(M, cap_s))
        routed.append((dest, pos_s, keep_s, gates))
    recv = all_to_all(mesh, sends, "model")
    recv_eid = all_to_all(mesh, eids, "model")

    slots_back, kept = [], []
    for q in range(n_pos):
        rx = recv[q].reshape(M * cap_s, d)
        re = recv_eid[q].reshape(M * cap_s)
        e_of = torch.clamp(re - 1, min=0)
        buf, pos_e, keep_e = _capacity_scatter(rx, e_of, e_loc, cap_e,
                                               valid=re > 0)
        kept.append(keep_e.sum())
        wg, wu, wd = (w[q] for w in ws)
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        y_e = torch.bmm(h, wd)                               # (e_loc, cap_e, d)
        # a slot not kept reads row cap_e - 1 (the reference's indexing
        # clamps) and is zeroed
        y_slots = y_e[e_of.long(), torch.clamp(pos_e, max=cap_e - 1).long()]
        y_slots = torch.where(keep_e[:, None], y_slots,
                              torch.zeros((), dtype=y_slots.dtype,
                                          device=y_slots.device))
        slots_back.append(y_slots.view(M, cap_s, d))
    back = all_to_all(mesh, slots_back, "model")

    ys = []
    for q in range(n_pos):
        dest, pos_s, keep_s, gates = routed[q]
        y_tok = back[q][dest, torch.clamp(pos_s, max=cap_s - 1)]
        y_tok = torch.where(keep_s[:, None], y_tok,
                            torch.zeros((), dtype=y_tok.dtype,
                                        device=y_tok.device))
        blk = [sl.stop - sl.start for sl in blocks[q]]
        y = (y_tok.view(blk[0] * blk[1], k, d)
             * gates[..., None].to(cdt)).sum(dim=1)
        ys.append(y.view(blk[0], blk[1], d))
    y = ShardedTensor.from_locals(mesh, blk_spec, ys).full(x.device)
    if dropped_log is not None:
        dropped_log.append(B * S * k - sum(n.to(x.device) for n in kept))

    f_bar, p_bar, z_bar = (pmean(mesh, [st[i] for st in stats])[0]
                           for i in range(3))
    aux = E * torch.sum(f_bar * p_bar)
    if mc.num_shared_experts and "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    losses = {"moe_aux": aux.to(x.device) * mc.aux_loss_weight,
              "moe_z": z_bar.to(x.device) * 1e-3}
    return y, losses
