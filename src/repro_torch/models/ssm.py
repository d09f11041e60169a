"""Mamba-2 (SSD) mixer block -- arXiv:2405.21060.

The JAX package's ``repro/models/ssm.py`` as plain functions on tensors.
Block: in_proj -> [z | xBC | dt]; causal depthwise conv + SiLU on xBC;
SSD scan over (x, B, C) with per-head decay A*dt (the scan kernel through
:func:`repro_torch.kernels.ops.ssd`); +D skip; gated RMSNorm (y * silu(z));
out_proj.  Decode keeps (ssm_state, conv_state).

One difference of layout, not of numbers: with one group, B and C are
viewed over every head with a head stride of 0 (the reference repeats them
per head), so the scan reads one copy.  :func:`checkpoint_slot_state` and
:func:`restore_slot_state` take one slot's row of the decode state out and
write it back in place, for swap preemption.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dtype_of, filled, normal


def ssm_dims(cfg: ArchConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    n_heads = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.n_groups * sc.d_state
    d_in_proj = 2 * d_inner + 2 * sc.n_groups * sc.d_state + n_heads
    return d_inner, n_heads, conv_dim, d_in_proj


def _uniform(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """``n`` draws of U[0, 1) in float32 (meta: shape only)."""
    if torch.device(device or "cpu").type == "meta":
        return torch.empty((n,), dtype=torch.float32, device=device)
    return torch.rand((n,), generator=gen, dtype=torch.float32, device=device)


def init_ssm(gen: torch.Generator, cfg: ArchConfig, device,
             out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The reference's parameters, scales and layout (the port's own
    draws), written into ``out``'s leaves when given."""
    sc = cfg.ssm
    dt = dtype_of(cfg.param_dtype)
    d_inner, H, conv_dim, d_in_proj = ssm_dims(cfg)
    s_in = 0.02
    s_out = 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))
    lo, hi = sc.a_init_range
    a_init = torch.log(lo + (hi - lo) * _uniform(gen, H, device))
    # dt bias: softplus^-1 of dt sampled log-uniform in [dt_min, dt_max]
    dts = torch.exp(_uniform(gen, H, device) *
                    (np.log(sc.dt_max) - np.log(sc.dt_min)) + np.log(sc.dt_min))
    dt_bias = dts + torch.log(-torch.expm1(-dts))
    o = out or {}
    if out is not None:
        a_init = out["a_log"].copy_(a_init)
        dt_bias = out["dt_bias"].copy_(dt_bias)
    f32 = torch.float32
    return {
        "in_proj": normal(gen, (cfg.d_model, d_in_proj), s_in, dt, device,
                          o.get("in_proj")),
        "conv_w": normal(gen, (sc.d_conv, conv_dim), 0.2, dt, device,
                         o.get("conv_w")),
        "conv_b": filled(0.0, (conv_dim,), dt, device, o.get("conv_b")),
        "a_log": a_init,
        "dt_bias": dt_bias,
        "d_skip": filled(1.0, (H,), f32, device, o.get("d_skip")),
        "norm_scale": filled(1.0, (d_inner,), dt, device,
                             o.get("norm_scale")),
        "out_proj": normal(gen, (d_inner, cfg.d_model), s_out, dt, device,
                           o.get("out_proj")),
    }


def _causal_conv(x, w, b):
    """x: (B, L, C); w: (W, C); depthwise causal conv + SiLU."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    y = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(W))
    return F.silu(y + b[None, None, :])


def _split_proj(zxbcdt, cfg: ArchConfig):
    d_inner, H, conv_dim, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt_raw


def _expand_groups(t, H: int, n_groups: int):
    """(B, L, G*N) -> (B, L, H, N), each group over its heads.  One group
    stays a view (head stride 0); several are copied, as the reference's
    ``jnp.repeat`` does."""
    B, L = t.shape[0], t.shape[1]
    N = t.shape[-1] // n_groups
    rep = H // n_groups
    t = t.reshape(B, L, n_groups, 1, N).expand(B, L, n_groups, rep, N)
    return t.reshape(B, L, H, N)


def _gated_norm(y, z, scale, cdt):
    g = y * F.silu(z)
    gf = g.float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + 1e-6) * scale.float()).to(cdt)


def apply_ssm(p, x, cfg: ArchConfig, *, return_state: bool = False):
    """Full-sequence SSD mixer.  x: (B, L, d_model)."""
    sc = cfg.ssm
    cdt = dtype_of(cfg.compute_dtype)
    d_inner, H, conv_dim, _ = ssm_dims(cfg)
    B_, L, _ = x.shape
    zxbcdt = torch.matmul(x, p["in_proj"].to(cdt))
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc_raw = xbc
    xbc = _causal_conv(xbc, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
    xs = xbc[..., :d_inner]
    gn = sc.n_groups * sc.d_state
    Bm = _expand_groups(xbc[..., d_inner:d_inner + gn], H, sc.n_groups)
    Cm = _expand_groups(xbc[..., d_inner + gn:], H, sc.n_groups)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])   # (B,L,H)
    A = -torch.exp(p["a_log"])                                      # (H,)
    a = A[None, None, :] * dt
    xh = xs.reshape(B_, L, H, sc.head_dim)
    y, h_final = ops.ssd(xh, dt, a, Bm, Cm, chunk=min(sc.chunk_size, L))
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(B_, L, d_inner).to(cdt)
    out = torch.matmul(_gated_norm(y, z, p["norm_scale"], cdt),
                       p["out_proj"].to(cdt))
    if return_state:
        W = sc.d_conv
        conv_state = xbc_raw[:, L - (W - 1):, :].float()
        return out, {"ssm": h_final, "conv": conv_state}
    return out


def init_ssm_state(cfg: ArchConfig, batch: int, device=None
                   ) -> Dict[str, torch.Tensor]:
    sc = cfg.ssm
    d_inner, H, conv_dim, _ = ssm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((batch, H, sc.head_dim, sc.d_state), **f32),
            "conv": torch.zeros((batch, sc.d_conv - 1, conv_dim), **f32)}


def checkpoint_slot_state(state: Any, slot: int) -> Any:
    """One slot's SSM decode state as fixed-width records.

    ``state`` is a stage-stacked decode-state tree (dicts of tensors whose
    leaves lead with ``(n_stages, capacity, ...)``: the ``(n_stages,
    capacity, H, P, N)`` SSD state and the ``(n_stages, capacity, W-1,
    conv_dim)`` convolution window); the record drops the capacity axis, so
    its shapes depend only on the arch.  The leaves are copies on the
    state's device, enqueued on the current stream: reading a quiesced row
    is bitwise, so a checkpoint followed by :func:`restore_slot_state`
    gives back the same bits."""
    if isinstance(state, dict):
        return {k: checkpoint_slot_state(v, slot) for k, v in state.items()}
    return state[:, slot].clone()


def restore_slot_state(state: Any, slot: int, record: Any) -> Any:
    """Write a :func:`checkpoint_slot_state` record back into ``slot``'s row
    of ``state``, in place (every tensor keeps its storage, so a captured
    decode round reads the restored row); other rows are untouched.
    Returns ``state``."""
    if isinstance(state, dict):
        for k, v in state.items():
            restore_slot_state(v, slot, record[k])
        return state
    state[:, slot].copy_(record, non_blocking=True)
    return state


def apply_ssm_decode(p, x, state: Dict[str, torch.Tensor], cfg: ArchConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d_model).  Returns (out, new state);
    the caller decides where the new state goes."""
    sc = cfg.ssm
    cdt = dtype_of(cfg.compute_dtype)
    d_inner, H, conv_dim, _ = ssm_dims(cfg)
    B_ = x.shape[0]
    zxbcdt = torch.matmul(x, p["in_proj"].to(cdt))
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc_t = xbc[:, 0]                                          # (B, conv_dim)
    # rolling causal conv
    conv_in = torch.cat([state["conv"].to(cdt), xbc_t[:, None, :]], dim=1)
    w = p["conv_w"].to(cdt)
    y_conv = torch.einsum("bwc,wc->bc", conv_in, w) + p["conv_b"].to(cdt)
    xbc_t = F.silu(y_conv)
    new_conv = conv_in[:, 1:, :].to(state["conv"].dtype)

    xs = xbc_t[..., :d_inner]
    gn = sc.n_groups * sc.d_state
    Bm = _expand_groups(xbc_t[:, None, d_inner:d_inner + gn], H,
                        sc.n_groups)[:, 0]
    Cm = _expand_groups(xbc_t[:, None, d_inner + gn:], H, sc.n_groups)[:, 0]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None, :])
    A = -torch.exp(p["a_log"])
    a = A[None, :] * dt
    xh = xs.reshape(B_, H, sc.head_dim)
    y, new_ssm = ops.ssd_decode_step(state["ssm"], xh, dt, a, Bm, Cm)
    y = y + p["d_skip"][None, :, None] * xh.float()
    y = y.reshape(B_, 1, d_inner).to(cdt)
    out = torch.matmul(_gated_norm(y, z, p["norm_scale"], cdt),
                       p["out_proj"].to(cdt))
    return out, {"ssm": new_ssm, "conv": new_conv}
