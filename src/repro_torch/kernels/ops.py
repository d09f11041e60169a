"""Dispatch layer of the kernel package; the risk, serving and model stacks
import only from here.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain version — the tensor's device decides, and there is no switch that
routes a CUDA tensor to a plain version (the reference's
``kernel_backend="jnp"`` dense gather is the paged decode's plain version,
for CPU tensors only).  What can be chosen is the lookup strategy of
``aggregate_loss`` (:func:`use_aggregate_variant`, or the
``REPRO_AGG_VARIANT`` environment variable, checked when this module is
imported).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import aggregate_loss as _agg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd

# single source of truth for aggregate_loss lookup strategies
_AGG_KERNELS = {"gather": _agg.aggregate_loss_gather,
                "onehot": _agg.aggregate_loss_onehot}
AGG_VARIANTS = tuple(_AGG_KERNELS)


def _env_agg_variant() -> str:
    """Fail fast (at import) on a misconfigured REPRO_AGG_VARIANT instead of
    deferring to an error deep inside the dispatch."""
    v = os.environ.get("REPRO_AGG_VARIANT", "gather")
    if v not in AGG_VARIANTS:
        raise ValueError(
            f"REPRO_AGG_VARIANT={v!r}: must be one of {AGG_VARIANTS}")
    return v


_STATE = {"agg_variant": _env_agg_variant()}


def use_aggregate_variant(name: str) -> None:
    """Select the aggregate_loss lookup strategy: "gather" (ELT rows read
    from global memory) or "onehot" (gather-free one-hot x ELT-tile product).
    Also settable via REPRO_AGG_VARIANT."""
    if name not in AGG_VARIANTS:
        raise ValueError(f"variant {name!r}: must be one of {AGG_VARIANTS}")
    _STATE["agg_variant"] = name


def aggregate_variant() -> str:
    return _STATE["agg_variant"]


def aggregate_loss(event_ids, elt_losses, occ_ret, occ_lim, agg_ret, agg_lim,
                   chunk: int = 128, variant: Optional[str] = None):
    """Year-loss per trial (paper Algorithm 3).

    The event axis is walked in ``chunk``-sized steps; a ragged last step is
    masked by the kernel, never padded by a copy.  ``variant`` overrides the
    configured lookup strategy (see :func:`use_aggregate_variant`)."""
    variant = variant or _STATE["agg_variant"]
    if variant not in AGG_VARIANTS:
        raise ValueError(f"variant {variant!r}: must be one of {AGG_VARIANTS}")
    return _AGG_KERNELS[variant](event_ids, elt_losses, occ_ret, occ_lim,
                                 agg_ret, agg_lim, chunk=chunk)


def _pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (b, L, ...) with ``pad`` zero steps appended.  A head axis of
    stride 0 (one group's B or C viewed over every head) stays a view: the
    group is padded once, not each head."""
    if t.dim() == 4 and t.shape[2] > 1 and t.stride(2) == 0:
        one = torch.nn.functional.pad(t[:, :, :1], (0, 0, 0, 0, 0, pad))
        return one.expand(t.shape[0], t.shape[1] + pad, *t.shape[2:])
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd(x, dt, a_log_decay, B, C, chunk: int,
        initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan; see :func:`repro_torch.kernels.ref.ssd_chunked_ref`
    for the contract (the scan kernel of
    :func:`repro_torch.kernels.ssd_scan.ssd_chunked` on a CUDA device, its
    plain version on the CPU).

    Pads the sequence up to a chunk multiple (dt=0, a=0 pads are
    state-neutral: decay exp(0)=1 and zero input leave the recurrence
    unchanged)."""
    L = x.shape[1]
    pad = (-L) % chunk
    if pad:
        y, h = ssd(*(_pad_steps(t, pad) for t in (x, dt, a_log_decay, B, C)),
                   chunk, initial_state)
        return y[:, :L], h
    return _ssd.ssd_chunked(x, dt, a_log_decay, B, C, chunk=chunk,
                            initial_state=initial_state)


def ssd_decode_step(state, x_t, dt_t, a_t, B_t, C_t):
    """One SSD decode step: a composite of a few elementwise operations and
    one product (the reference has no kernel for it)."""
    return _ref.ssd_decode_step_ref(state, x_t, dt_t, a_t, B_t, C_t)


def paged_attention_decode(q, k_pool, v_pool, pos_pool, page_table,
                           positions, window: Optional[int] = None):
    """One-token GQA decode read through a page table (see
    :func:`repro_torch.kernels.paged_attention.paged_attention_decode`)."""
    return _paged.paged_attention_decode(q, k_pool, v_pool, pos_pool,
                                         page_table, positions, window=window)


def paged_prefill_scatter(pool, pages, values):
    """Page blocks ``values`` (S, nb, P, Hkv, D) into ``pool``'s pages
    ``pages``, in place (see
    :func:`repro_torch.kernels.paged_attention.paged_prefill_scatter`)."""
    return _paged.paged_prefill_scatter(pool, pages, values)


def paged_admit_kv(k_pool, v_pool, pos_pool, pages, k_src, v_src, pos_src):
    """One attention sub-layer's admission, K, V and positions in one launch
    (see :func:`repro_torch.kernels.paged_attention.paged_admit_kv`)."""
    _paged.paged_admit_kv(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                          pos_src)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill attention forward (see
    :func:`repro_torch.kernels.flash_attention.flash_attention`): the
    FlashAttention kernel for CUDA tensors, for CPU tensors its plain
    version -- the reference layers' ``blockwise_attention``."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def counters() -> List[Dict[str, int]]:
    """Every kernel module's count dicts (launches, plain-version calls,
    variants).  A wrapper counts when its Python runs, so launches captured
    into a CUDA graph count once, at capture; the graph's owner takes the
    capture's counts back out and adds them at every replay."""
    return [getattr(m, name) for m in (_agg, _flash, _paged, _ssd)
            for name in ("launch_counts", "plain_counts", "variant_counts")
            if hasattr(m, name)]


def detach_decode_scratch(device: torch.device, stream: int):
    """The paged decode kernel's scratch for ``stream``, taken out of its
    cache for a CUDA graph that captured launches on that stream (see
    :func:`repro_torch.kernels.paged_attention.detach_scratch`)."""
    return _paged.detach_scratch(device, stream)
