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

Training differentiates through the two kernels of the model's forward with
two ``torch.autograd.Function``s, where the reference keeps its custom VJPs:
:class:`FlashAttentionFn` (the FlashAttention kernel forward, with its
log-sum-exp; the reference's blockwise backward) and :class:`SsdChunkedFn`
(the SSD scan kernel forward; the backward recomputes the chunked oracle
and differentiates it, as the reference's ``_ssd_pallas_vjp`` does).  The
forward is the kernel on the card, never a plain version; the backward is
the reference's own, which has no Pallas kernel either.  :func:`flash_attention`
and :func:`ssd` take a ``Function`` only when grad mode is on and an input
requires grad; otherwise (every serving path, CUDA graph captures
included) they call the kernel wrapper directly.

Inside :func:`shape_only` (``launch/dryrun.py``'s pass, which computes
shapes, not numbers) a meta tensor is routed here, explicitly, to the
kernel's plain computation -- the reference's blockwise attention, the
chunked SSD oracle -- uncounted: no kernel is launched and no plain version
runs on data.  Every other call goes to the wrapper, which launches the
kernel for a CUDA tensor, runs the plain version for a CPU tensor, and
raises for anything else (a meta tensor outside the pass included).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import aggregate_loss as _agg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.attention_core import blockwise_attention_bwd

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


_STATE = {"agg_variant": _env_agg_variant(), "shape_only": False}


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
    if _differentiable(x, dt, a_log_decay, B, C, initial_state):
        return SsdChunkedFn.apply(x, dt, a_log_decay, B, C, initial_state,
                                  chunk)
    return _ssd_forward(x, dt, a_log_decay, B, C, chunk, initial_state)


def _ssd_forward(x, dt, a, B, C, chunk: int, h0):
    """The scan kernel's wrapper, or in the dry-run's pass over meta tensors
    its plain computation (shapes only)."""
    if _meta_pass(x):
        return _ref.ssd_chunked_ref(x, dt, a, B, C, chunk, initial_state=h0)
    return _ssd.ssd_chunked(x, dt, a, B, C, chunk=chunk, initial_state=h0)


@contextlib.contextmanager
def shape_only():
    """Within: a meta tensor takes the kernels' plain computation (the
    dry-run's pass over meta tensors); outside, the wrappers refuse it."""
    before, _STATE["shape_only"] = _STATE["shape_only"], True
    try:
        yield
    finally:
        _STATE["shape_only"] = before


def _meta_pass(t: torch.Tensor) -> bool:
    return t.device.type == "meta" and _STATE["shape_only"]


# the plain computation's blocks on the meta device: every block is
# computed either way, so the operations are the same; larger blocks cut a
# 32k prefill's meta pass from 2,048 block steps a layer to 64
META_BLOCK = 4096


def _flash_forward(q, k, v, causal: bool, window: Optional[int],
                   return_lse: bool = False):
    """The FlashAttention kernel's wrapper, or in the dry-run's pass over
    meta tensors its plain computation (shapes only) at :data:`META_BLOCK`
    blocks."""
    if _meta_pass(q):
        return _ref.blockwise_attention(q, k, v, causal=causal,
                                        window=window, block_q=META_BLOCK,
                                        block_kv=META_BLOCK,
                                        return_lse=return_lse)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=return_lse)


def ssd_decode_step(state, x_t, dt_t, a_t, B_t, C_t):
    """One SSD decode step: a composite of a few elementwise operations and
    one product (the reference has no kernel for it)."""
    return _ref.ssd_decode_step_ref(state, x_t, dt_t, a_t, B_t, C_t)


def paged_attention_decode(q, k_pool, v_pool, pos_pool, page_table,
                           positions, window: Optional[int] = None,
                           row_mask: Optional[torch.Tensor] = None):
    """One-token GQA decode read through a page table, rows ``row_mask``
    masks left unread and zero (see
    :func:`repro_torch.kernels.paged_attention.paged_attention_decode`)."""
    return _paged.paged_attention_decode(q, k_pool, v_pool, pos_pool,
                                         page_table, positions, window=window,
                                         row_mask=row_mask)


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


def paged_attention_decode_sharded(q, k_pool, v_pool, pos_pool, page_table,
                                   positions, sh, window: Optional[int] = None,
                                   row_mask: Optional[torch.Tensor] = None):
    """The decode read with pools split on KV heads over ``sh``'s mesh, one
    call a shard (see :func:`repro_torch.kernels.paged_attention.
    paged_attention_decode_sharded`); plain pools take the unsharded call."""
    return _paged.paged_attention_decode_sharded(
        q, k_pool, v_pool, pos_pool, page_table, positions, sh,
        window=window, row_mask=row_mask)


def paged_prefill_scatter_sharded(pool, pages, values, sh):
    """:func:`paged_prefill_scatter` one call a shard (see
    :func:`repro_torch.kernels.paged_attention.
    paged_prefill_scatter_sharded`)."""
    return _paged.paged_prefill_scatter_sharded(pool, pages, values, sh)


def paged_admit_kv_sharded(k_pool, v_pool, pos_pool, pages, k_src, v_src,
                           pos_src, sh):
    """:func:`paged_admit_kv` one call a shard (see
    :func:`repro_torch.kernels.paged_attention.paged_admit_kv_sharded`)."""
    _paged.paged_admit_kv_sharded(k_pool, v_pool, pos_pool, pages, k_src,
                                  v_src, pos_src, sh)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill attention forward (see
    :func:`repro_torch.kernels.flash_attention.flash_attention`): the
    FlashAttention kernel for CUDA tensors, for CPU tensors its plain
    version -- the reference layers' ``blockwise_attention``.  Under grad
    with an input that requires grad, through :class:`FlashAttentionFn`."""
    if _differentiable(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window)


def _differentiable(*tensors) -> bool:
    """Whether a call must record its backward: grad mode on and some
    input requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the reference's custom VJP (``attn_fwd`` /
    ``attn_bwd`` of ``repro/models/attention_core.py``): the forward is
    :func:`repro_torch.kernels.flash_attention.flash_attention` with its
    log-sum-exp (the kernel for CUDA tensors) and saves ``(q, k, v, o,
    lse)``; the backward is
    :func:`repro_torch.models.attention_core.blockwise_attention_bwd`,
    counted in ``flash_attention.backward_counts``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = _flash_forward(q, k, v, causal, window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        _flash.backward_counts["flash_attention_bwd"] += 1
        dq, dk, dv = blockwise_attention_bwd(q, k, v, o, lse, do,
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None


class SsdChunkedFn(torch.autograd.Function):
    """The SSD scan with the reference's ``_ssd_pallas_vjp``: the forward
    is :func:`repro_torch.kernels.ssd_scan.ssd_chunked` (the kernel for
    CUDA tensors) and saves its inputs; the backward recomputes
    :func:`repro_torch.kernels.ref.ssd_chunked_ref` on them under grad and
    differentiates it against ``(dy, dh)``, counted in
    ``ssd_scan.backward_counts``.  B and C may be one group's stride-0 view
    over the heads: their grads come back per head, and autograd sums them
    through the ``expand`` into the group."""

    @staticmethod
    def forward(ctx, x, dt, a, B, C, h0, chunk: int):
        y, h = _ssd_forward(x, dt, a, B, C, chunk, h0)
        ctx.save_for_backward(x, dt, a, B, C, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        _ssd.backward_counts["ssd_chunked_bwd"] += 1
        need = ctx.needs_input_grad[:6]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        wanted = [i for i, t in enumerate(ins) if t is not None and need[i]]
        with torch.enable_grad():
            y, h = _ref.ssd_chunked_ref(*ins[:5], ctx.chunk,
                                        initial_state=ins[5])
            got = torch.autograd.grad((y, h), [ins[i] for i in wanted],
                                      (dy, dh), allow_unused=True)
        grads = [None] * 6
        for i, g in zip(wanted, got):
            grads[i] = g
        return (*grads, None)


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
