"""Attention primitives, in plain PyTorch.

* :func:`naive_attention` -- full softmax over the whole key axis.
* :func:`blockwise_attention` -- the JAX package's memory-linear flash-style
  attention: query blocks, and inside each an online softmax over key
  blocks (running max ``m``, sum ``l``, float32 accumulator).  It is the
  plain version of the FlashAttention kernel, so it lives in
  :mod:`repro_torch.kernels.ref` and is re-exported here.

* :func:`blockwise_attention_bwd` -- the reference's backward of the
  blockwise attention (``attn_bwd`` of its custom VJP): from the forward's
  residuals ``(q, k, v, o, lse)`` it recomputes each block's scores and
  probabilities ``p = exp(s - lse)`` and accumulates dq, dk and dv in
  float32.  The training backward of the FlashAttention kernel
  (:class:`repro_torch.kernels.ops.FlashAttentionFn`); the JAX package has
  no backward kernel, so neither has the port.

All support GQA (query heads grouped over KV heads), causal masking and
sliding windows, with the reference's -1e30 additive mask bias and float32
scores (operands widened first, as ``preferred_element_type=f32`` asks).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.ref import _pick_block, blockwise_attention, mask_bias

__all__ = ["blockwise_attention", "blockwise_attention_bwd",
           "naive_attention"]


def naive_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_valid: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D).  Returns (B,Sq,Hq,D)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, rep, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qr.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = (kv_positions if kv_positions is not None
             else torch.arange(k.shape[1], device=q.device))
    bias = mask_bias(q_pos, k_pos, causal, window, kv_valid)
    s = s + bias[None, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhrk,bkhd->bqhrd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def blockwise_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None, block_q: int = 512,
                            block_kv: int = 1024):
    """The reference's ``attn_bwd``: gradients of :func:`blockwise_attention`
    from its residuals.

    q, o, do ``(B, Sq, Hq, D)``; k, v ``(B, Skv, Hkv, D)``; lse ``(B, Sq,
    Hq)`` float32, each row's ``m + log(l_safe)`` as the forward computed it
    (for a row with no admissible key that is -1e30, and the recomputed
    ``p`` is then 1 for every key, as in the reference).  Blocks are the
    forward's: the largest divisors of Sq and Skv up to ``block_q`` and
    ``block_kv``.  Every product in float32 on widened operands; returns
    ``(dq, dk, dv)`` in the inputs' types."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    bq, bk = _pick_block(Sq, block_q), _pick_block(Skv, block_kv)
    nq, nk = Sq // bq, Skv // bk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.float().reshape(B, Sq, Hkv, rep, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Hkv, rep, D)
    lse = lse.float().reshape(B, Sq, Hkv, rep)
    delta = torch.sum(dof * o.float().reshape(B, Sq, Hkv, rep, D), dim=-1)
    dq = torch.empty((B, Sq, Hkv, rep, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for qi in range(nq):
        sl = slice(qi * bq, (qi + 1) * bq)
        qblk, doblk = qf[:, sl], dof[:, sl]
        lseblk, dltblk = lse[:, sl, ..., None], delta[:, sl, ..., None]
        q_pos = qi * bq + torch.arange(bq, device=dev)
        dq_blk = torch.zeros((B, bq, Hkv, rep, D), dtype=torch.float32,
                             device=dev)
        for j in range(nk):
            ks = slice(j * bk, (j + 1) * bk)
            kj, vj = kf[:, ks], vf[:, ks]
            s = torch.einsum("bqhrd,bkhd->bqhrk", qblk, kj) * scale
            k_pos = j * bk + torch.arange(bk, device=dev)
            s = s + mask_bias(q_pos, k_pos, causal, window)[
                None, :, None, None, :]
            p = torch.exp(s - lseblk)                 # (B, bq, Hkv, rep, bk)
            dv[:, ks] += torch.einsum("bqhrk,bqhrd->bkhd", p, doblk)
            dp = torch.einsum("bqhrd,bkhd->bqhrk", doblk, vj)
            ds = p * (dp - dltblk) * scale
            dq_blk += torch.einsum("bqhrk,bkhd->bqhrd", ds, kj)
            dk[:, ks] += torch.einsum("bqhrk,bqhrd->bkhd", ds, qblk)
        dq[:, sl] = dq_blk
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
