"""Attention primitives (forward only), in plain PyTorch.

* :func:`naive_attention` -- full softmax over the whole key axis.
* :func:`blockwise_attention` -- the JAX package's memory-linear flash-style
  attention: query blocks, and inside each an online softmax over key
  blocks (running max ``m``, sum ``l``, float32 accumulator).  It is the
  plain version of the FlashAttention kernel, so it lives in
  :mod:`repro_torch.kernels.ref` and is re-exported here.

Both support GQA (query heads grouped over KV heads), causal masking and
sliding windows, with the reference's -1e30 additive mask bias and float32
scores (operands widened first, as ``preferred_element_type=f32`` asks).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.ref import blockwise_attention, mask_bias

__all__ = ["blockwise_attention", "naive_attention"]


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
