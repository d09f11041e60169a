"""Attention primitives (forward only), in plain PyTorch.

* :func:`naive_attention` -- full softmax over the whole key axis.
* :func:`blockwise_attention` -- the JAX package's memory-linear flash-style
  attention: query blocks, and inside each an online softmax over key
  blocks (running max ``m``, sum ``l``, float32 accumulator).  The reference
  writes it as ``lax.scan`` loops of ``jnp`` code, not as a Pallas kernel,
  so here it is loops of ``torch`` operations; the FlashAttention kernel of
  the JAX package (``kernels/flash_attention.py``) is another slice's work.

Both support GQA (query heads grouped over KV heads), causal masking and
sliding windows, with the reference's -1e30 additive mask bias and float32
scores (operands widened first, as ``preferred_element_type=f32`` asks).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _pick_block(size: int, target: int) -> int:
    """Largest divisor of ``size`` that is <= target (prefers powers of two)."""
    if size <= target:
        return size
    b = math.gcd(size, target)
    if b >= 16 or b == size:
        return b
    for cand in range(target, 0, -1):
        if size % cand == 0:
            return cand
    return size


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int],
               kv_valid: Optional[int] = None) -> torch.Tensor:
    """(q, k) additive bias: 0 where attendable, -1e30 elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid is not None:
        ok &= k_pos[None, :] < kv_valid
    return torch.where(ok, 0.0, NEG_INF).float()


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
    bias = _mask_bias(q_pos, k_pos, causal, window, kv_valid)
    s = s + bias[None, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhrk,bkhd->bqhrd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def _blockwise_fwd(q, k, v, causal: bool, window: Optional[int],
                   block_q: int, block_kv: int) -> torch.Tensor:
    """q: (B, Sq, Hkv, rep, D); returns the float32 output, same shape."""
    B, Sq, Hkv, rep, D = q.shape
    Skv = k.shape[1]
    nq, nk = Sq // block_q, Skv // block_kv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * block_q:(qi + 1) * block_q].float()
        q_pos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, block_q, Hkv, rep), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, block_q, Hkv, rep), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, block_q, Hkv, rep, D), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kj = k[:, j * block_kv:(j + 1) * block_kv].float()
            vj = v[:, j * block_kv:(j + 1) * block_kv].float()
            s = torch.einsum("bqhrd,bkhd->bqhrk", qblk, kj) * scale
            k_pos = j * block_kv + torch.arange(block_kv, device=dev)
            s = s + _mask_bias(q_pos, k_pos, causal, window)[
                None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhrk,bkhd->bqhrd", p, vj)
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append(acc / l_safe[..., None])
    return torch.cat(outs, dim=1)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        block_q: int = 512, block_kv: int = 1024):
    """Flash-style attention.  q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    rep = Hq // Hkv
    bq = _pick_block(Sq, block_q)
    bk = _pick_block(k.shape[1], block_kv)
    qr = q.reshape(B, Sq, Hkv, rep, D)
    o = _blockwise_fwd(qr, k, v, causal, window, bq, bk)
    return o.to(q.dtype).reshape(B, Sq, Hq, D)
