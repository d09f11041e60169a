"""Gradient compression for the cross-pod (DCN) axis.

The JAX package's ``repro/training/grad_compression.py``: int8 blockwise
quantisation with error feedback (the residual carried to the next step).
Here are its pure functions -- quantise, dequantise, error feedback, and
the tree-wise round trip that gives a compressed all-reduce's numbers
without the collective.  The collective itself (the reference's
``compressed_psum``, an int8 payload reduced in int32 across the pod axis)
needs a mesh and comes with slice 6 of the port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.transformer import tree_map, tree_map2


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: returns (q (nblocks, block) int8, scales
    (nblocks,) float32)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor,
                           block: int = 256):
    """Error-feedback compression: quantise (g + residual), carry the error.

    Returns (q, scale, new_residual)."""
    target = g.float() + residual.float()
    q, scale = quantize_int8(target, block)
    deq = dequantize_int8(q, scale, g.shape)
    return q, scale, (target - deq)


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_grad_tree(grads: Any, residuals: Any, block: int = 256):
    """Tree-wise error-feedback compression round trip (the numbers of a
    compressed all-reduce without the collective).  Returns
    (decompressed_grads, new_residuals)."""
    def one(g, r):
        q, s, nr = compress_with_feedback(g, r, block)
        return dequantize_int8(q, s, g.shape, g.dtype), nr

    pairs = tree_map2(one, grads, residuals)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)
