"""Gradient compression for the cross-pod (DCN) axis.

The JAX package's ``repro/training/grad_compression.py``: int8 blockwise
quantisation with error feedback (the residual carried to the next step),
the tree-wise round trip that gives a compressed all-reduce's numbers
without the collective, and the collective itself, :func:`compressed_psum`:
each mesh position quantises its own local, the int8 payloads of an axis
group are summed in int32 and dequantised with the group's mean scale.  On
the wire a position sends 1 byte an element and 4 bytes a block.  The
train step does not call it (nor does the reference's).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed.sharding import ShardedTensor, axis_groups
from repro_torch.models.transformer import tree_map, tree_map2


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` correctly rounded on every device: a CUDA tensor divided by
    a Python number is multiplied by its reciprocal, which may round one
    ulp off the quotient."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: returns (q (nblocks, block) int8, scales
    (nblocks,) float32)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = _div(torch.amax(torch.abs(blocks), dim=1, keepdim=True), 127.0)
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


def compressed_psum(x: ShardedTensor, axis_name: str, block: int = 256
                    ) -> ShardedTensor:
    """The reference's int8-compressed ``psum`` over ``axis_name`` of each
    position's local (its ``shard_map`` body): every position quantises
    its own local; a group's int8 payloads are summed in int32 and its
    scales in float32, both in the group's order along the axis, on the
    group's first device; the sum is dequantised with the mean scale and
    handed to every member on its device."""
    mesh = x.mesh
    devs = mesh.position_devices()
    quant = {}                       # one quantisation a distinct storage
    for _, t, _ in x.unique():
        quant[id(t)] = quantize_int8(t, block)
    done, outs = {}, []
    for p, group in enumerate(axis_groups(mesh, (axis_name,))):
        key = tuple(group)
        if key not in done:
            d0 = devs[group[0]]
            q0, s0 = quant[id(x.locals[group[0]])]
            qsum, ssum = q0.to(torch.int32), s0
            for q in group[1:]:
                qq, sq = quant[id(x.locals[q])]
                qsum = qsum + qq.to(d0).to(torch.int32)
                ssum = ssum + sq.to(d0)
            local = x.locals[group[0]]
            deq = (qsum.float() * _div(ssum, len(group))[:, None]
                   ).reshape(-1)
            done[key] = deq[:local.numel()].reshape(local.shape).to(
                local.dtype)
        outs.append(done[key].to(devs[p]))
    return ShardedTensor.from_locals(mesh, x.spec, outs)
