"""K5, the FlashAttention prefill (``kernels/flash_attention.py``): q, k
and v read once and o written once; or the products the mask admits, two
of 2 D flops per admissible (query, key) pair and head, at the peak of the
inputs' type."""
from __future__ import annotations

from typing import Optional

import numpy as np

from roofline.peaks import PEAKS, bound_s

KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel")


def pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """Admissible (query, key) pairs, queries aligned to the last keys."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + (Skv - Sq), Skv - 1) if causal else \
        np.full(Sq, Skv - 1, np.int64)
    lo = np.maximum(0, hi - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def nbytes(B, Sq, Skv, Hq, Hkv, D, in_bytes=2) -> float:
    return (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * in_bytes


def flops(B, Sq, Skv, Hq, D, causal=True, window=None) -> float:
    return 4 * D * B * Hq * pairs(Sq, Skv, causal, window)


def bound(B, Sq, Skv, Hq, Hkv, D, causal=True, window=None, in_bytes=2):
    rate = PEAKS["bf16_flops_per_s" if in_bytes == 2 else "f32_flops_per_s"]
    return bound_s(nbytes(B, Sq, Skv, Hq, Hkv, D, in_bytes),
                   flops(B, Sq, Skv, Hq, D, causal, window), rate)
