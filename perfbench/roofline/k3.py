"""K3, the paged decode attention (``kernels/paged_attention.py``): each
named page's K and V tile and positions read once, the page table, the
positions and q read once, the float32 output written once; or its two
products, 4 flops per query head, key and element, at the bf16 rate."""
from __future__ import annotations

from roofline.peaks import PEAKS, bound_s

KERNELS = ("paged_decode_kernel",)


def nbytes(C: int, NB: int, P: int, H: int, Hkv: int, D: int,
           q_bytes: int = 2) -> float:
    return (C * NB * P * (2 * Hkv * D * 2 + 4) + C * NB * 4 + C * 4
            + C * H * D * (q_bytes + 4))


def flops(C: int, NB: int, P: int, H: int, Hkv: int, D: int) -> float:
    return 4 * C * H * NB * P * D


def bound(C, NB, P, H, Hkv, D, q_bytes=2):
    """One call over ``C`` rows naming ``NB`` pages each."""
    return bound_s(nbytes(C, NB, P, H, Hkv, D, q_bytes),
                   flops(C, NB, P, H, Hkv, D), PEAKS["bf16_flops_per_s"])
