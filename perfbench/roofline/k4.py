"""K4, the paged admission scatter (``kernels/paged_attention.py``): one
attention sub-layer's dense K and V rings read once, their pages written
once in bf16, the positions read and their pages' rows written once, the
page list read once.  No arithmetic to speak of: bound by bytes."""
from __future__ import annotations

from roofline.peaks import bound_s, PEAKS

KERNELS = ("paged_admit_kernel",)


def nbytes(S: int, nb: int, P: int, row: int, ring: int,
           value_bytes: int = 2) -> float:
    return (2 * S * ring * row * value_bytes + 2 * S * nb * P * row * 2
            + ring * 4 + nb * P * 4 + nb * 4)


def bound(S, nb, P, row, ring, value_bytes=2):
    return bound_s(nbytes(S, nb, P, row, ring, value_bytes), 0.0,
                   PEAKS["bf16_flops_per_s"])
