"""K1, the aggregate-loss gather (``kernels/aggregate_loss.py``): a row
pass writing each catalog row's clipped loss, then a trial pass summing
them over each trial's events.  The least the function both kernels compute
needs: the ids, the table and the terms read once, the year losses written
once; or its operations (subtract, max, min, add per event and column; the
aggregate terms per trial) at the float32 rate."""
from __future__ import annotations

from roofline.peaks import PEAKS, bound_s

KERNELS = ("row_loss_kernel", "gather_kernel")


def nbytes(T: int, K: int, M: int, rows: int) -> float:
    return T * K * 4 + rows * M * 4 + 2 * M * 4 + T * 4


def flops(T: int, K: int, M: int, rows: int) -> float:
    return 4 * T * K * M + 3 * T


def bound(T: int, K: int, M: int, rows: int):
    """Seconds, and whether bytes or operations bound them."""
    return bound_s(nbytes(T, K, M, rows), flops(T, K, M, rows),
                   PEAKS["f32_flops_per_s"])
