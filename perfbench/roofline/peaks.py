"""The card's published peaks (``perfbench/peaks.json``) and the rule that
turns a kernel's operations and bytes into its least time: bytes once over
the memory rate or operations over the type's peak, the larger."""
from __future__ import annotations

import json
import pathlib
from typing import Tuple

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def bound_s(nbytes: float, flops: float, flops_per_s: float
            ) -> Tuple[float, str]:
    by = nbytes / PEAKS["hbm_bytes_per_s"]
    op = flops / flops_per_s
    return max(by, op), "bytes" if by >= op else "operations"
