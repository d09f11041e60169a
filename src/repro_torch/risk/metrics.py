"""Portfolio risk metrics from the Year Loss Table (paper §IV-A).

PML (Probable Maximum Loss) at a return period R over T trial-years is the
(1 - 1/R) quantile of the YLT; TVaR is the conditional mean beyond VaR.
Quantiles interpolate linearly.  ``torch.quantile`` refuses inputs of more
than 16,777,216 elements; the published size (1M trials) is well inside.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

DEFAULT_RETURN_PERIODS = (10, 50, 100, 250, 500, 1000)


def pml(ylt: torch.Tensor,
        return_periods: Sequence[int] = DEFAULT_RETURN_PERIODS,
        ) -> Dict[int, torch.Tensor]:
    y = ylt.float()
    qs = torch.tensor([1.0 - 1.0 / r for r in return_periods],
                      dtype=torch.float32, device=y.device)
    vals = torch.quantile(y, qs)
    return {r: vals[i] for i, r in enumerate(return_periods)}


def var(ylt: torch.Tensor, alpha: float = 0.99) -> torch.Tensor:
    return torch.quantile(ylt.float(), alpha)


def tvar(ylt: torch.Tensor, alpha: float = 0.99) -> torch.Tensor:
    """Tail value-at-risk: E[loss | loss >= VaR_alpha]."""
    y = ylt.float()
    v = torch.quantile(y, alpha)
    w = (y >= v).float()
    return torch.sum(y * w) / torch.clamp(torch.sum(w), min=1.0)


def expected_loss(ylt: torch.Tensor) -> torch.Tensor:
    return torch.mean(ylt.float())


def summary(ylt: torch.Tensor) -> Dict[str, torch.Tensor]:
    out = {"mean": expected_loss(ylt), "var99": var(ylt), "tvar99": tvar(ylt)}
    for r, v in pml(ylt).items():
        out[f"pml{r}"] = v
    return out
