"""Plain reference of Aggregate Risk Analysis (the paper's Algorithm 3).

For each trial ``t`` of the Year Event Table and each of its events ``e``
(id 0 is no event), each Event Loss Table ``m`` gives the event's loss,
clipped by the layer's occurrence terms ``min(max(ELT[e, m] - occ_ret[m],
0), occ_lim[m])``; a trial's losses over its events and the tables are
summed, and the sum is clipped by the aggregate terms: ``min(max(acc -
agg_ret, 0), agg_lim)``.  Plain PyTorch, written from that description
alone; it imports nothing of the program.
"""
from __future__ import annotations

import torch

BLOCK_TRIALS = 1 << 16


def event_losses(elt: torch.Tensor, occ_ret: torch.Tensor,
                 occ_lim: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Each catalog row's loss summed over the tables, after the
    occurrence terms, in ``dtype``."""
    x = elt.to(dtype) - occ_ret.to(dtype)
    x = torch.minimum(torch.clamp(x, min=0), occ_lim.to(dtype))
    return x.sum(dim=1)


def trial_sums(yet: torch.Tensor, f: torch.Tensor,
               block: int = BLOCK_TRIALS) -> torch.Tensor:
    """Each trial's summed event losses (before the aggregate terms), in
    ``f``'s type, on ``f``'s device; the YET may lie on the host and is
    read a block of trials at a time."""
    out = torch.empty(yet.shape[0], dtype=f.dtype, device=f.device)
    for a in range(0, yet.shape[0], block):
        ids = yet[a:a + block].to(f.device, non_blocking=False).long()
        out[a:a + block] = f[ids].sum(dim=1)
    return out


def apply_terms(acc: torch.Tensor, agg_ret: float, agg_lim: float
                ) -> torch.Tensor:
    return torch.clamp(torch.clamp(acc - agg_ret, min=0), max=agg_lim)


def year_losses(yet, elt, occ_ret, occ_lim, agg_ret, agg_lim,
                dtype=torch.float64) -> torch.Tensor:
    """The Year Loss Table, every step in ``dtype`` (float64: the
    reference; bfloat16: the control)."""
    f = event_losses(elt, occ_ret, occ_lim, dtype)
    acc = trial_sums(yet, f)
    return apply_terms(acc, float(torch.tensor(agg_ret, dtype=dtype)),
                       float(torch.tensor(agg_lim, dtype=dtype)))


def worst_gap(ylt, ref: torch.Tensor, agg_lim: float) -> float:
    """The widest gap between a year loss and the reference's, as a share
    of the layer's aggregate limit."""
    got = torch.as_tensor(ylt).to(ref.device, torch.float64)
    return float((got - ref.double()).abs().max()) / float(agg_lim)
