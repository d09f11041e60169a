"""Pure-PyTorch oracles for the kernels of this package.

Twins of the JAX package's ``repro/kernels/ref.py`` oracles, same operation
order, float32 throughout.  Only the two Aggregate Risk Analysis oracles are
here so far; each further oracle lands with its kernel.
"""
from __future__ import annotations

import torch


def _occurrence(gathered, occ_ret, occ_lim):
    """min(max(l - OccR, 0), OccL) per ELT on a (..., M) block of losses."""
    occ = torch.clamp(gathered - occ_ret, min=0.0)
    return torch.minimum(occ, occ_lim)


def aggregate_loss_ref(event_ids, elt_losses, occ_ret, occ_lim, agg_ret,
                       agg_lim):
    """Year-loss for each trial (paper Algorithm 3).

    event_ids : (T, K) int     — per-trial event sequence (0 = no event pad)
    elt_losses: (E_cat, M) f32 — direct-access loss tables for M ELTs
                                 (row 0 must be zero: the pad event)
    occ_ret/occ_lim : (M,) f32 — per-ELT occurrence terms (financial terms I)
    agg_ret/agg_lim : float    — layer aggregate terms T
    Returns yl: (T,) f32 — the Year Loss Table.

    Occurrence terms clip each event-occurrence loss per ELT; event losses sum
    across ELTs, accumulate over the trial, then aggregate terms apply:
        l = min(max(l - ret, 0), lim)
    """
    gathered = elt_losses.float()[event_ids.long()]       # (T, K, M)
    per_event = _occurrence(gathered, occ_ret, occ_lim).sum(dim=-1)
    agg = per_event.sum(dim=-1)                           # (T,)
    return torch.clamp(torch.clamp(agg - agg_ret, min=0.0), max=agg_lim)


def aggregate_loss_chunked_ref(event_ids, elt_losses, occ_ret, occ_lim,
                               agg_ret, agg_lim, chunk: int):
    """Chunked variant (paper §IV-B "chunking"): identical numerics, processes
    the event axis in fixed-size chunks."""
    T, K = event_ids.shape
    if K % chunk:
        raise ValueError(f"K={K} is not a multiple of chunk={chunk}")
    elt = elt_losses.float()
    acc = torch.zeros(T, dtype=torch.float32, device=event_ids.device)
    for c0 in range(0, K, chunk):
        g = elt[event_ids[:, c0:c0 + chunk].long()]       # (T, chunk, M)
        acc = acc + _occurrence(g, occ_ret, occ_lim).sum(dim=(1, 2))
    return torch.clamp(torch.clamp(acc - agg_ret, min=0.0), max=agg_lim)
