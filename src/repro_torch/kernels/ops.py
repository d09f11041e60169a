"""Dispatch layer of the kernel package; the risk stack imports only from here.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain version — the tensor's device decides, and there is no switch that
routes a CUDA tensor to a plain version.  What can be chosen is the lookup
strategy of ``aggregate_loss`` (:func:`use_aggregate_variant`, or the
``REPRO_AGG_VARIANT`` environment variable, checked when this module is
imported).
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.kernels import aggregate_loss as _agg

# single source of truth for aggregate_loss lookup strategies
_AGG_KERNELS = {"gather": _agg.aggregate_loss_gather,
                "onehot": _agg.aggregate_loss_onehot}
AGG_VARIANTS = tuple(_AGG_KERNELS)


def _env_agg_variant() -> str:
    """Fail fast (at import) on a misconfigured REPRO_AGG_VARIANT instead of
    deferring to an error deep inside the dispatch."""
    v = os.environ.get("REPRO_AGG_VARIANT", "gather")
    if v not in AGG_VARIANTS:
        raise ValueError(
            f"REPRO_AGG_VARIANT={v!r}: must be one of {AGG_VARIANTS}")
    return v


_STATE = {"agg_variant": _env_agg_variant()}


def use_aggregate_variant(name: str) -> None:
    """Select the aggregate_loss lookup strategy: "gather" (ELT rows read
    from global memory) or "onehot" (gather-free one-hot x ELT-tile product).
    Also settable via REPRO_AGG_VARIANT."""
    if name not in AGG_VARIANTS:
        raise ValueError(f"variant {name!r}: must be one of {AGG_VARIANTS}")
    _STATE["agg_variant"] = name


def aggregate_variant() -> str:
    return _STATE["agg_variant"]


def aggregate_loss(event_ids, elt_losses, occ_ret, occ_lim, agg_ret, agg_lim,
                   chunk: int = 128, variant: Optional[str] = None):
    """Year-loss per trial (paper Algorithm 3).

    The event axis is walked in ``chunk``-sized steps; a ragged last step is
    masked by the kernel, never padded by a copy.  ``variant`` overrides the
    configured lookup strategy (see :func:`use_aggregate_variant`)."""
    variant = variant or _STATE["agg_variant"]
    if variant not in AGG_VARIANTS:
        raise ValueError(f"variant {variant!r}: must be one of {AGG_VARIANTS}")
    return _AGG_KERNELS[variant](event_ids, elt_losses, occ_ret, occ_lim,
                                 agg_ret, agg_lim, chunk=chunk)
