"""Synthetic YET / ELT / Portfolio generators (paper Section IV-A).

Deterministic (seeded) so tests and benchmarks are reproducible.  Everything
is plain numpy on the host — the pipeline/staging layer owns device placement
(that *is* the paper's topic).  :func:`generate` draws from
``np.random.default_rng`` in exactly the order the JAX package's generator
does, so the two packages see bit-identical tables for one seed.

At the published size (1M trials x 1000 events) :func:`generate` peaks near
21 bytes per YET element on the host (an int64 draw, a float64 mask draw, the
boolean mask and the int32 result): budget ~21 GB of host memory for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.risk_app import RiskAppConfig

# host bytes per YET element while generate() runs (see module docstring)
GENERATE_PEAK_BYTES_PER_EVENT = 21


@dataclasses.dataclass
class RiskTables:
    """Host-side tables.

    yet        : (T, K) int32 — per-trial event sequences (0 = pad/no-event)
    elt_losses : (E_cat + 1, M) float32 — direct-access tables, row 0 zero
    occ_ret/occ_lim : (M,) float32 — per-ELT occurrence terms (I)
    agg_ret/agg_lim : float — layer aggregate terms (T)
    """
    yet: np.ndarray
    elt_losses: np.ndarray
    occ_ret: np.ndarray
    occ_lim: np.ndarray
    agg_ret: float
    agg_lim: float

    @property
    def num_trials(self) -> int:
        return self.yet.shape[0]

    def nbytes(self) -> Dict[str, int]:
        return {"yet": self.yet.nbytes,
                "elt": self.elt_losses.nbytes,
                "terms": self.occ_ret.nbytes + self.occ_lim.nbytes + 16}

    def pinned(self) -> "RiskTables":
        """The same tables with the YET moved into page-locked host memory
        (one copy; needs a CUDA runtime).  Host->device copies of a pinned
        YET are truly asynchronous, so a caller that drives several engines
        over one table set pins it once here instead of once per engine."""
        yet = torch.from_numpy(self.yet).pin_memory().numpy()
        return dataclasses.replace(self, yet=yet)


def from_arrays(obj: Any) -> RiskTables:
    """Build :class:`RiskTables` from any object carrying the six fields
    (``yet, elt_losses, occ_ret, occ_lim, agg_ret, agg_lim``) as array-likes
    and numbers — e.g. the JAX package's tables — without copying arrays that
    already have the right dtype."""
    return RiskTables(
        yet=np.asarray(obj.yet, dtype=np.int32),
        elt_losses=np.asarray(obj.elt_losses, dtype=np.float32),
        occ_ret=np.asarray(obj.occ_ret, dtype=np.float32),
        occ_lim=np.asarray(obj.occ_lim, dtype=np.float32),
        agg_ret=float(obj.agg_ret),
        agg_lim=float(obj.agg_lim))


def generate(cfg: RiskAppConfig, seed: int = 0) -> RiskTables:
    rng = np.random.default_rng(seed)
    T, K, M = cfg.num_trials, cfg.events_per_trial, cfg.num_elts
    cat = cfg.event_catalog

    # Year Event Table: event ids; ~10% pad entries (trials vary in length)
    yet = rng.integers(1, cat + 1, size=(T, K), dtype=np.int64)
    pad = rng.random((T, K)) < 0.1
    yet[pad] = 0
    yet = yet.astype(np.int32)

    # Event Loss Tables: heavy-tailed losses; each ELT covers ~30% of events
    elt = np.zeros((cat + 1, M), np.float32)
    for m in range(M):
        covered = rng.random(cat) < 0.3
        losses = rng.lognormal(mean=10.0, sigma=1.5, size=cat).astype(np.float32)
        elt[1:, m] = np.where(covered, losses, 0.0)

    # financial terms: occurrence retention ~ p25 of losses, limit ~ p99
    nz = elt[elt > 0]
    occ_ret = np.full(M, np.percentile(nz, 25), np.float32) * \
        rng.uniform(0.5, 1.5, M).astype(np.float32)
    occ_lim = np.full(M, np.percentile(nz, 99), np.float32) * \
        rng.uniform(0.5, 1.5, M).astype(np.float32)
    # aggregate terms scale with expected annual loss
    mean_event = float(nz.mean()) if nz.size else 1.0
    exp_annual = mean_event * K * 0.9 * 0.3 * M   # pads x coverage x ELTs
    agg_ret = 0.1 * exp_annual
    agg_lim = 2.0 * exp_annual
    return RiskTables(yet, elt, occ_ret, occ_lim, float(agg_ret), float(agg_lim))


def paper_scale_nbytes(cfg: RiskAppConfig) -> Dict[str, float]:
    """Input footprints in MB for the perf model (paper: YET 4 GB, ELT 120 MB,
    PF 4 MB)."""
    yet_mb = cfg.num_trials * cfg.events_per_trial * 4 / 1e6
    elt_mb = (cfg.event_catalog + 1) * cfg.num_elts * 4 / 1e6
    return {"yet_mb": yet_mb, "elt_mb": elt_mb, "pf_mb": 1.0}
