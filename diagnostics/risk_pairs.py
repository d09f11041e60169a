"""Sequential against concurrent staging on one CUDA device, in repeated
pairs, time and energy: the paper's key result at the published size
(T 1,000,000 x K 1000, M 15, catalog 2,000,000; a 4.00 GB YET).

    python3 diagnostics/risk_pairs.py [--pairs 20] [--out pairs.json]

Runs ``chip_smoke.py``'s ``power``, ``fit`` and ``pairs`` phases with more
pairs than the smoke run affords: the card's ``PowerParams`` from its own
energy counter, the perf model fitted from a sequential 1x1..1x8 sweep
and the plan ``plan_from_telemetry`` makes of it, then 1x2 and 1x4,
sequential against concurrent, in ABBA pairs of windows of
back-to-back runs on warm engines (``chip_smoke.WINDOW_RUNS``).  Per pair: sequential minus concurrent
of the median run wall, of the median device span and of the energy a
run.  Prints the medians, ranges and win counts beside the simulator's
prediction from the fitted inputs, the card's name and power limit, and
the JSON (``--out`` also writes it); decides nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch

import chip_smoke as cs
from repro_torch.configs.risk_app import RiskAppConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=20,
                    help="pairs a deployment (ABBA order)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        card = cs.phase_device()
        tables = cs.phase_tables(RiskAppConfig())
        cfg = dataclasses.replace(RiskAppConfig(),
                                  num_trials=tables.num_trials)
        loop = cs.risk_loop(cfg, tables, dev, card, n_pairs=args.pairs)
    except cs.PhaseFailed as e:
        print(f"risk_pairs: FAILED: {e}", file=sys.stderr)
        return 1
    out = {"card": card, "trials": tables.num_trials, **loop}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
