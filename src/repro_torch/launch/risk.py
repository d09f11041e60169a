"""Risk-application entry point: run Aggregate Risk Analysis under a tenancy plan.

    PYTHONPATH=src python -m repro_torch.launch.risk --reduced --tenants 2 \
        --mode sequential

Runs on the CUDA device unless ``--device cpu`` is given (and fails without
one otherwise).  ``--no-reduced`` runs the published configuration (1M trials
x 1000 events, 15 ELTs over a 2M-event catalog; needs ~21 GB of host memory
to generate).  Prints the YLT risk metrics and the wall time, plus the
perf/energy-model prediction for the paper's own platform (Figs 15-22).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from repro_torch.configs.risk_app import CONFIG as PAPER_CFG
from repro_torch.core import perfmodel as pm
from repro_torch.core.planner import plan
from repro_torch.risk import metrics
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--mode", default="sequential",
                    choices=["sequential", "concurrent"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = PAPER_CFG.reduced() if args.reduced else PAPER_CFG
    repl = {"tenants_per_device": args.tenants, "transfer_mode": args.mode}
    if args.trials:
        repl["num_trials"] = args.trials
    cfg = dataclasses.replace(cfg, **repl)

    ara = AggregateRiskAnalysis(cfg, device=args.device)   # raises: no card
    tables = generate(cfg, args.seed)
    rep = ara.run_tenant_chunked(tables)
    print(f"trials={cfg.num_trials} tenants/dev={args.tenants} "
          f"mode={args.mode} device={args.device} wall={rep.wall_s*1e3:.1f} ms")
    for k, v in metrics.summary(torch.from_numpy(rep.ylt)).items():
        print(f"  {k:8s} {float(v):,.0f}")

    # model-predicted deployment for the paper-scale workload on the paper's
    # platform (its Table II constants, not this device's)
    m = pm.PerfModelInputs(net=pm.FDR)
    best = plan(m, "time")
    beste = plan(m, "energy")
    print(f"paper-scale model: time-opt {best.n_pdev}x{best.tenants_per_pdev}"
          f" = {best.exec_time_s:.3f}s | energy-opt "
          f"{beste.n_pdev}x{beste.tenants_per_pdev} = {beste.energy_ws:.0f} Ws")
    return 0


if __name__ == "__main__":
    sys.exit(main())
