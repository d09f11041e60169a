"""Quickstart: the paper's pipeline in ~40 lines, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Generate a synthetic portfolio (YET / ELTs / financial terms).
2. Run Aggregate Risk Analysis under a 2-tenant sequential-staging plan.
3. Report PML/TVaR risk metrics.
4. Ask the deployment planner what the paper-scale optimum would be.

Runs on the CUDA device unless ``--device cpu`` is given (and fails without
one).  The port of ``examples/quickstart.py``.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core import perfmodel as pm
from repro_torch.core.planner import plan
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.risk import metrics
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # 1. a small portfolio (paper-scale: 1M trials x 1000 events, 4 GB)
    cfg = dataclasses.replace(RiskAppConfig().reduced(),
                              num_trials=512, events_per_trial=64)
    tables = generate(cfg, seed=0)
    print(f"YET {tables.yet.shape}, ELTs {tables.elt_losses.shape}, "
          f"{tables.nbytes()['yet'] / 1e6:.2f} MB")

    # 2. multi-tenant analysis: 2 virtual devices on 1 physical device
    ara = AggregateRiskAnalysis(cfg, TenancyConfig(
        n_pdev=1, tenants_per_pdev=2, transfer_mode="sequential"),
        device=args.device)                       # raises: no card
    report = ara.run_tenant_chunked(tables)
    print(f"analysed {cfg.num_trials} trials in {report.wall_s * 1e3:.1f} ms "
          f"({len(report.per_tenant_s)} tenants, {args.device})")

    # 3. risk metrics from the Year Loss Table
    for name, value in metrics.summary(torch.from_numpy(report.ylt)).items():
        print(f"  {name:>8}: {float(value):>14,.0f}")

    # 4. what should production look like? (paper Figs 17-22, the paper's
    #    own platform constants)
    m = pm.PerfModelInputs(net=pm.FDR)
    for objective in ("time", "energy", "edp"):
        d = plan(m, objective)
        print(f"paper-scale {objective:>6}-optimal deployment: "
              f"{d.n_pdev} pdev x {d.tenants_per_pdev} tenants "
              f"-> {d.exec_time_s:.2f} s, {d.energy_ws:.0f} Ws")


if __name__ == "__main__":
    main()
