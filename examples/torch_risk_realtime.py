"""Real-time risk pricing scenario (paper §IV) on the PyTorch/CUDA port: a
burst of what-if requests, each re-running the analysis with perturbed
financial terms, served under the multi-tenant plan the planner picked.

    PYTHONPATH=src python examples/torch_risk_realtime.py [--requests 8] \\
        [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given (and fails without
one).  The port of ``examples/risk_realtime.py``: the resident tables stay
on the device across requests (only the layer terms change), and the
straggler detector's per-tenant times steer the next request's staging
order.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core import perfmodel as pm
from repro_torch.core.planner import plan
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.risk import metrics
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(RiskAppConfig().reduced(),
                              num_trials=1024, events_per_trial=64)
    tables = generate(cfg, seed=0)

    # the planner picks the tenancy for the real-time burst
    d = plan(pm.PerfModelInputs(net=pm.FDR), "time")
    tenants = min(d.tenants_per_pdev, 4)
    ara = AggregateRiskAnalysis(cfg, TenancyConfig(1, tenants),
                                device=args.device)   # raises: no card
    detector = StragglerDetector()
    print(f"planner: {d.n_pdev} pdev x {d.tenants_per_pdev} tenants "
          f"(running {tenants} tenants on one {args.device} device)")

    rng = np.random.default_rng(0)
    lat = []
    for i in range(args.requests):
        # client varies the layer terms (online pricing: what-if reinsurance)
        t = dataclasses.replace(tables,
                                agg_ret=float(tables.agg_ret *
                                              rng.uniform(0.5, 1.5)),
                                agg_lim=float(tables.agg_lim *
                                              rng.uniform(0.8, 1.2)))
        t0 = time.perf_counter()
        rep = ara.run_tenant_chunked(
            t, straggler_hist=detector.staging_priority() or None)
        dt = time.perf_counter() - t0
        lat.append(dt)
        detector.update(rep.per_tenant_s)
        pml250 = float(metrics.pml(torch.from_numpy(rep.ylt), (250,))[250])
        print(f"req {i}: AggR={t.agg_ret:,.0f} -> PML250={pml250:,.0f} "
              f"({dt * 1e3:.1f} ms)")
    print(f"\np50 latency {np.percentile(lat, 50) * 1e3:.1f} ms, "
          f"p95 {np.percentile(lat, 95) * 1e3:.1f} ms "
          f"(the first request uploads the resident tables)")


if __name__ == "__main__":
    main()
