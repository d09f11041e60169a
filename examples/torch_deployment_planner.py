"""Deployment planner walk-through (paper §V-F, Figs 17-22) on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_deployment_planner.py \\
        [--device cpu --reduced]

Prints the execution-time / energy / EDP surfaces over (#pdev x tenants) for
QDR and FDR InfiniBand with the paper's Table II constants and marks the
paper's reported optima.

Then the telemetry-driven path, twice.  First a few deployments are
replayed onto a telemetry plane as spans, `plan_from_telemetry` fits
`PerfModelInputs`/`PowerParams` back out of them by least squares and
re-plans, recovering the optimum the static constants give.  Then the
card's own profile: a short sequential sweep of risk runs (1x1, 1x2, 1x4)
on the device, its CUDA-event windows recorded with ``nv``, the card's
energy counter sampled over an idle wait and the sweep, and
`plan_from_telemetry` for one card of its memory, printed with the card's
name and power limit.  The port of ``examples/deployment_planner.py``,
whose TPU staging-profile section this replaces.  Runs on the CUDA device
unless ``--device cpu`` is given (and fails without one); on the CPU the
sweep's windows are host stamps and there is no gauge, so the power is the
paper's K20 set and no figure is the card's.
"""
import argparse
import dataclasses
import subprocess
import time

import torch

from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core import energymodel as em
from repro_torch.core import perfmodel as pm
from repro_torch.core.planner import full_surface, plan, plan_from_telemetry
from repro_torch.core.simulator import SimInputs
from repro_torch.core.tenancy import TenancyConfig, resolve_devices
from repro_torch.obs import fit as obs_fit
from repro_torch.obs.telemetry import Telemetry
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import generate

SWEEP = (1, 2, 4)


def surface_text(m, pw, max_p=12, max_t=6):
    surf = full_surface(m, pw, max_pdev=max_p, max_tenants=max_t)
    best = plan(m, "time")
    lines = ["tenants:" + "".join(f"{v:>9}" for v in range(1, max_t + 1))]
    for p in range(1, max_p + 1):
        row = [f"p={p:<3}"]
        for v in range(1, max_t + 1):
            d = surf.get((p, v))
            if d is None:
                row.append("      oom")
            else:
                mark = "*" if (p, v) == (best.n_pdev,
                                         best.tenants_per_pdev) else " "
                row.append(f"{d.exec_time_s:>8.2f}{mark}")
        lines.append("".join(row))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="the card profile at the reduced risk config")
    ap.add_argument("--trials", type=int, default=262144,
                    help="trials of the card profile's YET")
    args = ap.parse_args(argv)
    dev = resolve_devices(1, args.device)[0]          # raises: no card

    for net, paper_opt in ((pm.QDR, "7x2"), (pm.FDR, "9x2")):
        m = pm.PerfModelInputs(net=net)
        print(f"=== {net.name} — execution time [s] "
              f"(paper optimum {paper_opt}) ===")
        print(surface_text(m, em.K20))
        t = plan(m, "time")
        e = plan(m, "energy")
        x = plan(m, "edp")
        print(f"time-opt  {t.n_pdev}x{t.tenants_per_pdev} = "
              f"{t.exec_time_s:.3f}s   energy-opt {e.n_pdev}x"
              f"{e.tenants_per_pdev} = {e.energy_ws:.0f}Ws   "
              f"edp-opt {x.n_pdev}x{x.tenants_per_pdev}\n")

    telemetry_replan_demo()
    card_profile(dev, args.reduced, args.trials)


def telemetry_replan_demo():
    """Fit the model back out of span telemetry and re-plan (obs/fit.py)."""
    print("\n=== plan from telemetry (FDR, fitted from replayed spans) ===")
    m = pm.PerfModelInputs(net=pm.FDR)
    tel = Telemetry(enabled=True)
    # replay a small deployment sweep onto the plane
    for nv in (1, 2, 4, 8, 16):
        si = SimInputs(TenancyConfig(1, nv, "sequential"), net=m.net,
                       compute_time_1pdev=m.compute_time_1pdev,
                       yet_mb=m.yet_mb, elt_mb=m.elt_mb, pf_mb=m.pf_mb,
                       power=em.K20)
        obs_fit.replay_sim_run(tel, si, pw=em.K20)
    tp = plan_from_telemetry(tel)
    st = plan(m, "time")
    d = tp.deployment
    print(f"fitted:  t_4gb={tp.m.net.t_4gb:.4f}s "
          f"overhead={tp.m.net.per_vdev_overhead:.5f}s "
          f"c1={tp.m.compute_time_1pdev:.3f}s "
          f"p_busy={tp.pw.p_busy:.1f}W p_idle={tp.pw.p_idle_assigned:.1f}W")
    print(f"         residuals: transfer_rms={tp.transfer_rms_s:.2e}s "
          f"compute_rms={tp.compute_rms_s:.2e}s")
    print(f"plan:    telemetry -> {d.n_pdev}x{d.tenants_per_pdev} "
          f"({tp.transfer_mode}, {d.exec_time_s:.3f}s)   "
          f"static Table II -> {st.n_pdev}x{st.tenants_per_pdev} "
          f"({st.exec_time_s:.3f}s)")
    agree = (d.n_pdev, d.tenants_per_pdev) == (st.n_pdev,
                                               st.tenants_per_pdev)
    print(f"         optima {'agree' if agree else 'DISAGREE'}")


def card_profile(dev: torch.device, reduced: bool, trials: int):
    """A sequential sweep on the device, fitted and planned for one card."""
    base = RiskAppConfig().reduced() if reduced else RiskAppConfig()
    cfg = dataclasses.replace(base, num_trials=trials)
    tables = generate(cfg, seed=0)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.obs.gauge import PowerGauge
        name = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        tables = tables.pinned()
        mem_mb = torch.cuda.get_device_properties(dev).total_memory / 2**20
    else:
        name = "cpu (host stamps, no gauge: not a card's figures)"
        mem_mb = 80 * 1024.0
    nb = tables.nbytes()
    print(f"\n=== the card's own profile: {name} ===")
    print(f"sequential sweep 1x{', 1x'.join(map(str, SWEEP))}: T={trials} "
          f"K={cfg.events_per_trial} M={cfg.num_elts} catalog="
          f"{cfg.event_catalog}, YET {nb['yet'] / 1e9:.3f} GB")
    tel = Telemetry(enabled=True)
    engines = {nv: AggregateRiskAnalysis(
        cfg, TenancyConfig(1, nv, "sequential"), device=dev) for nv in SWEEP}
    for ara in engines.values():
        ara.run_tenant_chunked(tables)                 # warm

    def sweep():
        return [w for _, rep in obs_fit.record_sweep(tel, engines, tables, 3)
                for w in obs_fit.busy_windows(rep)]

    if on_card:
        with PowerGauge(dev.index or 0) as gauge:
            t_a = time.perf_counter()
            gauge.wait_ticks(5)                        # idle, assigned
            busy = sweep()
            torch.cuda.synchronize(dev)
            samples = obs_fit.record_power_samples(
                tel, gauge.ticks(t_a, time.perf_counter()), busy)
        print(f"power: {len(samples)} samples of {gauge.source}")
    else:
        sweep()
    fit_kw = dict(yet_mb=nb["yet"] / 1e6, elt_mb=nb["elt"] / 1e6,
                  device_memory_mb=mem_mb)
    tp = plan_from_telemetry(tel, budget_pdev=1, **fit_kw)
    d = tp.deployment
    print(f"fitted:  t_4gb={tp.m.net.t_4gb * 1e3:.2f}ms "
          f"overhead={tp.m.net.per_vdev_overhead * 1e3:.4f}ms "
          f"c1={tp.m.compute_time_1pdev * 1e3:.3f}ms "
          f"(residuals {tp.transfer_rms_s * 1e3:.4f} / "
          f"{tp.compute_rms_s * 1e3:.4f} ms)")
    print(f"power:   {tp.pw.name}: p_busy={tp.pw.p_busy:.1f}W "
          f"p_idle={tp.pw.p_idle_assigned:.1f}W")
    print(f"plan:    one card of {mem_mb:.0f} MiB -> {d.n_pdev}x"
          f"{d.tenants_per_pdev} {tp.transfer_mode}, model "
          f"{d.exec_time_s * 1e3:.2f} ms, {d.energy_ws:.2f} J")
    for ara in engines.values():
        ara.clear_table_cache()


if __name__ == "__main__":
    main()
