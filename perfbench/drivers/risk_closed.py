"""``risk_closed``: Aggregate Risk Analyses back to back for the whole window.

An analyst re-prices one portfolio again and again: the YET and the ELTs
stay the same arrays, and each analysis takes a fresh what-if on the layer's
aggregate terms (``agg_ret`` and ``agg_lim`` scaled by factors drawn from
the seed in ``whatif``), through ``dataclasses.replace`` as the program's
cache contract asks.  The mix's ``path`` picks the entry:

* ``tenant_chunked``: ``AggregateRiskAnalysis.run_tenant_chunked`` over
  ``tenants`` virtual GPUs on one card, the YET staged from pinned host
  memory by ``transfer_mode`` (the paper's deployment);
* ``resident``: the YET resident on the card, each analysis one call of
  ``AggregateRiskAnalysis.make_sharded_step`` on a 1x1 mesh, the year losses
  brought to the host.

The tables are drawn on the card from the seed with the distributions of
the port's ``risk/tables.generate`` (event ids uniform over the catalog, a
tenth of them padding; each ELT covering 30 % of the catalog with lognormal
losses; occurrence terms at the 25th and 99th percentiles of the losses,
each scaled by U(0.5, 1.5); aggregate terms at 0.1 and 2 times the expected
annual loss).  Correctness: the year losses of a sample of the window's
analyses, drawn from the seed with the last one in it, against the plain
reference in float64, as the widest gap over the layer's aggregate limit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

import devtrace
from reference import risk as ref

MAX_RUNS = 1 << 16


def draw_tables(cfg: Dict[str, Any], gen: torch.Generator, dev):
    T, K = cfg["num_trials"], cfg["events_per_trial"]
    M, cat = cfg["num_elts"], cfg["event_catalog"]
    yet = torch.empty((T, K), dtype=torch.int32, device=dev)
    step = max(1, (1 << 27) // K)
    for a in range(0, T, step):
        b = min(T, a + step)
        ids = torch.randint(1, cat + 1, (b - a, K), generator=gen,
                            device=dev, dtype=torch.int32)
        pad = torch.rand((b - a, K), generator=gen, device=dev) < 0.1
        yet[a:b] = ids.masked_fill_(pad, 0)
    covered = torch.rand((cat, M), generator=gen, device=dev) < 0.3
    losses = torch.exp(10.0 + 1.5 * torch.randn((cat, M), generator=gen,
                                                device=dev))
    elt = torch.zeros((cat + 1, M), dtype=torch.float32, device=dev)
    elt[1:] = torch.where(covered, losses, torch.zeros_like(losses))
    nz = torch.sort(elt[elt > 0]).values
    n = nz.numel()
    q25 = float(nz[int(round(0.25 * (n - 1)))])
    q99 = float(nz[int(round(0.99 * (n - 1)))])
    u = torch.rand((2, M), generator=gen, device=dev) + 0.5
    occ_ret = (q25 * u[0]).float()
    occ_lim = (q99 * u[1]).float()
    exp_annual = float(nz.double().mean()) * K * 0.9 * 0.3 * M
    return yet, elt, occ_ret, occ_lim, 0.1 * exp_annual, 2.0 * exp_annual


def run(ctx) -> Dict[str, Any]:
    from repro_torch.configs.risk_app import RiskAppConfig
    from repro_torch.core.tenancy import TenancyConfig
    from repro_torch.risk.analysis import AggregateRiskAnalysis
    from repro_torch.risk.tables import RiskTables

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(ctx.seed)
    lo, hi = tr["whatif"]
    factors = rng.uniform(lo, hi, size=(MAX_RUNS, 2))
    sample = set(int(i) for i in rng.choice(
        tr["sample_span"], size=tr["sample_runs"], replace=False))
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    yet_d, elt_d, occ_ret_d, occ_lim_d, agg_ret, agg_lim = draw_tables(
        cfg, gen, dev)
    phases = {"inputs_s": time.perf_counter() - t}
    t = time.perf_counter()
    T, K = yet_d.shape
    rcfg = RiskAppConfig(num_trials=T, events_per_trial=K,
                         num_elts=cfg["num_elts"],
                         event_catalog=cfg["event_catalog"],
                         chunk_events=cfg["chunk_events"],
                         tenants_per_device=tr["tenants"],
                         transfer_mode=tr["transfer_mode"])
    ara = AggregateRiskAnalysis(rcfg, TenancyConfig(
        n_pdev=1, tenants_per_pdev=tr["tenants"],
        transfer_mode=tr["transfer_mode"]), device=dev)
    fault = ctx.faults.get("ylt")
    # a test's stale what-if: the program is handed run ``terms(i)``'s
    # terms in place of run i's
    terms = ctx.faults.get("terms", lambda i: i)

    if tr["path"] == "tenant_chunked":
        yet_h = torch.empty((T, K), dtype=torch.int32, pin_memory=cuda)
        yet_h.copy_(yet_d)
        del yet_d
        base = RiskTables(yet=yet_h.numpy(), elt_losses=elt_d.cpu().numpy(),
                          occ_ret=occ_ret_d.cpu().numpy(),
                          occ_lim=occ_lim_d.cpu().numpy(),
                          agg_ret=agg_ret, agg_lim=agg_lim)

        def analysis(i):
            j = terms(i)
            t = dataclasses.replace(base, agg_ret=agg_ret * factors[j, 0],
                                    agg_lim=agg_lim * factors[j, 1])
            rep = ara.run_tenant_chunked(t)
            dev_ms = [tl.device_ms for tl in (rep.timeline or [])]
            return rep.ylt, dev_ms
    elif tr["path"] == "resident":
        from repro_torch.distributed.sharding import parse_mesh
        step = ara.make_sharded_step(parse_mesh("1x1", [dev]))

        def analysis(i):
            e0 = e1 = None
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            j = terms(i)
            out = step(yet_d, elt_d, occ_ret_d, occ_lim_d,
                       agg_ret * factors[j, 0], agg_lim * factors[j, 1])
            if cuda:
                e1.record()
            return out.cpu().numpy(), (e0, e1)
    else:
        raise ValueError(f"path {tr['path']!r}")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(tr["warmup_runs"]):
        analysis(MAX_RUNS - 1 - i)
    if cuda:
        torch.cuda.synchronize()
    phases["warm_s"] = time.perf_counter() - t
    ctx.setup_done()

    gauge = None
    if cuda:
        from gauge import PowerGauge
        gauge = PowerGauge(dev.index or 0).start()
    tracer = devtrace.Tracer(ctx.trace)
    tracer.start()
    # the sampled year losses are copied into buffers made here, so that
    # which runs the seed samples does not change the host's heap
    keep = np.empty((len(sample) + 1, T), np.float32)
    slot = {j: k for k, j in enumerate(sorted(sample))}
    runs, kept = [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        with tracer.span("risk.analysis"):
            ylt, dev_ms = analysis(i)
        te = time.perf_counter()
        if fault is not None:
            ylt = fault(i, ylt)
        runs.append({"t_start": ts - t0, "t_end": te - t0, "device": dev_ms})
        if i in slot:
            kept[i] = keep[slot[i]]
            np.copyto(kept[i], ylt)
        i += 1
        if te - t0 >= ctx.seconds or i >= MAX_RUNS:
            break
    kept[i - 1] = keep[-1]
    np.copyto(keep[-1], ylt)
    window_s = te - t0
    tracer.stop()
    energy_j = None
    if gauge is not None:
        gauge.wait_ticks(1)
        energy_j = gauge.mean_watts(t0, te + 0.2) * window_s
        gauge.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    for r in runs:
        r["device"] = device_span(r["device"], tr["path"])
    del ara, analysis
    if tr["path"] == "resident":
        del step
    if cuda:
        torch.cuda.empty_cache()

    # the reference: the trials' summed losses once, the terms per run
    t_check = time.perf_counter()
    yet_src = yet_h if tr["path"] == "tenant_chunked" else yet_d
    f = ref.event_losses(elt_d, occ_ret_d, occ_lim_d)
    acc = ref.trial_sums(yet_src, f)
    gap = ctl = 0.0
    for j, ylt in kept.items():
        ret, lim = agg_ret * factors[j, 0], agg_lim * factors[j, 1]
        want = ref.apply_terms(acc, ret, lim)
        g = ref.worst_gap(ylt, want, lim)
        gap = g if not np.isfinite(g) else max(gap, g)
        if tr.get("control"):
            low = ref.year_losses(yet_src, elt_d, occ_ret_d, occ_lim_d, ret,
                                  lim, dtype=torch.bfloat16)
            ctl = max(ctl, ref.worst_gap(low.float(), want, lim))
        if not np.isfinite(gap):
            break
    check_s = time.perf_counter() - t_check
    calls = tr["tenants"] if tr["path"] == "tenant_chunked" else 1
    rec = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "memory_peak_bytes": peak, "attempted": len(runs), "failed": 0,
        "window_s": window_s, "runs": runs, "energy_j": energy_j,
        "yet_bytes": T * K * 4, "path": tr["path"],
        "k1_call": {"T": -(-T // calls), "K": K, "M": cfg["num_elts"],
                    "rows": cfg["event_catalog"] + 1},
        "checks": {"ylt_gap": {"value": gap,
                               "limit": tr["limits"]["ylt_gap"]}},
        "phases": dict(phases, window_s=window_s, check_s=check_s),
    }
    if tr.get("control"):
        rec["control"] = {"ylt_gap": ctl}
    summary = tracer.summary()
    if summary is not None:
        from roofline import k1
        ks = sum(tracer.kernel_s(name)[0] for name in k1.KERNELS)
        n_calls = tracer.kernel_s("gather_kernel")[1]
        c = rec["k1_call"]
        summary["k1"] = {"kernel_s": ks, "calls": n_calls,
                         "bound_s": n_calls * k1.bound(c["T"], c["K"], c["M"],
                                                       c["rows"])[0]}
        rec["trace"] = summary
    return rec


def device_span(dev_ms, path: str):
    """A run's device windows in ms: its span, the union of its copy and
    kernel windows, and its copy time, from the program's CUDA events
    (``TenantTimeline.device_ms``) or the benchmark's own around the
    resident step."""
    if path == "resident":
        e0, e1 = dev_ms
        if e0 is None:
            return None
        span = e0.elapsed_time(e1)
        return {"span_ms": span, "busy_ms": span, "copy_ms": 0.0}
    if not dev_ms or any(d is None for d in dev_ms):
        return None
    lo = min(d["copy_start"] for d in dev_ms)
    hi = max(d["compute_end"] for d in dev_ms)
    iv = [(d["copy_start"], d["copy_end"]) for d in dev_ms] + \
         [(d["compute_start"], d["compute_end"]) for d in dev_ms]
    return {"span_ms": hi - lo, "busy_ms": devtrace.union_s(iv),
            "copy_ms": sum(d["copy_end"] - d["copy_start"] for d in dev_ms)}
