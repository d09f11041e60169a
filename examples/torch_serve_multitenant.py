"""Multi-tenant serving: three applications share one accelerator, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_multitenant.py [--device cpu]

The scheduler round-robins tenant slots on the engine's dispatch/await
halves: tenant k+1's batch assembly and staging are enqueued while tenant
k's decode loop is still running on the device (on a CUDA device one
captured graph per loop key) -- the paper's transfer-under-compute
multi-tenancy applied to inference serving.  Prints per-tenant utilisation
and the realised overlap pairs, then replays the same workload under
continuous batching (a persistent slot table over a paged KV cache, rows
admitted and retired within the running decode) for comparison.

Runs on the CUDA device unless ``--device cpu`` is given (and fails without
one).  The port of ``examples/serve_multitenant.py``'s first two sections;
its prefix-sharing, backend, overload and crash-safety sections need
slices of the port still to come.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.pipeline import timeline_overlaps
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

WORKLOADS = {"pricing-desk": (12, 24, 8),     # requests, prompt, new
             "batch-report": (6, 48, 16),
             "dashboard": (18, 12, 4)}


def submit_all(sched, cfg, seed=7):
    rng = np.random.default_rng(seed)
    for tenant, (n, plen, new) in WORKLOADS.items():
        for _ in range(n):
            sched.submit(Request(tenant,
                                 rng.integers(1, cfg.vocab_size,
                                              plen).astype(np.int32),
                                 max_new_tokens=new))


def report(sched, responses, label):
    print(f"\n=== {label}: served {len(responses)} requests across "
          f"{len(WORKLOADS)} tenants ===")
    print(f"{'tenant':>14} {'reqs':>5} {'tokens':>7} {'busy ms':>8} "
          f"{'share':>6}")
    for t, rep in sorted(sched.utilization_report().items()):
        print(f"{t:>14} {rep['requests']:>5.0f} {rep['tokens']:>7.0f} "
              f"{rep['busy_s'] * 1e3:>8.1f} {rep['busy_share'] * 100:>5.1f}%")
    lat = np.asarray([r.latency_s for r in responses])
    print(f"latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms")
    ov = timeline_overlaps(sched.timeline)
    print(f"overlap pairs (staging k+1 inside decode k): {sum(ov)}/{len(ov)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config("h2o-danube-1.8b").reduced()
    engine = ServingEngine(cfg, build_model(cfg).init(0, args.device),
                           temperature=0.8,
                           device=args.device)        # raises: no card

    # slot-based: tenant batches staged under the running decode
    sched = MultiTenantScheduler(engine, max_batch=4,
                                 tenancy=TenancyConfig(1, 3))
    submit_all(sched, cfg)
    report(sched, sched.drain(), "slot-based (overlapped)")
    prog = engine.decode_program
    if prog is not None:
        print(f"decode loops captured as CUDA graphs: {len(prog.loops)} "
              f"keys, {sum(c.replays for c in prog.loops.values())} "
              "replays")

    # continuous batching: paged KV cache + persistent slot table
    sched = MultiTenantScheduler(
        engine, tenancy=TenancyConfig(1, 3), mode="continuous",
        continuous=dict(capacity=6, page_size=16, inner_steps=4,
                        max_prompt_len=64))
    submit_all(sched, cfg)
    report(sched, sched.drain(), "continuous (paged KV cache)")
    eng = sched.continuous_engine
    print(f"micro-rounds={eng.rounds} x {eng.inner_steps} steps, "
          f"slot occupancy={eng.occupancy()*100:.1f}%, "
          f"pages reused={eng.kv.pages_reused}/{eng.kv.pages_allocated}")


if __name__ == "__main__":
    main()
