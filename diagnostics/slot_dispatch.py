"""Where a warm ``dispatch`` waits while a tenant slot is in flight, on one
CUDA device, at internlm2-1.8b's full width (a slot of 4 prompts of 128
tokens, 32 new tokens: ``chip_smoke.py``'s ``serve-slots`` shape).

    python3 diagnostics/slot_dispatch.py [--out dispatch.json]

A replayed decode loop holds its stream's launch queue: an eager launch
enqueued behind it on that stream waits for most of the slot.  Here the
host time of each enqueue is taken with the device idle and behind a slot
just dispatched (its decode loop replaying on the graph's stream), on the
graph's stream, on a free second stream, and on a second stream that
first waits for the slot's ``done`` event (device order kept):

* the prefill (``ServingEngine.prefill``, ≈600 launches), and three of
  them back to back (three staged slots);
* the static-input copies of one dispatch (the prefill's logits and
  caches into buffers of their shapes);
* one replay of the slot's captured graph.

Then ``dispatch`` itself with 0 to 3 slots in flight ahead of it, and
with one ahead while another thread waits on it (as the scheduler's
completion waiter does) through a spinning or a blocking event.  Each
case runs ``REPS`` times.  Last, the dispatches the overlapped scheduler
makes (depth 1, 24 requests of 3 tenants), timed, then again under
``cProfile`` (the functions with the most own time inside ``dispatch``).
Prints the numbers beside the card's name and power limit, and decides
nothing.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.models.model import build_model
from repro_torch.models.transformer import tree_map, tree_map2
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

REPS = 5
STEPS = 32
DEPTHS = (0, 1, 2, 3)
SCHED_REQUESTS = 24
PROFILE_LINES = 25


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    cs.phase_build()
    cfg = get_config("internlm2-1.8b")
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    reqs = cs.serve_requests(cfg, 4, 3, 128, STEPS)
    prompts = np.stack([r.prompt for r in reqs])
    for _ in range(2):                   # capture, then one replay
        eng.await_result(eng.dispatch(prompts, STEPS))
    prog = eng.decode_program
    (cap,) = prog.loops.values()
    graph_stream, other = prog.backend.stream, torch.cuda.Stream(dev)
    batch = eng._make_batch(prompts, None)
    with torch.no_grad():
        logits, caches, _ = eng.prefill(batch)
    src = {"logits": logits, "caches": caches}
    dst = tree_map(torch.empty_like, src)
    work = {"prefill": lambda: eng.prefill(batch),
            "3 prefills": lambda: [eng.prefill(batch) for _ in range(3)],
            "static copies": lambda: tree_map2(
                lambda d, s: d.copy_(s), dst, src),
            "replay": cap.graph.replay}
    wheres = {"device idle": (graph_stream, False, False),
              "behind a slot, the graph's stream": (graph_stream, True,
                                                    False),
              "behind a slot, a free second stream": (other, True, False),
              "behind a slot, a second stream waiting on it": (other, True,
                                                               True)}

    def host_ms(stream, fn, behind_slot: bool, wait: bool) -> float:
        torch.cuda.synchronize()
        if behind_slot:
            handle = eng.dispatch(prompts, STEPS)
            if wait:
                stream.wait_event(handle.done)
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        if behind_slot:
            eng.await_result(handle)
        torch.cuda.synchronize()
        return ms

    def dispatch_ms(depth: int, waiter: str = "") -> float:
        """Host ms of a dispatch with ``depth`` slots ahead; ``waiter``: a
        thread meanwhile blocked on the last slot ahead (the scheduler's
        completion waiter), through its ``done`` event ("spinning", CUDA's
        default) or through an event made with ``blocking=True``."""
        torch.cuda.synchronize()
        ahead = [eng.dispatch(prompts, STEPS) for _ in range(depth)]
        thread = None
        if waiter:
            ev = ahead[-1].done
            if waiter == "blocking":
                ev = torch.cuda.Event(blocking=True)
                ev.record(graph_stream)
            thread = threading.Thread(target=ev.synchronize)
            thread.start()
            time.sleep(0.002)
        t0 = time.perf_counter()
        handle = eng.dispatch(prompts, STEPS)
        ms = (time.perf_counter() - t0) * 1e3
        for h in ahead + [handle]:
            eng.await_result(h)
        if thread is not None:
            thread.join()
        return ms

    out = {"card": card, "reps": REPS}

    def keep(key, runs):
        out[key] = dict(median_ms=statistics.median(runs), runs_ms=runs)
        print(f"{key}: host ms median {statistics.median(runs):.3f}"
              f" ({', '.join(f'{r:.3f}' for r in runs)})", flush=True)

    with torch.no_grad():
        for name, fn in work.items():
            for where, (stream, behind, wait) in wheres.items():
                keep(f"{name}, {where}",
                     [host_ms(stream, fn, behind, wait)
                      for _ in range(REPS)])
        for depth in DEPTHS:
            keep(f"dispatch, {depth} slots in flight",
                 [dispatch_ms(depth) for _ in range(REPS)])
        for waiter in ("spinning", "blocking"):
            keep(f"dispatch, 1 slot in flight, a thread waiting on it "
                 f"({waiter} event)",
                 [dispatch_ms(1, waiter) for _ in range(REPS)])
        sched_reqs = cs.serve_requests(cfg, SCHED_REQUESTS, 3, 128, STEPS)
        for profiled in (False, True):
            prof = cProfile.Profile() if profiled else None
            runs = scheduler_dispatch_ms(eng, sched_reqs, prof)
            keep(f"dispatch through the overlapped scheduler"
                 f"{', profiled' if profiled else ''}", runs)
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(
            PROFILE_LINES)
        print(text.getvalue(), flush=True)
    print(card)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


def scheduler_dispatch_ms(eng: ServingEngine, reqs, prof=None) -> list:
    """Host ms of every dispatch the overlapped scheduler (depth 1) makes
    serving ``reqs`` on ``eng``; ``prof`` (a ``cProfile.Profile``) runs
    inside each dispatch when given."""
    times = []
    dispatch = eng.dispatch

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        try:
            return dispatch(*args, **kwargs)
        finally:
            if prof is not None:
                prof.disable()
            times.append((time.perf_counter() - t0) * 1e3)

    eng.dispatch = timed
    try:
        torch.cuda.synchronize()
        sched = MultiTenantScheduler(eng, max_batch=4,
                                     tenancy=TenancyConfig(1, 3),
                                     mode="overlapped", stage_depth=1)
        for r in reqs:
            sched.submit(Request(r.tenant, r.prompt.copy(),
                                 r.max_new_tokens))
        sched.drain()
        sched.close()
    finally:
        del eng.dispatch
    return times


if __name__ == "__main__":
    sys.exit(main())
