#!/usr/bin/env python3
"""The knee of a serving cell: the highest offered rate the program
sustains, found once by a sweep on the card.

    python3 perfbench/sweep.py --workload internlm2-chat --rates 10,20,30 \\
        [--seconds 10] [--seed N]

Sets the cell up once, then offers each rate in turn for ``--seconds``
(arrivals as the cell's mix draws them, at that rate) and drains.  Prints
one JSON line a rate: requests due and completed, the queue of requests
not yet admitted over the window (its mean in the first and the last third),
and the first-token and streaming tails.  A rate is sustained when the
queue does not grow over the window.  The cell's traffic file records the
knee and the rate it offers (about four fifths of the knee).
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

import harness  # noqa: E402


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--drain", type=float, default=20.0)
    args = ap.parse_args(argv)
    harness.fix_caches(HERE.parent)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    import devtrace
    spec = harness.Spec.load(HERE.parent)
    cell = spec.cell(args.workload)
    mix = spec.traffic(cell["traffic"])
    drv = harness.load_module(HERE / "drivers" / f"{mix['driver']}.py")
    metrics = {n: harness.load_module(HERE / "metrics" / f"{n}.py")
               for n in ("ttft_p95_ms", "tpot_p95_ms")}
    dev = torch.device("cuda", 0)
    rates = [float(r) for r in args.rates.split(",")]
    c = drv.Cell(spec.config(cell["config"]), dict(mix, rate=max(rates)),
                 args.seed, args.seconds, dev, False)
    print(json.dumps({"setup_s": time.perf_counter() - t_start}), flush=True)
    for k, rate in enumerate(rates):
        c.mix = dict(mix, rate=rate)
        rec = c.window(args.seconds, args.seed + k, devtrace.Tracer(False),
                       0.0, 0.0, drain_s=args.drain)
        q = [n for _, n in rec["queue"]]
        third = max(1, len(q) // 3)
        rows = rec["requests"]
        print(json.dumps({
            "rate": rate, "due": len(rows),
            "completed": sum(r["outcome"] == "completed" for r in rows),
            "queue_first_third": sum(q[:third]) / third,
            "queue_last_third": sum(q[-third:]) / third,
            "queue_max": max(q) if q else 0,
            **{n: m.read(rec) for n, m in metrics.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
