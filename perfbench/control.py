#!/usr/bin/env python3
"""The control of a cell's correctness check, run on the card.

    python3 perfbench/control.py --workload NAME --seeds 1,2,3 [--seconds S]

For each seed, one run of the cell as ``run.py`` makes it, at the cell's
own size and load, whose check also reads the control: the plain reference
put in the program's place one precision below the configuration's --
bfloat16 year losses for the float32 risk tables, float8 (e4m3) weights for
the bfloat16 model.  Prints one JSON line a seed: the number the program
reads, the number the control reads, and the limit.  The benchmark's own
runs never run the control.
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    harness.fix_caches(HERE.parent)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec.load(HERE.parent)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(spec, args.workload, seed, args.seconds,
                               False, torch.device("cuda", 0),
                               time.perf_counter(),
                               overrides={"control": True})
        for name, c in out["checks"].items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "check": name, "program": c["value"],
                              "control": out["control"][name],
                              "limit": c["limit"],
                              "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
