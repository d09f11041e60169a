#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Sets up the cell (inputs and weights from the
seed, made on the card; the warm-up of every shape its traffic uses),
measures for ``--seconds``, checks what the timed path produced against the
plain reference under ``perfbench/reference/``, and prints one JSON object
as the last line of standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``.  The numbers that
decided ``correct`` come last there, under ``checks``, and as the last lines
of standard error.  Exits 2 without the CUDA devices the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))

import harness  # noqa: E402


def finite(x):
    """JSON has no infinity or NaN: such a number is printed as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.Spec.load(ROOT)
    cell = spec.cell(args.workload)
    harness.fix_caches(ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START)
    print("phases: " + json.dumps(out.pop("phases", {})), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(finite(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
