"""Time the SSD scan's tensor-core kernel at both head tiles, on one CUDA
device, at mamba2-2.7b's prefill shapes: x (b, 512, 80, 64) bf16, B and C
one group's (b, 512, 1, 128) viewed over the 80 heads, chunk 256, at
widths b = 8 and 1.

    python3 diagnostics/ssd_head_tiles.py [--out tiles.json]

The wrapper picks the tile itself (``ssd_scan.head_tile``: 2 heads a block
when B and C are shared and the grid still fills the card, else 1); here
the rule is swapped for a constant, one tile at a time, to see what the
other choice would cost.  Each tile's result is held against the plain
version at the bf16 holds, the two tiles' results are compared bit for bit,
and the two are timed in turns (chosen, other, other, chosen), each turn
the median of 10 calls by CUDA events with the L2 flushed before each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch

import chip_smoke as cs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as ssd


def path_args(b: int, dev):
    """mamba2's prefill inputs at width ``b``, as ``chip_smoke.py`` draws
    them: 384 steps padded by ``ops.ssd`` to two chunks of 256."""
    f = cs.SSD_FULL
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = rnd(b, f["L"], f["H"], f["P"]).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rnd(b, f["L"], f["H"]))
    a = -torch.exp(rnd(f["H"]))[None, None, :] * dt
    B, C = (rnd(b, f["L"], 1, f["N"]).to(torch.bfloat16).expand(
        -1, -1, f["H"], -1) for _ in range(2))
    pad = (-f["L"]) % f["chunk"]
    return [kops._pad_steps(t, pad) for t in (x, dt, a, B, C)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    f, Q = cs.SSD_FULL, cs.SSD_FULL["chunk"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    errs = cs.Errors()
    result = {}
    for b in (8, 1):
        xs = path_args(b, dev)
        chosen = ssd.head_tile(b, f["H"], f["P"], True, sms)
        other = 3 - chosen

        def run(h):
            with mock.patch.object(ssd, "head_tile", lambda *_: h):
                return ssd.ssd_chunked(*xs, chunk=Q)

        want = ssd.ssd_chunked_plain(*xs, chunk=Q)
        outs = {h: run(h) for h in (chosen, other)}
        for h, got in outs.items():
            cs.hold_ssd(errs, (got, want), f"width {b}, {h} heads a block")
        same = all(torch.equal(u, v)
                   for u, v in zip(outs[chosen], outs[other]))
        turns = [cs.cuda_ms(lambda: run(h), 10, flush)
                 for h in (chosen, other, other, chosen)]
        result[b] = dict(sms=sms, chosen=chosen, bits_equal=same,
                         ms={chosen: (turns[0] + turns[3]) / 2,
                             other: (turns[1] + turns[2]) / 2},
                         turns=turns, max_abs_err=errs.abs[cs.K6])
        print(f"[tiles] width {b} on {sms} SMs: the rule picks {chosen} "
              f"heads a block; turns {chosen}, {other}, {other}, {chosen}: "
              f"{turns} ms; the two tiles' bits equal: {same}")
        del xs, outs, want
    print(cs.smi_line())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
