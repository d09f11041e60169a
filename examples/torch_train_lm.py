"""End-to-end LM training with the PyTorch port (~100M-param model, a few
hundred steps).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 3

``examples/train_lm.py`` in the port: tenant microbatch accumulation, the
staged prefetch feed, checkpoint/restart.  A ~100M-param qwen3-family
config (float32 compute) trains on the synthetic copy-structure stream;
the loss should fall from ~10.4 to well under 7.  Runs on the CUDA device
unless ``--device cpu`` is given; the last line of the output is one JSON
object ``{"train_lm": {...}}`` with every step's loss.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tenancy import resolve_devices  # noqa: E402
from repro_torch.data.tokens import DataConfig, PrefetchFeed  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_loop import (build_train_step,  # noqa: E402
                                             init_train_state)


def hundred_m_config():
    base = get_config("qwen3-32b")
    return dataclasses.replace(
        base, name="qwen3-100m", num_layers=16, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        fsdp=False, microbatches=2, remat="none",
        param_dtype="float32", compute_dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_devices(1, args.device)[0]           # raises: no card
    cfg = hundred_m_config()
    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    print(f"{cfg.name}: {count_params(params):,} params on {dev}")
    opt = make_optimizer(cfg)
    state = init_train_state(bundle, opt, params)
    step = build_train_step(
        bundle, None, opt,
        lr_fn=lambda s: 3e-4 * torch.clamp(s.float() / 50.0, max=1.0))

    start = ckpt.latest_step(args.ckpt_dir)
    if start:
        state = ckpt.restore(args.ckpt_dir, start, state, device=dev)
        print(f"resumed from step {start}")
    start = start or 0

    dc = DataConfig(args.batch, args.seq, cfg.vocab_size)
    feed = PrefetchFeed(dc, cfg, device=dev, start_step=start)
    losses, t0, t_all = [], time.perf_counter(), time.perf_counter()
    try:
        for i in range(start, args.steps):
            state, metrics = step(state, next(feed))
            losses.append(float(metrics["loss"]))
            if (i + 1) % 20 == 0:
                tps = args.batch * args.seq * 20 / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                print(f"step {i + 1:4d}  loss {losses[-1]:.4f}  "
                      f"{tps / 1e3:.1f}k tok/s", flush=True)
            if (i + 1) % 100 == 0:
                ckpt.save(args.ckpt_dir, i + 1, state)
    finally:
        feed.close()
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"NaN/Inf loss: {losses}")
    if losses:
        print(f"loss: {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}")
    out = {"start": start, "steps": args.steps, "losses": losses,
           "wall_s": time.perf_counter() - t_all, "device": str(dev)}
    print(json.dumps({"train_lm": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
