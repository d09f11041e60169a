"""Training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --reduced --device cpu --steps 20

The JAX package's ``repro/launch/train.py``: config -> model bundle -> init
-> prefetch feed -> the supervised step loop, with a heartbeat, a
straggler detector, a checkpoint every ``--save-every`` steps and a final
check that every loss is finite.  Runs on the CUDA device unless ``--device
cpu`` is given (and fails without one otherwise): at full width (no
``--reduced``) the attention and SSD forwards run the hand-written kernels
and each step is timed by CUDA events.  ``--profile-step K`` runs step K
under ``torch.profiler`` and prints the device's busy time against the
step's window.  The last line of the output is one JSON object
``{"train": {...}}``: steps, the first and last loss, the median step ms
(step 1 left out), tokens/s, peak device memory and the feed's wait.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.tenancy import resolve_devices
from repro_torch.data.tokens import DataConfig, PrefetchFeed
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault import HeartbeatMonitor, StragglerDetector
from repro_torch.distributed.sharding import (Mesh, Sharder, null_sharder,
                                              param_shardings)
from repro_torch.models.model import build_model
from repro_torch.models.params import count_params, param_axes
from repro_torch.models.transformer import tree_map2
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import build_train_step, init_train_state


def make_state_and_step(cfg, device, seed: int = 0,
                        mesh: Optional[Mesh] = None):
    """(bundle, train state, step function, sharder) of ``cfg``, the
    parameters drawn from ``seed`` by the port's initialiser on ``device``.
    With a ``mesh`` (the reference's ``make_state_and_step(cfg, mesh=)``)
    they are placed by ``param_shardings`` under ``Sharder(mesh,
    fsdp=cfg.fsdp, seq_shard=cfg.fsdp)``, the optimizer state by its
    ``state_axes``, and the step trains on the mesh."""
    sh = (Sharder(mesh, fsdp=cfg.fsdp, seq_shard=cfg.fsdp)
          if mesh is not None else null_sharder())
    bundle = build_model(cfg)
    opt = make_optimizer(cfg)
    params = bundle.init(seed, device)
    if mesh is not None:
        shards = param_shardings(sh, param_axes(cfg), params)
        params = tree_map2(sh.place_named, params, shards)
    state = init_train_state(bundle, opt, params, sh)
    return bundle, state, build_train_step(bundle, sh, opt), sh


def profile_step(step_fn, state, batch, dev: torch.device):
    """One step under ``torch.profiler``: (state, metrics, the device's
    busy ms by kernel against the step's CUDA-event window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = step_fn(state, batch)
        b.record()
        b.synchronize()
    window_ms = a.elapsed_time(b)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    prof_out = {"window_ms": window_ms, "device_busy_ms": busy,
                "device_idle_share": 1 - busy / window_ms if kernels else None,
                "launches": sum(k[2] for k in kernels),
                "top": [(n[:60], round(ms, 3), c) for n, ms, c in kernels[:8]]}
    return state, metrics, prof_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-step", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_devices(1, args.device)[0]           # raises: no card
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    bundle, state, step_fn, _ = make_state_and_step(cfg, dev, args.seed)
    n_params = count_params(state["params"])
    print(f"arch={cfg.name} params={n_params:,} device={dev} "
          f"optimizer={cfg.optimizer} microbatches={cfg.microbatches} "
          f"remat={cfg.remat} compute={cfg.compute_dtype}", flush=True)

    dc = DataConfig(args.batch, args.seq, cfg.vocab_size, seed=args.seed)
    feed = PrefetchFeed(dc, cfg, device=dev)
    monitor = HeartbeatMonitor(timeout_s=600)
    detector = StragglerDetector()

    losses, step_ms = [], []
    prof: Optional[Dict[str, Any]] = None
    t_start = time.perf_counter()
    try:
        for i in range(args.steps):
            t0 = time.perf_counter()
            batch = next(feed)
            if cuda and i == args.profile_step:
                state, metrics, prof = profile_step(step_fn, state, batch,
                                                    dev)
                step_ms.append(prof["window_ms"])
            elif cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state, metrics = step_fn(state, batch)
                b.record()
                b.synchronize()
                step_ms.append(a.elapsed_time(b))
            else:
                state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if not cuda:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            monitor.beat()
            detector.update({0: time.perf_counter() - t0})
            if args.ckpt_dir and (i + 1) % args.save_every == 0:
                ckpt.save(args.ckpt_dir, i + 1, state)
            if (i + 1) % args.log_every == 0:
                print(f"step {i + 1:4d} loss {loss:.4f} "
                      f"aux {float(metrics['aux']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{step_ms[-1]:.0f} ms", flush=True)
    finally:
        feed.close()
    wall = time.perf_counter() - t_start
    timed = step_ms[1:] or step_ms
    med = statistics.median(timed)
    out = {"arch": cfg.name, "params": n_params, "device": str(dev),
           "steps": len(losses), "final_step": int(state["step"]),
           "batch": args.batch, "seq": args.seq, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": losses, "step_ms": step_ms,
           "median_step_ms": med, "step_ms_by": "cuda events" if cuda
           else "host clock", "tokens_per_s": args.batch * args.seq / med * 1e3,
           "feed_wait_ms": feed.wait_s * 1e3, "wall_s": wall,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if cuda else None), "profile": prof}
    print(f"done: {args.steps} steps in {wall:.1f}s; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; median step {med:.1f} ms ({out['step_ms_by']}),"
          f" {out['tokens_per_s']:.0f} tokens/s", flush=True)
    if prof is not None:
        print(f"profile: step {args.profile_step} window "
              f"{prof['window_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms over {prof['launches']} "
              f"kernels; by kernel: {prof['top']}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"NaN/Inf loss: {losses}")
    print(json.dumps({"train": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
