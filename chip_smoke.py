#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls:

* Aggregate Risk Analysis under a multi-tenancy plan at the published width
  (K = 1000 events per trial, M = 15 ELTs, a 2,000,000-event catalog,
  T = 1,000,000 trials unless host memory forces fewer);
* multi-tenant continuous serving of internlm2-1.8b at its published width
  (24 layers, d_model 2048, random weights from a seed) through
  ``repro_torch.launch.serve``, with and without a shared prompt prefix;
* multi-tenant continuous serving of the pure-SSM mamba2-2.7b at its
  published width and depth (64 Mamba-2 layers, d_model 2560, 80 SSD heads
  of 64, state 128, random weights from a seed) through the same entry
  point, every prefill through the SSD scan kernel;
* multi-tenant continuous serving of the MoE olmoe-1b-7b at its published
  width and depth (16 layers, d_model 2048, 16 heads x 128 with qk-norm, 64
  experts top-8, random weights from a seed) through the same entry point,
  every prefill's attention through the FlashAttention kernel and every
  decode step's through the paged decode kernel at group size 1;
* ``serve-archs``: multi-tenant serving of the four remaining
  decoder-only archs at their published widths through the same entry
  point, cut in depth to fit the card -- mistral-large-123b (16 of 88
  layers, GQA 96:8), jamba-1.5-large-398b (layers 0-4: Mamba-2 and
  attention layers, MoE top-2 of 16; both state kinds in one slot table),
  llama4-maverick-400b-a17b (2 of 48 layers, 128 experts top-1 beside a
  shared one) and llava-next-mistral-7b (whole; patch embeddings merged
  into the prompt) -- continuous, and jamba and llava also overlapped;
* ``serve-whisper``: the encoder-decoder whisper-base at its published
  width and depth (6 encoder and 6 decoder layers, d_model 512, 8 heads of
  64, 1,500 encoder frames a request from ``synth_extra_inputs``) through
  the same entry point, continuous and overlapped: every prefill encodes
  the frames (the FlashAttention kernel non-causal over 1,500 frames, and
  at Sq 64 against 1,500 keys for the cross attention), admission writes
  each request's cross K/V into its private cross pages with the scatter
  kernel, and every decode step reads the self pages through the paged
  decode kernel and attends to the gathered cross pages;
* ``serve-overload``: overload and crash safety at full width --
  internlm2-1.8b, mamba2-2.7b and whisper-base each with a slot table of 8
  tier-1 rows (128-token prompts, 96 new tokens; whisper's 64) hit by a
  tier-0 burst that preempts through the pinned host swap tier while
  ``max_backlog`` sheds, then the same traffic under a ``FaultPlane``
  dropping rounds, stalling admissions and poisoning swap reads;
* ``serve-crash``: ``launch.serve`` children at internlm2-1.8b's full
  width with a request journal and checkpoints every 4 rounds, killed by
  SIGKILL at round 6 and inside a swap-out, then recovered by fresh
  processes, every request's tokens equal to an uncrashed run's;
* ``mesh``: the device mesh on this one card, its positions the card
  repeated -- ``launch.serve --mesh 1x1`` at internlm2-1.8b's full width
  against the same run without a mesh (tokens and final logits bit for
  bit), then 1x2 and 1x8 meshes through the Python API (the K/V pools split
  on KV heads, every decode and admission one kernel launch a shard) on a
  prefix-sharing mix with a pool tight enough to recycle cached pages,
  greedy tokens against no mesh, and a preempt / restore cycle through the
  per-position staging lanes; ``mesh risk``: the risk step at the
  published size with its trials split over a 1x4 mesh
  (``make_sharded_step``) against ``run_single``;
* training: ``repro_torch.launch.train`` at the published widths and
  depths of internlm2-1.8b, mamba2-2.7b and whisper-base (batch 8, 6 AdamW
  steps, random weights from a seed), every attention forward and its
  recompute through the FlashAttention kernel with its log-sum-exp, every
  Mamba-2 forward through the SSD scan kernel, the backwards the
  reference's own (it has no backward kernel).

Every serving path decodes through rounds captured as CUDA graphs and
replayed (``serving.continuous.RoundProgram``); the same admissions of
each of the three full-width models also run through an engine that
enqueues its rounds op by op, and the two engines' tokens, round times,
capture times and memory are compared.  Every attention prefill of every
path (internlm2's, h2o-danube's and olmoe's) runs the FlashAttention
kernel, and every admission writes its K,
V and positions with one launch of the scatter kernel per attention
sub-layer.  Both variants of the risk path run two kernels a call (a row
pass writing each catalog row's clipped loss, then the gather's trial pass
over the ids, or the onehot variant's per-trial event histogram times the
row losses), the SSD scan of mamba2's bf16 prefill its tensor-core kernel.

It builds every CUDA kernel from the sources in this checkout (one ``nvcc``
per source, all started together), holds each against its plain PyTorch
version on the card, and shows by the launch counters that each path went
through its kernels.  Any failed phase ends the run with a non-zero exit
code; without a CUDA device nothing runs.  The last line of a good run is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

The risk path also runs the paper's loop on the card, on warm engines at
the published size: ``power`` (the card's ``PowerParams`` fitted from its
own energy counter over idle, risk and K1 windows), ``fit`` (the perf model
fitted from a sequential 1x1..1x8 sweep's device windows, then
``plan_from_telemetry`` and the chosen deployment run beside the model's
time) and ``pairs`` (1x2 and 1x4, sequential against concurrent staging in
repeated ABBA pairs, time and energy, beside the simulator's prediction).
``serve-obs`` serves internlm2-1.8b at full width with the telemetry plane
lit (trace, metrics, ``obs:`` lines) and holds its tokens to the plane-off
run's.  ``serve-slots`` serves the three models at full width through the
tenant-slot schedules, ``overlapped`` (the reference's default: the decode
loop of each tenant batch one captured CUDA graph, the next batches
dispatched under it) against ``blocking`` (``generate`` per batch):
token-identical, equal to ``generate`` on each padded batch, overlap pairs
>= 1 and 0; then, on one warm internlm2 engine, blocking, overlapped at
stage depths 1-3 and continuous on the same requests, and one dispatch
under ``set_sync_debug_mode("error")``.

Phases: device, build, kernels (aggregate sweep), paged kernels (the
reference's cases), ssd kernel (the reference's sweep and the edges), flash
kernel (the reference's sweep and the edges), tables, kernels (full width),
main path (gather, full width), power, fit, pairs, mesh risk, main path
(onehot, 1,000,000 trials, catalog cut), cli, serving (reduced internlm2, h2o-danube
and mamba2, token-exact with ``generate`` through graph rounds of several
keys, and reduced olmoe), serving (full width, internlm2; then its rounds
eager against graph), serve-obs, paged kernels (full width), paged decode
at the chat deployment's 64 capacity rows with and without the round's row
mask (live rows bit for bit, masked rows zero, a captured call replayed
under other masks), serving (full
width, mamba2; rounds eager against graph), ssd kernel (full width),
serving (full width, olmoe; rounds eager against graph), paged decode
(olmoe's shape), flash kernel (full width), serve-slots (full width,
internlm2, mamba2 and olmoe, overlapped against blocking; the stage-depth
sweep), serve-archs (the four archs above; each kernel's launches by the
arch's sub-layers, every state kind conserved, mistral's and llava's
logits at each step against ``generate``'s, jamba's repeated prompt
prefilled again, rounds eager against graph; then K3, K5 and K6 held and
timed at the archs' head layouts and shapes), serve-whisper (continuous:
launches by sub-layer, the pool and the cross space conserved, every
request's cross row taken and given back, logits at each step against
``generate``'s, the repeated prompt with its frames prefilled again,
rounds eager against graph; overlapped: tokens equal to ``generate`` per
batch; then K3, K4 and K5 held and timed at whisper's shapes),
serve-overload (per arch: every request one outcome, the victims -- greedy
and seeded-sampling rows -- token-identical to the same requests run
without preemption in the same engine, restored rows bit for bit their
snapshots, both tiers conserved and the host tier empty, no round key
captured again, every dispatch and restore under
``set_sync_debug_mode("error")``, launches by sub-layer with the restores'
scatter launches; swap-out, prefetch (beside bytes over the risk staging's
host-to-device rate), restore wait and restore-write times, replayed
rounds with and without a swap before them), serve-crash (both children
exit -9, the recovered journals' tokens equal the uncrashed ones'; journal
append us as a share of a replayed round, checkpoint ms and bytes, recover
ms), mesh (the sharded decode and scatter against the unsharded kernels,
bit for bit: the reference's three dispatch shapes at 1x8, then internlm2's
full-width decode and admission at 1x2, 1x4 and 1x8, the decode timed at
each; then the serving checks above, launches a shard, replayed round ms
and peak memory beside no mesh), then training: train-kernels (``FlashAttentionFn`` and
``SsdChunkedFn`` against autograd through the plain versions -- forward,
log-sum-exp, every input's grad -- over the reference's grad cases and
the training shapes in float32 and bf16; K5 with and without the
log-sum-exp, the backwards and ``scaled_dot_product_attention``'s forward
and backward timed), train-reduced (every arch, one step on the card
against the CPU), train (the three runs above: launches by layer, one
profiled step, step ms, tokens/s, model-FLOPs share, peak memory), the
checks (internlm2's gradient against finite differences in float32, 2
tenant microbatches against 1), train-recovery (``run_with_recovery``
with an injected failure, bit for bit) and train-lm
(``examples/torch_train_lm.py``, 300 steps, the loss falling).  The
serving reduced phase
runs every decoder-only arch, and a hybrid without MoE.  Each phase's
seconds are printed at the end.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core import perfmodel as pm
from repro_torch.core import planner
from repro_torch.core.pipeline import timeline_overlaps
from repro_torch.core.simulator import SimInputs, simulate
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.distributed.fault import FaultPlane
from repro_torch.kernels import aggregate_loss as agg
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import risk as risk_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.model import build_model, param_count
from repro_torch.models.layers import apply_unembed, dtype_of, unembed_operand
from repro_torch.models.transformer import (init_footprint, tree_leaves,
                                            tree_map, tree_map2)
from repro_torch.data.tokens import DataConfig, synth_batch
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import (Mesh, Sharder, ShardedTensor,
                                              parse_mesh, serving_sharder)
from repro_torch.distributed.fault import run_with_recovery
from repro_torch.launch import train as train_cli
from repro_torch.models.attention_core import blockwise_attention_bwd
from repro_torch.training import grad_compression as gcomp
from repro_torch.training.optimizer import Optimizer, make_optimizer
from repro_torch.training.train_loop import build_train_step, init_train_state
from repro_torch.obs import TELEMETRY
from repro_torch.obs import fit as obs_fit
from repro_torch.obs.export import parse_prometheus_text
from repro_torch.obs.gauge import PowerGauge
from repro_torch.obs.telemetry import Telemetry
from repro_torch.risk import metrics
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import (GENERATE_PEAK_BYTES_PER_EVENT, RiskTables,
                                     generate)
from repro_torch.serving import journal as journal_mod
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import POS_SENTINEL, PagedKVCache
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores (every kernel here does its arithmetic in plain float32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version: the JAX package's own tolerance for kernel vs
# oracle; the two sum the same terms in different orders
RTOL, ATOL = 1e-5, 1e-3
# paged decode vs its plain version: tests/test_paged_attention.py::_agree
# (online softmax across pages vs one full-row softmax); the scatter is a
# cast and a copy, held bit for bit
PAGED_RTOL, PAGED_ATOL = 3e-5, 3e-6
# one schedule vs another of the same kernel (tests/test_risk.py)
YLT_RTOL = 1e-6

TRIAL_GRAIN = 65536          # T is cut, if at all, to a multiple of this
FULL_WIDTH_TRIALS = 16384    # gather vs plain at full width

# the JAX package's sweep (tests/test_kernels_aggregate.py) plus the edges
# the kernels mask themselves: T, K, M, catalog, chunk, rows_tile
SWEEP = [
    (64, 32, 3, 512, 16, None),
    (128, 64, 5, 1000, 32, 256),
    (32, 16, 1, 100, 8, 64),
    (256, 128, 15, 4096, 128, 512),
    (17, 24, 2, 50, 8, None),        # odd trial count
    (48, 96, 7, 333, 48, 100),       # non-pow2 catalog/tile
    (33, 1000, 15, 2000, 128, 256),  # K = 1000 is not a multiple of 128
    (40, 200, 10, 300, 64, 128),     # three float4 per row
    (24, 70, 20, 150, 32, 64),       # M > 16: two column groups
]
ONEHOT_TIMED = [(256, 128, 15, 4096, 128, None),     # largest of the sweep
                (1024, 128, 15, 65536, 128, None)]   # five catalog tiles
# the onehot variant's main path: the paper's 1,000,000 trials, the catalog
# cut to 4,096 events (one tile of the kernel; the published 2,000,000 would
# take 140 tiles, each a read of the ids)
ONEHOT_MAIN_CATALOG = 4096
ONEHOT_MAIN_TRIALS = 1_000_000
ONEHOT_CUT_TRIALS = 2048     # a small call, timed beside the chunk
ONEHOT_BLOCK = 4096          # trials of a block held against the plain version


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device() -> str:
    line = smi_line()
    print(line, flush=True)
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-2:]
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]} | nvcc: {' | '.join(nvcc)}")
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
                  f" | {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB")
    return line


def _entry_name(line: str) -> str:
    """A readable name for the entry ptxas compiles: the kernel, with its
    template arguments (``gather_kernel<NV=4>``, ``paged_decode_kernel<8,
    bf16>``)."""
    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"\d+([a-z_]+_kernel)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end(1):]        # I<template args>E, then E v (params)
    targs = (rest[1:rest.find("EEv")]
             if rest.startswith("I") and "EEv" in rest else "")
    pretty = [t[2:-1] if t.startswith("Li") else
              "bf16" if "bfloat" in t else "f32"
              for t in re.findall(r"Li\d+E|13__nv_bfloat16|f", targs)]
    return f"{m.group(1)}<{','.join(pretty)}>" if pretty else m.group(1)


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.compile_all()
    dt = time.perf_counter() - t0
    for src, log in logs.items():
        # ptxas names an entry, then reports what it uses
        used, spills, entry = [], [], "?"
        for l in log.splitlines():
            if "Compiling entry function" in l:
                entry = _entry_name(l)
            elif "Used" in l:
                used.append(f"{entry} "
                            f"{l.split('Used', 1)[1].split(',')[0].strip()}")
            elif ("spill" in l and
                  "0 bytes spill stores, 0 bytes spill loads" not in l):
                spills.append(f"{entry}: {l.strip()}")
        check(len(used) >= 2, f"{src}: ptxas reported fewer than two kernels")
        say("build", f"{src}.cu -> {build.library_path(src).name} "
                     f"({len(used)} kernel instances: {'; '.join(used)}; "
                     f"spills: {'; '.join(spills) or 'none'})")
        build.load_library(src)
    say("build", f"nvcc sm_90a, {len(logs)} sources at once: {dt:.1f} s")


# ---------------------------------------------------------------------------
def phase_tables(cfg: RiskAppConfig) -> RiskTables:
    K = cfg.events_per_trial
    avail = None
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    check(avail is not None, "cannot read MemAvailable")
    # generate()'s peak plus the pinned copy of the YET, and 4 GiB of slack
    per_trial = K * (GENERATE_PEAK_BYTES_PER_EVENT + 4)
    fit = (avail - (4 << 30)) // per_trial // TRIAL_GRAIN * TRIAL_GRAIN
    T = cfg.num_trials
    if fit < T:
        check(fit >= TRIAL_GRAIN, f"host memory {avail / 2**30:.1f} GiB holds "
                                  f"no {TRIAL_GRAIN}-trial table")
        T = int(fit)
        say("tables", f"T cut {cfg.num_trials} -> {T}: generate() needs "
                      f"{per_trial} B per trial and the host has "
                      f"{avail / 2**30:.1f} GiB available")
    cfg = dataclasses.replace(cfg, num_trials=T)
    t0 = time.perf_counter()
    tables = generate(cfg, seed=0)
    t1 = time.perf_counter()
    tables = tables.pinned()
    t2 = time.perf_counter()
    nb = tables.nbytes()
    say("tables", f"T={T} K={K} M={cfg.num_elts} catalog={cfg.event_catalog} "
                  f"(host available {avail / 2**30:.1f} GiB): YET "
                  f"{nb['yet'] / 1e9:.2f} GB, ELT {nb['elt'] / 1e6:.1f} MB; "
                  f"generate {t1 - t0:.1f} s, pin {t2 - t1:.1f} s")
    return tables


# ---------------------------------------------------------------------------
def make_case(rng, T, K, M, cat, device):
    ids = rng.integers(0, cat + 1, (T, K)).astype(np.int32)
    elt = np.abs(rng.normal(size=(cat + 1, M))).astype(np.float32)
    elt[0] = 0.0
    occ_r = (np.abs(rng.normal(size=M)) * 0.5).astype(np.float32)
    occ_l = (np.abs(rng.normal(size=M)) + 1.0).astype(np.float32)
    return (*(torch.from_numpy(a).to(device) for a in (ids, elt, occ_r, occ_l)),
            float(K * 0.1), float(K * 0.8))


G, O = "aggregate_loss_gather", "aggregate_loss_onehot"
R = "aggregate_row_losses"           # the gather's row pass
K3, K4 = "paged_attention_decode", "paged_prefill_scatter"
K6 = "ssd_chunked"
K5 = "flash_attention"
# the training backwards' grads, held apart from the kernels' forwards
K5B, K6B = "flash_attention_bwd", "ssd_chunked_bwd"
# SSD scan vs its plain version: tests/test_kernels_ssd.py's tolerances --
# float32 1e-4 (the chunk's cumulative decay is summed in another order and
# exp(a_cum[l] - a_cum[s]) amplifies the difference); bfloat16 inputs are
# compared in the working type, 5e-2 on y and 2e-2 on the state
SSD_RTOL = SSD_ATOL = 1e-4
SSD_BF16_Y, SSD_BF16_STATE = 5e-2, 2e-2
# FlashAttention vs its plain version: tests/test_kernels_flash.py's
# float32 tolerance, 2e-4 (online softmax over other blocks, sums in
# another order).  Both sides compute bfloat16 inputs in float32, so a
# bfloat16 output is the same float32 result rounded: held to a few bf16
# ulps (rtol 1e-2 > 2^-8), against the plain version's bfloat16 output or
# its float32 output on the same rounded inputs.  Against
# scaled_dot_product_attention, whose P.V is in bfloat16, the reference's
# bfloat16 tolerance, 5e-2
FLASH_RTOL = FLASH_ATOL = 2e-4
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 1e-2, 1e-3
FLASH_SDPA = 5e-2
TOL = {G: (RTOL, ATOL), O: (RTOL, ATOL), K3: (PAGED_RTOL, PAGED_ATOL),
       K6: (SSD_RTOL, SSD_ATOL), K5: (FLASH_RTOL, FLASH_ATOL)}


class Errors:
    """Largest disagreement seen per kernel, over every comparison."""

    def __init__(self):
        self.abs = dict.fromkeys((G, R, O, K3, K4, K6, K5, K5B, K6B), 0.0)
        self.rel = dict(self.abs)
        self.cases = dict.fromkeys(self.abs, 0)

    def hold(self, name: str, got: torch.Tensor, want: torch.Tensor,
             what: str, tol=None) -> None:
        """``got`` against ``want`` at the kernel's tolerance (or ``tol``);
        a bfloat16 pair is compared in float32, each side widened."""
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype
              and got.dtype in (torch.float32, torch.bfloat16),
              f"{name} {what}: shape/dtype {got.shape} {got.dtype}")
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        diff = (got - want).abs()
        a = float(diff.max()) if diff.numel() else 0.0
        r = float((diff / want.abs().clamp_min(1e-30))[want != 0].max()) \
            if bool((want != 0).any()) else 0.0
        self.abs[name] = max(self.abs[name], a)
        self.rel[name] = max(self.rel[name], r)
        self.cases[name] += 1
        rtol, atol = tol or TOL[name]
        check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
              f"{name} {what}: max abs err {a:.3g}, max rel err {r:.3g} "
              f"outside rtol={rtol} atol={atol}")

    def hold_bits(self, name: str, got: torch.Tensor, want: torch.Tensor,
                  what: str) -> None:
        """Bit for bit (the scatter: a cast and a copy)."""
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {what}: shape/dtype {got.shape} {got.dtype}")
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
        self.cases[name] += 1
        if not same:
            a = float((got.float() - want.float()).abs().max())
            self.abs[name] = max(self.abs[name], a)
        check(same, f"{name} {what}: not bit-exact")


HOLD_CYCLES = 2_000_000      # ~1 ms of device clock: the host's lead


def cuda_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median time of ``fn`` by CUDA events, the L2 cache flushed before
    each, after one untimed call.  The device spins after the flush, so
    the host has enqueued all of ``fn`` before the first event fires: the
    window holds device time only, not the host's launch gaps (which matter
    for calls of a few µs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(T, K, M, rows):
    """The least time the card could take for the function both kernels
    compute: every input read once and the output written once at the memory
    rate, or its operations (subtract, max, min, add per loss; the aggregate
    terms per trial) at the float32 rate, whichever is larger."""
    nbytes = T * K * 4 + rows * M * 4 + 2 * M * 4 + T * 4
    flops = 4 * T * K * M + 3 * T
    by, op = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


def row_bound_ms(rows, M):
    """The row pass alone: the table's M columns read once and f written
    once at the memory rate, or its 4 M operations a row at the float32
    rate, whichever is larger."""
    by = (rows * M * 4 + 2 * M * 4 + rows * 4) / PEAK_BYTES_PER_S * 1e3
    op = 4 * rows * M / PEAK_F32_FLOPS * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


def gather_traffic_ms(T, K):
    """Not the bound: what the gather algorithm pulls if no row is reused,
    an id and one 64 B row per event, at the memory rate."""
    return (T * K * (4 + 64) + T * 4) / PEAK_BYTES_PER_S * 1e3


def onehot_ids_ms(T, K, rows):
    """Not the bound: what the onehot design reads, the ids once per catalog
    tile of the kernel and the row pass's table, at the memory rate."""
    tiles = -(-rows // agg.ONEHOT_MAX_ROWS_TILE)
    return (tiles * T * K * 4 + rows * 16 * 4) / PEAK_BYTES_PER_S * 1e3


def phase_kernels_small(errs: Errors, dev) -> None:
    """Both kernels against their plain versions over the sweep and the
    edge cases; needs no tables."""
    rng = np.random.default_rng(0)
    for T, K, M, cat, chunk, rt in SWEEP:
        args = make_case(rng, T, K, M, cat, dev)
        what = f"T{T} K{K} M{M} cat{cat} chunk{chunk}"
        want = agg.aggregate_loss_gather_plain(*args, chunk=chunk)
        padded = (args[0], agg.pad_elt_columns(args[1]), *args[2:])
        errs.hold(G, agg.aggregate_loss_gather(*padded, chunk=chunk), want,
                  what)
        errs.hold_bits(R, agg.aggregate_row_losses(*padded[1:4]),
                       agg.aggregate_row_losses_plain(*args[1:4]), what)
        errs.hold(O, agg.aggregate_loss_onehot(*args, chunk=chunk,
                                               rows_tile=rt),
                  agg.aggregate_loss_onehot_plain(*args, chunk=chunk,
                                                  rows_tile=rt), what)
        errs.hold(O, agg.aggregate_loss_onehot(*padded, chunk=chunk,
                                               rows_tile=rt),
                  want, what + " vs gather plain")

    # all-pad trials, clipping, int64 ids, ids outside the table
    ids = torch.zeros((8, 16), dtype=torch.int32, device=dev)
    elt = torch.ones((100, 3), device=dev)
    elt[0] = 0.0
    try:
        agg.aggregate_loss_gather(ids, elt, torch.zeros(3, device=dev),
                                  torch.ones(3, device=dev), 0.0, 1e9)
    except ValueError:
        pass
    else:
        raise PhaseFailed("gather took a table whose rows are not padded")
    elt = agg.pad_elt_columns(elt)
    z3, big = torch.zeros(3, device=dev), torch.full((3,), 1e9, device=dev)
    for name, fn in ((G, agg.aggregate_loss_gather),
                     (O, agg.aggregate_loss_onehot)):
        errs.hold(name, fn(ids, elt, z3, big, 0.0, 1e9, chunk=16),
                  torch.zeros(8, device=dev), "all-pad")
        before = agg.launch_counts[name]
        none = fn(ids[:0], elt, z3, big, 0.0, 1e9, chunk=16)
        check(none.shape == (0,) and agg.launch_counts[name] == before,
              f"{name}: no trials, yet a launch was counted")
        one = torch.tensor([[1]], dtype=torch.int32, device=dev)
        e1 = agg.pad_elt_columns(torch.zeros((3, 1), device=dev))
        e1[1, 0] = 10.0
        y = fn(one, e1, torch.tensor([2.0], device=dev),
               torch.tensor([5.0], device=dev), 1.0, 3.0, chunk=1)
        errs.hold(name, y, torch.tensor([3.0], device=dev), "clipping")
        args = list(make_case(rng, 32, 32, 3, 128, dev))
        args[1] = agg.pad_elt_columns(args[1])
        a32 = fn(*args, chunk=16)
        args[0] = args[0].long()
        errs.hold(name, fn(*args, chunk=16), a32, "int64 ids")
        bad = args[0].clone()
        bad[:, ::5] = 129 + 7
        bad[:, 1::7] = -3
        clean = torch.where((bad < 0) | (bad > 128), torch.zeros_like(bad), bad)
        errs.hold(name, fn(bad, *args[1:], chunk=16),
                  agg.aggregate_loss_gather_plain(clean, *args[1:], chunk=16),
                  "ids outside the table")

    # a trial whose events all hit one row (a count of 1000, and of 4000)
    for K in (1000, 4000):
        args = list(make_case(rng, 20, K, 15, 300, dev))
        args[0][3] = 7
        args[0][5, ::2] = 299
        want = agg.aggregate_loss_gather_plain(*args, chunk=128)
        errs.hold(O, agg.aggregate_loss_onehot(*args, rows_tile=64), want,
                  f"K{K} one row a trial, 5 tiles")

    for name, fn in ((G, agg.aggregate_loss_gather),
                     (O, agg.aggregate_loss_onehot)):
        before = (agg.launch_counts[name], agg.launch_counts[R])
        fn(*padded, chunk=16)
        check((agg.launch_counts[name], agg.launch_counts[R])
              == (before[0] + 1, before[1] + 1),
              f"a {name} call did not launch the row pass and its own "
              f"kernel once each")
    say("kernels", f"sweep and edge cases hold: gather {errs.cases[G]}, "
                   f"row pass {errs.cases[R]} bit for bit, onehot "
                   f"{errs.cases[O]} comparisons")


def phase_kernels_full(errs: Errors, tables: RiskTables, dev) -> dict:
    """The gather kernel at full width and at the main path's shape, the
    onehot kernel at its timed shapes; returns the numbers per kernel."""
    rng = np.random.default_rng(1)
    # full width: the real ELT, real YET rows
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    elt = agg.pad_elt_columns(torch.from_numpy(tables.elt_losses).to(dev))
    ret = torch.from_numpy(tables.occ_ret).to(dev)
    lim = torch.from_numpy(tables.occ_lim).to(dev)
    terms = (elt, ret, lim, tables.agg_ret, tables.agg_lim)
    ids = torch.from_numpy(tables.yet[:FULL_WIDTH_TRIALS]).to(dev)
    errs.hold(G, agg.aggregate_loss_gather(ids, *terms, chunk=128),
              agg.aggregate_loss_gather_plain(ids, *terms, chunk=128),
              f"full width T{FULL_WIDTH_TRIALS}")

    # gather at the shape the main path gives it: one of two tenants' chunk
    T = tables.num_trials // 2
    K, (rows, M) = tables.yet.shape[1], tables.elt_losses.shape
    ids = torch.from_numpy(tables.yet[:T]).to(dev)
    got = agg.aggregate_loss_gather(ids, *terms, chunk=128)
    t0 = time.perf_counter()
    want = agg.aggregate_loss_gather_plain(ids, *terms, chunk=128)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    errs.hold(G, got, want, f"main-path shape T{T}")
    g_ms = cuda_ms(lambda: agg.aggregate_loss_gather(ids, *terms, chunk=128),
                   5, flush)
    g_plain = cuda_ms(lambda: agg.aggregate_loss_gather_plain(
        ids, *terms, chunk=128), 1, flush)
    g_bound, g_by = bound_ms(T, K, M, rows)
    g_shape = f"T{T} K{K} M{M} rows{rows}"
    # the row pass alone, against its plain version bit for bit
    f = agg.aggregate_row_losses(elt, ret, lim)
    errs.hold_bits(R, f, agg.aggregate_row_losses_plain(elt, ret, lim),
                   f"full width rows{rows}")
    r_ms = cuda_ms(lambda: agg.aggregate_row_losses(elt, ret, lim), 10, flush)
    r_plain = cuda_ms(lambda: agg.aggregate_row_losses_plain(elt, ret, lim),
                      3, flush)
    r_bound, r_by = row_bound_ms(rows, M)
    # the yardstick: one PyTorch call computing the trial pass on the same
    # f (the aggregate terms are not in it); never called by the port
    bag = lambda: torch.nn.functional.embedding_bag(ids, f[:, None],
                                                    mode="sum")
    lib = torch.clamp(torch.clamp(bag()[:, 0] - tables.agg_ret, min=0.0),
                      max=tables.agg_lim)
    check(bool(torch.allclose(lib, got, rtol=RTOL, atol=ATOL)),
          "embedding_bag on the row losses, with the aggregate terms, "
          "disagrees with the gather kernel")
    lib_ms = cuda_ms(bag, 5, flush)
    # where the trial pass's time goes: the same call with every id the pad
    # 0 (the ids streamed, every gather one cached row) and with the ids cut
    # to the first 65,536 rows (256 KB of f, held near the SMs)
    probe = {}
    for tag, alt in (("ids all 0", torch.zeros_like(ids)),
                     ("ids in 65,536 rows", ids & 0xFFFF)):
        probe[tag] = cuda_ms(lambda: agg.aggregate_loss_gather(
            alt, *terms, chunk=128), 5, flush)
        del alt
    say("kernels", f"gather probes, same shape: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in probe.items()))
    say("kernels", f"gather {g_shape}: {g_ms:.3f} ms (row pass {r_ms:.4f} "
                   f"ms of it, plain {r_plain:.3f} ms, bound {r_bound:.4f} ms "
                   f"by {r_by}), plain {g_plain:.1f} ms (first call "
                   f"{plain_wall * 1e3:.0f} ms), bound {g_bound:.3f} ms by "
                   f"{g_by}; embedding_bag on the same f (the trial pass "
                   f"only) {lib_ms:.3f} ms; an id and a 64 B row per event "
                   f"would take {gather_traffic_ms(T, K):.3f} ms at the "
                   f"memory rate")
    del ids, got, want, f, lib

    # onehot at the sweep's largest shape and at five catalog tiles, beside
    # the gather on the same inputs
    o_rows = []
    for T, K, M, cat, chunk, rt in ONEHOT_TIMED:
        args = make_case(rng, T, K, M, cat, dev)
        want = agg.aggregate_loss_onehot_plain(*args, chunk=chunk,
                                               rows_tile=rt)
        errs.hold(O, agg.aggregate_loss_onehot(*args, chunk=chunk,
                                               rows_tile=rt),
                  want, f"T{T} K{K} M{M} cat{cat}")
        ms = cuda_ms(lambda: agg.aggregate_loss_onehot(
            *args, chunk=chunk, rows_tile=rt), 5, flush)
        plain = cuda_ms(lambda: agg.aggregate_loss_onehot_plain(
            *args, chunk=chunk, rows_tile=rt), 2, flush)
        bound, by = bound_ms(T, K, M, cat + 1)
        padded = (args[0], agg.pad_elt_columns(args[1]), *args[2:])
        gather_ms = cuda_ms(lambda: agg.aggregate_loss_gather(
            *padded, chunk=chunk), 5, flush)
        o_rows.append({"shape": f"T{T} K{K} M{M} cat{cat}", "ms": ms,
                       "plain_ms": plain,
                       "bound_ms": bound, "bound_by": by,
                       "gather_ms_same_shape": gather_ms})
        say("kernels", f"onehot {o_rows[-1]['shape']}: {ms:.4f} ms, "
                       f"plain {plain:.2f} ms, bound "
                       f"{bound:.4f} ms by {by}; the ids once per tile "
                       f"take {onehot_ids_ms(T, K, cat + 1):.4f} ms at the "
                       f"memory rate; gather kernel on the same inputs "
                       f"{gather_ms:.4f} ms")

    return {G: {"shape": g_shape, "ms": g_ms, "plain_ms": g_plain,
                "bound_ms": g_bound, "bound_by": g_by, "library_ms": lib_ms,
                "library_call": "embedding_bag(ids, f[:, None], mode='sum')"
                                " on the row losses: the trial pass only",
                "probe_ms": probe},
            R: {"shape": f"ELT ({rows}, {M}->16) f32", "ms": r_ms,
                "plain_ms": r_plain, "bound_ms": r_bound, "bound_by": r_by,
                "library_ms": None},
            O: {"sweep_largest": o_rows[0], "larger_catalog": o_rows[1]}}


# ---------------------------------------------------------------------------
def describe_run(tag: str, rep, nbytes_by_vdev) -> dict:
    """Print one run's per-tenant timeline; returns its device-side numbers."""
    copy_ms = kernel_ms = 0.0
    rates = []
    for tl in rep.timeline:
        d = tl.device_ms
        check(d is not None, f"{tag}: no CUDA-event times on the timeline")
        c = d["copy_end"] - d["copy_start"]
        k = d["compute_end"] - d["compute_start"]
        rate = nbytes_by_vdev[tl.vdev] / (c * 1e-3) / 1e9
        rates.append(rate)
        copy_ms, kernel_ms = copy_ms + c, kernel_ms + k
        say("main", f"  {tag} vdev{tl.vdev}: host transfer "
                    f"[{tl.transfer_start * 1e3:.2f}, {tl.transfer_end * 1e3:.2f}] "
                    f"compute [{tl.compute_start * 1e3:.2f}, "
                    f"{tl.compute_end * 1e3:.2f}] ms | device copy "
                    f"[{d['copy_start']:.2f}, {d['copy_end']:.2f}] kernel "
                    f"[{d['compute_start']:.2f}, {d['compute_end']:.2f}] ms | "
                    f"H2D {rate:.1f} GB/s, kernel {k:.3f} ms")
    span = max(tl.device_ms["compute_end"] for tl in rep.timeline) - \
        min(tl.device_ms["copy_start"] for tl in rep.timeline)
    out = {"wall_ms": rep.wall_s * 1e3, "device_span_ms": span,
           "copy_ms": copy_ms, "kernel_ms": kernel_ms,
           "h2d_gbps": statistics.mean(rates),
           "overlaps": timeline_overlaps(rep.timeline)}
    say("main", f"{tag}: wall {out['wall_ms']:.1f} ms, device span "
                f"{span:.1f} ms, copies {copy_ms:.1f} ms, kernels "
                f"{kernel_ms:.2f} ms, H2D {out['h2d_gbps']:.1f} GB/s, "
                f"overlap predicate {out['overlaps']}")
    return out


def phase_main_gather(cfg: RiskAppConfig, tables: RiskTables, dev) -> dict:
    """The full-width main path, gather variant: 1x1, 1x2 sequential
    (overlapped and blocking) and 1x2 concurrent, each engine run twice."""
    check(kops.aggregate_variant() == "gather", "default variant is not gather")
    runs = {}
    ylts = {}
    expected = 0
    agg.reset_counts()                     # just before the main path
    for tag, tenants, mode, overlapped in (
            ("1x1", 1, "sequential", True),
            ("1x2 sequential", 2, "sequential", True),
            ("1x2 sequential blocking", 2, "sequential", False),
            ("1x2 concurrent", 2, "concurrent", True)):
        ara = AggregateRiskAnalysis(cfg, TenancyConfig(1, tenants, mode))
        nbytes = {t.vdev: (t.padded_size or t.size) * tables.yet.shape[1] * 4
                  for t in ara.pool.plan(tables.num_trials, uniform=True)}
        for attempt in ("first", "second"):
            before = agg.launch_counts[G]
            rep = ara.run_tenant_chunked(tables, overlapped=overlapped)
            expected += tenants
            check(agg.launch_counts[G] - before == tenants,
                  f"{tag}: {agg.launch_counts[G] - before} gather launches "
                  f"for {tenants} tenants")
            check(all(e["pinned"] for e in rep.staging_log),
                  f"{tag}: a chunk was staged from pageable memory")
        check(ara.table_uploads == 1, f"{tag}: {ara.table_uploads} table uploads")
        check(ara.launch_shape_count == 1,
              f"{tag}: {ara.launch_shape_count} launch shapes")
        runs[tag] = describe_run(tag, rep, nbytes)     # the second run
        ylts[tag] = rep.ylt
        ara.clear_table_cache()
        del ara, rep
        torch.cuda.empty_cache()           # the next engine has its own streams
    launches = agg.launch_counts[G]        # just after the main path
    row_launches = agg.launch_counts[R]
    check(launches == expected and launches > 0,
          f"gather launches {launches}, expected {expected}")
    check(row_launches == launches,
          f"row-pass launches {row_launches} for {launches} gather calls")
    check(not any(agg.plain_counts.values()),
          f"the main path called a plain version: {agg.plain_counts}")
    check(agg.launch_counts["aggregate_loss_onehot"] == 0,
          "the gather main path launched the onehot kernel")

    base = ylts["1x1"]
    check(base.shape == (tables.num_trials,) and base.dtype == np.float32
          and bool(np.isfinite(base).all()), "YLT shape/dtype/finite")
    for tag, y in ylts.items():
        check(np.allclose(y, base, rtol=YLT_RTOL, atol=0.0),
              f"YLT of {tag} differs from 1x1 beyond rtol={YLT_RTOL}")
    check(runs["1x2 sequential"]["overlaps"] == [True],
          "sequential overlapped run: transfer(1) did not start inside "
          "compute(0)")
    check(runs["1x2 sequential blocking"]["overlaps"] == [False],
          "blocking run scored an overlap")

    # strided blocks of trials against the plain version, on the card
    T = tables.num_trials
    elt = torch.from_numpy(tables.elt_losses).to(dev)
    ret = torch.from_numpy(tables.occ_ret).to(dev)
    lim = torch.from_numpy(tables.occ_lim).to(dev)
    worst = 0.0
    starts = sorted({0, max(0, T // 2 - TRIAL_GRAIN // 2),
                     max(0, T - TRIAL_GRAIN)})
    for start in starts:
        ids = torch.from_numpy(tables.yet[start:start + TRIAL_GRAIN]).to(dev)
        want = agg.aggregate_loss_gather_plain(
            ids, elt, ret, lim, tables.agg_ret, tables.agg_lim, chunk=128)
        got = torch.from_numpy(base[start:start + TRIAL_GRAIN]).to(dev)
        check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
              f"YLT block at {start} disagrees with the plain version")
        worst = max(worst, float(((got - want).abs()
                                  / want.abs().clamp_min(1.0)).max()))
    agg.reset_counts()
    say("main", f"four YLTs agree (rtol={YLT_RTOL}); {len(starts)} blocks of {TRIAL_GRAIN} "
                f"trials match the plain version (max rel err {worst:.3g}); "
                f"gather launches {launches}, plain calls 0")
    summ = {k: float(v) for k, v in
            metrics.summary(torch.from_numpy(base)).items()}
    check(all(np.isfinite(v) for v in summ.values()), "summary not finite")
    check(0.0 < summ["mean"] <= summ["var99"] <= summ["tvar99"]
          and summ["pml10"] <= summ["pml100"] <= summ["pml1000"]
          <= tables.agg_lim * (1 + 1e-6), f"summary out of order: {summ}")
    say("main", "summary " + ", ".join(f"{k}={v:,.0f}" for k, v in summ.items()))
    return {"launches": launches, "row_launches": row_launches,
            "runs": runs}


def phase_main_onehot(errs: Errors, cfg: RiskAppConfig, dev) -> dict:
    """The same entry points with the onehot variant at the paper's
    1,000,000 trials, the catalog cut to 4,096 events (one tile of the
    kernel; the ids are read once per tile); K and M stay.  Then the kernel
    at the chunk this run gave it, held against its plain version on blocks
    of trials and timed beside the gather and ``embedding_bag`` on the same
    inputs, and at the chunk's first 2,048 trials, a small call.  The plain
    version is timed on one held block, not on the whole chunk."""
    small = dataclasses.replace(cfg, num_trials=ONEHOT_MAIN_TRIALS,
                                event_catalog=ONEHOT_MAIN_CATALOG)
    t0 = time.perf_counter()
    tables = generate(small, seed=1)
    t1 = time.perf_counter()
    tables = tables.pinned()
    t2 = time.perf_counter()
    say("tables", f"onehot path: T={small.num_trials} catalog="
                  f"{small.event_catalog}: YET "
                  f"{tables.nbytes()['yet'] / 1e9:.2f} GB; generate "
                  f"{t1 - t0:.1f} s, pin {t2 - t1:.1f} s")
    ara = AggregateRiskAnalysis(small, TenancyConfig(1, 2, "sequential"))
    want = ara.run_tenant_chunked(tables).ylt          # gather variant
    prev = kops.aggregate_variant()
    kops.use_aggregate_variant("onehot")
    try:
        agg.reset_counts()                 # just before the main path
        rep = ara.run_tenant_chunked(tables)
        launches = agg.launch_counts[O]    # just after
        row_launches = agg.launch_counts[R]
    finally:
        kops.use_aggregate_variant(prev)
    check(launches == 2 and row_launches == 2,
          f"onehot launches {launches}, row passes {row_launches} for 2 "
          f"tenants")
    check(agg.launch_counts[G] == 0 and not any(agg.plain_counts.values()),
          "the onehot main path took another route")
    check(rep.ylt.shape == (small.num_trials,)
          and bool(np.isfinite(rep.ylt).all())
          and np.allclose(rep.ylt, want, rtol=RTOL, atol=ATOL),
          "onehot YLT disagrees with the gather YLT")
    k = sum(tl.device_ms["compute_end"] - tl.device_ms["compute_start"]
            for tl in rep.timeline)
    say("main", f"onehot variant, T={small.num_trials} K={small.events_per_trial}"
                f" M={small.num_elts} catalog={small.event_catalog} (cut), 1x2 "
                f"sequential: {launches} launches, kernels "
                f"{k:.3f} ms, wall {rep.wall_s * 1e3:.1f} ms, YLT agrees "
                f"with the gather variant")
    ara.clear_table_cache()
    del ara, rep, want

    T, K = small.num_trials // 2, small.events_per_trial
    rows, M = tables.elt_losses.shape
    terms = (agg.pad_elt_columns(torch.from_numpy(tables.elt_losses).to(dev)),
             torch.from_numpy(tables.occ_ret).to(dev),
             torch.from_numpy(tables.occ_lim).to(dev),
             tables.agg_ret, tables.agg_lim)
    chunk = small.chunk_events
    ids = torch.from_numpy(tables.yet[:T]).to(dev)
    del tables                            # 4 GB of pinned host memory
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    f = agg.aggregate_row_losses(*terms[:3])
    out = {"launches": launches, "row_launches": row_launches,
           "generate_s": t1 - t0,
           "main_kernels_ms": k}
    for tag, n in (("chunk", T), ("cut", ONEHOT_CUT_TRIALS)):
        part = ids[:n]
        shape = f"T{n} K{K} M{M} rows{rows}"
        got = agg.aggregate_loss_onehot(part, *terms, chunk=chunk)
        # blocks of trials against the plain version (the whole cut)
        block = min(n, ONEHOT_BLOCK)
        for start in sorted({0, max(0, n // 2 - block // 2), n - block}):
            want = agg.aggregate_loss_onehot_plain(
                part[start:start + block], *terms, chunk=chunk)
            errs.hold(O, got[start:start + block], want,
                      f"main-path {tag} {shape}, trials {start}..")
        ms = cuda_ms(lambda: agg.aggregate_loss_onehot(
            part, *terms, chunk=chunk), 5, flush)
        gather_ms = cuda_ms(lambda: agg.aggregate_loss_gather(
            part, *terms, chunk=chunk), 5, flush)
        # the yardstick, as for the gather: one PyTorch call on the same f
        bag = lambda: torch.nn.functional.embedding_bag(part, f[:, None],
                                                        mode="sum")
        lib = torch.clamp(torch.clamp(bag()[:, 0] - terms[3], min=0.0),
                          max=terms[4])
        check(bool(torch.allclose(lib, got, rtol=RTOL, atol=ATOL)),
              f"embedding_bag on the row losses disagrees with the onehot "
              f"kernel at {shape}")
        lib_ms = cuda_ms(bag, 5, flush)
        bound, by = bound_ms(n, K, M, rows)
        # the plain version on the first held block, beside that block's
        # shape (on the whole chunk it would be a call of seconds)
        first = part[:block]
        plain_ms = cuda_ms(lambda: agg.aggregate_loss_onehot_plain(
            first, *terms, chunk=chunk), 1, flush)
        out[tag] = {"shape": shape, "ms": ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": lib_ms,
                    "gather_ms_same_inputs": gather_ms, "plain_ms": plain_ms,
                    "plain_shape": f"T{block} K{K} M{M} rows{rows}"}
        say("kernels", f"onehot {shape}: {ms:.4f} ms, plain "
                       f"{plain_ms:.1f} ms at T{block}, bound {bound:.4f} ms "
                       f"by {by}; the ids once per tile take "
                       f"{onehot_ids_ms(n, K, rows):.4f} ms at the memory "
                       f"rate; gather on the same inputs {gather_ms:.4f} ms; "
                       f"embedding_bag on the same f {lib_ms:.4f} ms")
        del got, part
    del ids, f
    agg.reset_counts()
    return out


def phase_cli() -> None:
    rc = risk_cli.main(["--reduced", "--tenants", "2", "--mode", "sequential"])
    check(rc == 0, f"cli returned {rc}")
    check(agg.launch_counts["aggregate_loss_gather"] == 2
          and not any(agg.plain_counts.values()),
          "the cli did not go through the gather kernel")


# ---------------------------------------------------------------------------
# the paper's loop on the card: measure, fit, plan, and the key result --
# sequential against concurrent staging in repeated pairs, time and energy
# ---------------------------------------------------------------------------
FIT_TENANTS = (1, 2, 4, 8)   # sequential sweep the perf model is fitted on
FIT_RUNS = 2                 # recorded runs a deployment, after one warm run
PLAN_RUNS = 3                # runs of the deployment the plan chose
PAIR_TENANTS = (2, 4)        # deployments of the pairs, 1 x tenants
SMOKE_PAIRS = 8              # pairs a deployment here (diagnostics: more)
WINDOW_RUNS = 8              # back-to-back runs a member of a pair: ~0.65 s,
                             # 5+ ticks of the energy counter (~100 ms each)
WINDOW_MIN_TICKS = 3         # a pair's window runs on until it holds these
WINDOW_MAX_RUNS = 8 * WINDOW_RUNS   # ... and fails past this many runs
POWER_IDLE_TICKS = 8         # counter ticks the idle window waits for
POWER_LOOP_S = 1.0           # least length of the risk and the K1 windows
POWER_MIN_TICKS = 5          # ... which also run on until they hold these
POWER_MAX_S = 20.0           # ... and fail past this length
TICK_WITHIN_S = 0.010        # a tick seen later than this after the read
                             # before it is left out (its time is unsure)
T4GB_AGREE = 0.10            # fitted YET time against the 1x1 copy window


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit_w(card: str) -> float:
    """The limit from the ``name, power.limit`` line of ``nvidia-smi``."""
    return float(card.rsplit(",", 1)[1].strip().split()[0])


class RiskEngines:
    """One warm engine per (tenants, mode) on one card, for the loop's
    phases: each is built, given its resident tables and run once before
    any of its runs is recorded."""

    def __init__(self, cfg: RiskAppConfig, tables: RiskTables, dev):
        self.cfg, self.tables, self.dev = cfg, tables, dev
        self.by_key = {}

    def __call__(self, tenants: int, mode: str) -> AggregateRiskAnalysis:
        key = (tenants, mode)
        if key not in self.by_key:
            ara = AggregateRiskAnalysis(
                self.cfg, TenancyConfig(1, tenants, mode), device=self.dev)
            ara.run_tenant_chunked(self.tables)          # warm
            self.by_key[key] = ara
        return self.by_key[key]

    def warm_launches(self, tenants: int, mode: str) -> int:
        """The gather launches that asking for this engine will make: its
        warm run's, if it is not built yet."""
        return 0 if (tenants, mode) in self.by_key else tenants

    def close(self) -> None:
        for ara in self.by_key.values():
            ara.clear_table_cache()
        self.by_key.clear()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def device_span_ms(rep) -> float:
    d = [obs_fit.entry_windows_ms(tl) for tl in rep.timeline]
    return (max(x["compute_end"] for x in d)
            - min(x["copy_start"] for x in d))


def copy_overlap_ms(rep) -> float:
    """Copy time during which another of the run's copies also ran: 0 when
    the card runs the copies one after the other, (n-1)/n of it when n
    copies share the link evenly (the paper's BW/n)."""
    w = sorted((d["copy_start"], d["copy_end"])
               for d in map(obs_fit.entry_windows_ms, rep.timeline))
    union, (lo, hi) = 0.0, w[0]
    for a, b in w[1:]:
        if a > hi:
            union, lo, hi = union + hi - lo, a, b
        else:
            hi = max(hi, b)
    return sum(b - a for a, b in w) - (union + hi - lo)


def first_kernel_ms(rep) -> float:
    """From the run's first copy to its first kernel: when tenant 0's
    compute could begin."""
    d = [obs_fit.entry_windows_ms(tl) for tl in rep.timeline]
    return (min(x["compute_start"] for x in d)
            - min(x["copy_start"] for x in d))


def smi_power_fields() -> dict:
    """What ``nvidia-smi`` says of its power fields: whether ``power.draw``
    is an average (its help text), and whether ``power.draw.instant``
    exists."""
    text = subprocess.run(["nvidia-smi", "--help-query-gpu"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout
    lines = text.splitlines()
    draw = next((lines[i + 1].strip() for i, l in enumerate(lines[:-1])
                 if l.strip().startswith('"power.draw"')), "")
    return {"power.draw": draw,
            "power.draw.instant": '"power.draw.instant"' in text}


def window_done(gauge, t_a: float, name: str) -> bool:
    """Whether a power window begun at ``t_a`` may close: ``POWER_LOOP_S``
    long and holding ``POWER_MIN_TICKS`` counter ticks seen within
    ``TICK_WITHIN_S``.  A counter that steps more slowly, or a gauge thread
    held back while the host was busy, lengthens the window instead of
    leaving it with too few samples; past ``POWER_MAX_S`` it fails."""
    s = time.perf_counter() - t_a
    n = len(gauge.ticks(t_a, within=TICK_WITHIN_S))
    check(s < POWER_MAX_S or n >= POWER_MIN_TICKS,
          f"power: {n} counter ticks in the {name} window after {s:.1f} s")
    return s >= POWER_LOOP_S and n >= POWER_MIN_TICKS


def phase_power(engines: RiskEngines, gauge, tel, card: str) -> dict:
    """The card's ``PowerParams`` from its own energy counter: windows of
    different busy share (idle; back-to-back 1x2 risk runs, mostly copies;
    back-to-back K1 calls on resident data), one ``power.sample`` per
    interval between counter ticks, busy share from CUDA-event windows."""
    dev, tables = engines.dev, engines.tables
    ara = engines(2, "sequential")
    elt, ret, lim = ara._resident_tables(tables)[0]
    ids = torch.from_numpy(tables.yet[:tables.num_trials // 2]).to(dev)
    chunk = min(engines.cfg.chunk_events, tables.yet.shape[1])
    windows = {}
    agg.reset_counts()                   # just before the path

    sync(dev)
    t_a = time.perf_counter()
    gauge.wait_ticks(POWER_IDLE_TICKS)
    windows["idle"] = (t_a, time.perf_counter(), [])

    busy, risk_runs = [], 0
    t_a = time.perf_counter()
    while not window_done(gauge, t_a, "risk 1x2"):
        busy += obs_fit.busy_windows(ara.run_tenant_chunked(tables))
        risk_runs += 1
    windows["risk 1x2"] = (t_a, time.perf_counter(), busy)

    k1 = lambda: agg.aggregate_loss_gather(ids, elt, ret, lim, tables.agg_ret,
                                           tables.agg_lim, chunk=chunk)
    k1()
    sync(dev)
    t0 = time.perf_counter()
    k1()
    sync(dev)
    # batches of a quarter of POWER_LOOP_S, each timed by its own events
    batch = max(1, int(POWER_LOOP_S / 4 / max(time.perf_counter() - t0,
                                              1e-4)))
    busy, calls = [], 0
    t_a = time.perf_counter()
    while not window_done(gauge, t_a, "K1 loop"):
        t_b = time.perf_counter()
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                k1()
            b.record()
            b.synchronize()
            busy.append((t_b, t_b + a.elapsed_time(b) * 1e-3))
        else:
            for _ in range(batch):
                k1()
            busy.append((t_b, time.perf_counter()))
        calls += batch
    windows["K1 loop"] = (t_a, time.perf_counter(), busy)
    launches = agg.launch_counts[G]      # just after
    rows = agg.launch_counts[R]
    check(rows == launches, f"{rows} row passes for {launches} gathers")
    expected = 2 * risk_runs + calls + 2  # two tenants a run; K1 warm, probe
    check(launches == expected and not any(agg.plain_counts.values()),
          f"power path: {launches} gather launches, expected {expected}; "
          f"plain calls {agg.plain_counts}")
    del ids

    ticks = gauge.ticks()
    gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(ticks, ticks[1:])]
    out = {"source": gauge.source, "tick_ms_median": statistics.median(gaps),
           "tick_ms_max": max(gaps), "late_ticks": gauge.late(TICK_WITHIN_S),
           "smi": smi_power_fields(), "windows": {}}
    say("power", f"gauge: {gauge.source}, a tick every "
                 f"{out['tick_ms_median']:.1f} ms (median of {len(gaps)}, "
                 f"longest {out['tick_ms_max']:.1f} ms; {out['late_ticks']} "
                 f"seen more than {TICK_WITHIN_S * 1e3:.0f} ms after the "
                 f"read before, left out); nvidia-smi: {out['smi']}")
    for name, (lo, hi, busy) in windows.items():
        samples = obs_fit.record_power_samples(
            tel, gauge.ticks(lo, hi, within=TICK_WITHIN_S), busy, window=name)
        check(len(samples) >= 2, f"power: {len(samples)} samples in the "
                                 f"{name} window")
        w = gauge.mean_watts(lo, hi, within=TICK_WITHIN_S)
        frac = obs_fit.busy_seconds(busy, lo, hi) / (hi - lo)
        out["windows"][name] = {"seconds": hi - lo, "busy_frac": frac,
                                "watts": w, "samples": len(samples)}
        say("power", f"{name}: {hi - lo:.2f} s, busy {frac * 100:.1f} %, "
                     f"{w:.1f} W over {len(samples)} counter intervals")
    samples = obs_fit.power_samples_from_telemetry(tel)
    pw = obs_fit.fit_power_params(samples, name="card")
    resid = float(np.sqrt(np.mean(
        [(f * pw.p_busy + (1 - f) * pw.p_idle_assigned - w) ** 2
         for f, w in samples])))
    limit = power_limit_w(card)
    say("power", f"fitted PowerParams over {len(samples)} samples "
                 f"({gauge.source}): p_busy {pw.p_busy:.1f} W, "
                 f"p_idle_assigned {pw.p_idle_assigned:.1f} W, residual "
                 f"{resid:.2f} W rms | {card}")
    check(np.isfinite(resid) and
          pw.p_idle_assigned < pw.p_busy <= limit,
          f"power: p_idle_assigned {pw.p_idle_assigned:.1f} W, p_busy "
          f"{pw.p_busy:.1f} W against a limit of {limit} W")
    out.update(launches=launches, row_launches=rows, k1_calls=calls, p_busy_w=pw.p_busy,
               p_idle_assigned_w=pw.p_idle_assigned, residual_w=resid,
               samples=len(samples))
    return out, pw


def phase_fit(engines: RiskEngines, tel, dev) -> dict:
    """The perf model fitted from the card's own sequential sweep (1x1,
    1x2, 1x4, 1x8), recorded as device windows with ``nv``; then
    ``plan_from_telemetry`` for one card of this card's memory (the power
    samples on the plane give its power), and the deployment it chose,
    run and timed beside the model's time."""
    tables = engines.tables
    nb = tables.nbytes()
    yet_mb, elt_mb = nb["yet"] / 1e6, nb["elt"] / 1e6
    agg.reset_counts()                   # just before the path
    expected = 0
    sweep = {}
    for nv in FIT_TENANTS:
        expected += engines.warm_launches(nv, "sequential") + FIT_RUNS * nv
        sweep[nv] = engines(nv, "sequential")
    runs = obs_fit.record_sweep(tel, sweep, tables, FIT_RUNS)
    copy_1x1 = [w["copy_end"] - w["copy_start"]
                for w in (obs_fit.entry_windows_ms(rep.timeline[0])
                          for nv, rep in runs if nv == 1)]
    last = dict(runs)                    # each nv's last run
    ylt_1x1 = last[1].ylt
    per_nv = {}
    for nv, rep in last.items():
        d = [obs_fit.entry_windows_ms(tl) for tl in rep.timeline]
        per_nv[nv] = {
            "copy_ms": statistics.median(x["copy_end"] - x["copy_start"]
                                         for x in d),
            "kernel_ms": statistics.median(
                x["compute_end"] - x["compute_start"] for x in d),
            "wall_ms": rep.wall_s * 1e3}
    mem_mb = torch.cuda.get_device_properties(dev).total_memory / 2**20 \
        if dev.type == "cuda" else 80 * 1024.0
    fit_kw = dict(yet_mb=yet_mb, elt_mb=elt_mb, device_memory_mb=mem_mb)
    n_samples = len(obs_fit.samples_from_telemetry(tel))
    tp = planner.plan_from_telemetry(tel, objective="time", budget_pdev=1,
                                     **fit_kw)
    d = tp.deployment
    t4 = tp.m.net.t_4gb
    check(np.isfinite(tp.transfer_rms_s) and np.isfinite(tp.compute_rms_s),
          "fit: residuals not finite")
    yet_s = t4 * yet_mb / pm.YET_MB      # the fitted time of this YET
    c11 = statistics.median(copy_1x1) * 1e-3
    check(abs(yet_s - c11) <= T4GB_AGREE * c11,
          f"fit: the fitted YET time {yet_s * 1e3:.2f} ms and the 1x1 "
          f"copy window {c11 * 1e3:.2f} ms differ by more than "
          f"{T4GB_AGREE * 100:.0f} %")
    for nv, r in per_nv.items():
        say("fit", f"1x{nv} sequential: copy {r['copy_ms']:.2f} ms, kernel "
                   f"{r['kernel_ms']:.3f} ms a tenant, wall "
                   f"{r['wall_ms']:.1f} ms")
    say("fit", f"{n_samples} samples: t_4gb {t4 * 1e3:.3f} ms "
               f"({pm.YET_MB / 1e3 / t4:.1f} GB/s), per-vdev overhead "
               f"{tp.m.net.per_vdev_overhead * 1e3:.4f} ms, "
               f"compute_time_1pdev {tp.m.compute_time_1pdev * 1e3:.3f} ms; "
               f"residuals transfer {tp.transfer_rms_s * 1e3:.4f} ms, "
               f"compute {tp.compute_rms_s * 1e3:.4f} ms; 1x1 copy window "
               f"{c11 * 1e3:.2f} ms")

    expected += engines.warm_launches(d.tenants_per_pdev, tp.transfer_mode)
    ara = engines(d.tenants_per_pdev, tp.transfer_mode)
    walls = []
    for _ in range(PLAN_RUNS):
        rep = ara.run_tenant_chunked(tables)
        walls.append(rep.wall_s * 1e3)
    expected += d.tenants_per_pdev * PLAN_RUNS
    check(np.allclose(rep.ylt, ylt_1x1, rtol=YLT_RTOL, atol=0.0),
          "fit: the chosen deployment's YLT differs from 1x1")
    launches = agg.launch_counts[G]      # just after
    rows = agg.launch_counts[R]
    check(rows == launches, f"{rows} row passes for {launches} gathers")
    check(launches == expected and not any(agg.plain_counts.values()),
          f"fit path: {launches} gather launches, expected {expected}; "
          f"plain calls {agg.plain_counts}")
    wall = statistics.median(walls)
    say("fit", f"plan_from_telemetry (objective time, 1 card of "
               f"{mem_mb:.0f} MiB, power {tp.pw.name}): "
               f"{d.n_pdev}x{d.tenants_per_pdev} {tp.transfer_mode}; model "
               f"exec_time_s {d.exec_time_s * 1e3:.2f} ms (a prediction), "
               f"energy {d.energy_ws:.2f} J (a prediction); measured wall "
               f"{wall:.2f} ms (median of {PLAN_RUNS})")
    return {"launches": launches, "row_launches": rows, "per_nv": per_nv,
            "fitted": {"t_4gb_ms": t4 * 1e3,
                       "per_vdev_overhead_ms":
                           tp.m.net.per_vdev_overhead * 1e3,
                       "compute_time_1pdev_ms":
                           tp.m.compute_time_1pdev * 1e3,
                       "transfer_rms_ms": tp.transfer_rms_s * 1e3,
                       "compute_rms_ms": tp.compute_rms_s * 1e3,
                       "samples": n_samples},
            "copy_1x1_ms": c11 * 1e3,
            "chosen": {"tenants_per_pdev": d.tenants_per_pdev,
                       "transfer_mode": tp.transfer_mode,
                       "wall_ms": walls},
            "plan": tp, "ylt_1x1": ylt_1x1}


def risk_window(ara: AggregateRiskAnalysis, tables: RiskTables, gauge,
                runs: int, dev) -> dict:
    """One member of a pair: ``runs`` back-to-back runs; per run the host
    wall and the CUDA-event device span, for the window its energy from
    the card's counter (mean watts over the ticks inside it times its
    length).  The window runs on past ``runs`` until it holds
    ``WINDOW_MIN_TICKS`` counter ticks, as the power phase's do."""
    sync(dev)
    t_a = time.perf_counter()
    reps = [ara.run_tenant_chunked(tables) for _ in range(runs)]
    ticks = lambda: len(gauge.ticks(t_a, within=TICK_WITHIN_S))
    while ticks() < WINDOW_MIN_TICKS:
        check(len(reps) < WINDOW_MAX_RUNS,
              f"pairs: {ticks()} counter ticks in a window of {len(reps)} "
              f"runs")
        reps.append(ara.run_tenant_chunked(tables))
    t_b = time.perf_counter()
    w = gauge.mean_watts(t_a, t_b, within=TICK_WITHIN_S)
    return {"runs": len(reps), "wall_ms": [r.wall_s * 1e3 for r in reps],
            "span_ms": [device_span_ms(r) for r in reps],
            "copy_overlap_ms": [copy_overlap_ms(r) for r in reps],
            "first_kernel_ms": [first_kernel_ms(r) for r in reps],
            "seconds": t_b - t_a, "watts": w, "joules": w * (t_b - t_a),
            "ylt": reps[-1].ylt}


def predicted_gap(tenants: int, tp, pw) -> tuple:
    """The simulator's (sequential - concurrent) makespan in ms and energy
    in J for 1 x ``tenants``, under the fitted inputs: a prediction."""
    res = {}
    for mode in ("sequential", "concurrent"):
        si = SimInputs(TenancyConfig(1, tenants, mode), net=tp.m.net,
                       compute_time_1pdev=tp.m.compute_time_1pdev,
                       yet_mb=tp.m.yet_mb, elt_mb=tp.m.elt_mb,
                       pf_mb=tp.m.pf_mb, power=pw)
        res[mode] = simulate(si)
    return ((res["sequential"].makespan - res["concurrent"].makespan) * 1e3,
            res["sequential"].energy_ws - res["concurrent"].energy_ws)


def phase_pairs(engines: RiskEngines, gauge, fitted: dict, pw,
                n_pairs: int = SMOKE_PAIRS) -> dict:
    """The paper's key result on this card: 1x2 and 1x4, sequential
    against concurrent staging, in repeated pairs in ABBA order on warm
    engines.  A pair's difference is sequential minus concurrent: of the
    median run wall, of the median device span, and of the energy a run
    (its window's joules over its runs).  No gate on the sign: the result
    is a number."""
    tables, dev = engines.tables, engines.dev
    out = {}
    agg.reset_counts()                   # just before the path
    expected = 0
    for tenants in PAIR_TENANTS:
        for mode in ("sequential", "concurrent"):
            expected += engines.warm_launches(tenants, mode)
            engines(tenants, mode)
        pairs = []
        for i in range(n_pairs):
            order = (("sequential", "concurrent") if i % 2 == 0
                     else ("concurrent", "sequential"))
            pair = {m: risk_window(engines(tenants, m), tables, gauge,
                                   WINDOW_RUNS, dev) for m in order}
            for m, w in pair.items():
                expected += w["runs"] * tenants
                check(np.allclose(w.pop("ylt"), fitted["ylt_1x1"],
                                  rtol=YLT_RTOL, atol=0.0),
                      f"pairs 1x{tenants} {m}: YLT differs from 1x1")
            pairs.append(pair)
        s, c = ([p[m] for p in pairs] for m in ("sequential", "concurrent"))
        d_ms = [statistics.median(a["wall_ms"]) - statistics.median(b["wall_ms"])
                for a, b in zip(s, c)]
        d_span = [statistics.median(a["span_ms"])
                  - statistics.median(b["span_ms"]) for a, b in zip(s, c)]
        d_j = [a["joules"] / a["runs"] - b["joules"] / b["runs"]
               for a, b in zip(s, c)]
        pred_ms, pred_j = predicted_gap(tenants, fitted["plan"], pw)
        tag = f"1x{tenants}"
        row = {"pairs": n_pairs, "runs_per_window": WINDOW_RUNS,
               "longer_windows": sum(w["runs"] > WINDOW_RUNS for w in s + c),
               "delta_wall_ms": d_ms, "delta_span_ms": d_span,
               "delta_j_per_run": d_j,
               "median_delta_wall_ms": statistics.median(d_ms),
               "median_delta_span_ms": statistics.median(d_span),
               "median_delta_j_per_run": statistics.median(d_j),
               "sequential_wins_time": sum(x < 0 for x in d_ms),
               "sequential_wins_energy": sum(x < 0 for x in d_j),
               "median_wall_ms": {
                   m: statistics.median(x for w in ws for x in w["wall_ms"])
                   for m, ws in (("sequential", s), ("concurrent", c))},
               **{f"median_{k}": {
                   m: statistics.median(x for w in ws for x in w[k])
                   for m, ws in (("sequential", s), ("concurrent", c))}
                  for k in ("copy_overlap_ms", "first_kernel_ms")},
               "median_watts": {
                   m: statistics.median(w["watts"] for w in ws)
                   for m, ws in (("sequential", s), ("concurrent", c))}}
        out[tag] = row
        say("pairs", f"{tag}, {n_pairs} pairs (ABBA) of {WINDOW_RUNS} runs "
                     f"a window ({row['longer_windows']} run on for counter "
                     f"ticks): sequential - concurrent wall median "
                     f"{row['median_delta_wall_ms']:+.3f} ms (min "
                     f"{min(d_ms):+.3f}, max {max(d_ms):+.3f}), device span "
                     f"median {row['median_delta_span_ms']:+.3f} ms, energy "
                     f"median {row['median_delta_j_per_run']:+.3f} J a run "
                     f"(min {min(d_j):+.3f}, max {max(d_j):+.3f}); "
                     f"sequential wins {row['sequential_wins_time']}/"
                     f"{n_pairs} in time, {row['sequential_wins_energy']}/"
                     f"{n_pairs} in energy; walls "
                     f"{row['median_wall_ms']['sequential']:.2f} / "
                     f"{row['median_wall_ms']['concurrent']:.2f} ms, "
                     f"{row['median_watts']['sequential']:.1f} / "
                     f"{row['median_watts']['concurrent']:.1f} W; copies "
                     f"overlapping "
                     f"{row['median_copy_overlap_ms']['sequential']:.2f} / "
                     f"{row['median_copy_overlap_ms']['concurrent']:.2f} ms, "
                     f"first kernel at "
                     f"{row['median_first_kernel_ms']['sequential']:.2f} / "
                     f"{row['median_first_kernel_ms']['concurrent']:.2f} ms "
                     f"| "
                     f"simulator from the fitted inputs (a prediction): "
                     f"{pred_ms:+.3f} ms, {pred_j:+.3f} J")
    launches = agg.launch_counts[G]      # just after
    rows = agg.launch_counts[R]
    check(rows == launches, f"{rows} row passes for {launches} gathers")
    check(launches == expected and not any(agg.plain_counts.values()),
          f"pairs path: {launches} gather launches, expected {expected}; "
          f"plain calls {agg.plain_counts}")
    out["launches"], out["row_launches"] = launches, rows
    return out


def risk_loop(cfg: RiskAppConfig, tables: RiskTables, dev, card: str,
              n_pairs: int = SMOKE_PAIRS) -> dict:
    """Phases power, fit and pairs on one set of warm engines and one
    running gauge."""
    engines = RiskEngines(cfg, tables, dev)
    tel = Telemetry(enabled=True)
    try:
        with PowerGauge() as gauge:
            power, pw = phase_power(engines, gauge, tel, card)
            fitted = phase_fit(engines, tel, dev)
            pairs = phase_pairs(engines, gauge, fitted, pw, n_pairs)
    finally:
        engines.close()
    fitted.pop("plan")
    fitted.pop("ylt_1x1")
    return {"power": power, "fit": fitted, "pairs": pairs}


# ---------------------------------------------------------------------------
# paged attention: the serving path's kernels
# ---------------------------------------------------------------------------
PEAK_BF16_FLOPS = 989e12      # the decode's products are of bf16 inputs

# (P, NB, H, Hkv, window): tests/test_paged_attention.py:91-96
PAGED_CASES = [(4, 3, 4, 2, None),   # GQA 2:1, ragged rings
               (8, 2, 2, 2, None),   # MHA
               (4, 2, 4, 1, None),   # MQA
               (4, 4, 4, 2, 6)]      # sliding window inside the ring
# (P, NB, H, Hkv, D, window): full-width head geometry, head sizes that
# leave lanes idle (24, 80) and the largest the kernel takes
PAGED_WIDE = [(16, 5, 16, 8, 128, None), (4, 3, 32, 8, 80, 6),
              (4, 3, 4, 2, 24, None), (8, 2, 64, 2, 256, None)]
# (S, NP, P, Hkv, D, pages): the reference's scatter case and two more
SCATTER_CASES = [(2, 9, 4, 2, 8, [4, 2, 7]), (3, 10, 4, 1, 24, [2, 9]),
                 (2, 12, 8, 2, 16, [3, 5, 6, 11])]

# the serving main path: launch.serve at the published width of internlm2
SERVE_ARGV = ["--arch", "internlm2-1.8b", "--no-reduced", "--mode",
              "continuous", "--no-swap", "--tenants", "3", "--requests", "12",
              "--prompt-len", "128", "--new-tokens", "32", "--capacity", "8",
              "--page-size", "16", "--inner-steps", "4"]
SHARED_PREFIXES = (0, 64)
FULL_C, FULL_H, FULL_HKV, FULL_D, FULL_P, FULL_S = 8, 16, 8, 128, 16, 24


def rand_paged_state(rng, *, C, NB, P, H, Hkv, D, dev,
                     q_dtype=torch.float32, full=False, n_extra_pages=3):
    """A mid-decode paged state as tests/test_paged_attention.py builds it:
    per-row rings of ragged length (all NB blocks with ``full``) over
    distinct physical pages, SENTINEL-padded tables, the dense ring's
    positions in the position pool (rings may have wrapped), and
    unreferenced pages of noise.  Returns the decode kernel's arguments."""
    NP_ = PagedKVCache.RESERVED + C * NB + n_extra_pages
    k_pool = rng.standard_normal((NP_, P, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((NP_, P, Hkv, D)).astype(np.float32)
    pos_pool = np.full((NP_, P), POS_SENTINEL, np.int32)
    table = np.full((C, NB), PagedKVCache.SENTINEL, np.int32)
    free = list(rng.permutation(np.arange(PagedKVCache.RESERVED, NP_)))
    positions = np.zeros((C,), np.int32)
    for c in range(C):
        nb_c = NB if full else int(rng.integers(1, NB + 1))
        ring = nb_c * P
        pos = int(rng.integers(ring - P, 2 * ring + 3))
        positions[c] = pos
        pages = [free.pop() for _ in range(nb_c)]
        table[c, :nb_c] = pages
        for j in range(ring):            # slot j holds the latest pos' = j
            filled = j <= pos            # (mod ring)
            wraps = (pos - j) // ring if filled else 0
            pos_pool[pages[j // P], j % P] = (j + wraps * ring if filled
                                              else POS_SENTINEL)
    q = rng.standard_normal((C, H, D)).astype(np.float32)
    on = lambda a: torch.from_numpy(a).to(dev)
    return (on(q).to(q_dtype), on(k_pool).to(torch.bfloat16),
            on(v_pool).to(torch.bfloat16), on(pos_pool), on(table),
            on(positions))


def decode_pair(state, window=None):
    return (pa.paged_attention_decode(*state, window=window),
            pa.paged_attention_decode_plain(*state, window=window))


def with_sentinel_column(state, j):
    """The state with a SENTINEL entry at column ``j`` of every table row."""
    table = state[4]
    pad = torch.full((table.shape[0], 1), PagedKVCache.SENTINEL,
                     dtype=table.dtype, device=table.device)
    return (*state[:4], torch.cat([table[:, :j], pad, table[:, j:]], dim=1),
            state[5])


def unreadable_entries(state, window=None) -> int:
    """Table entries naming a page with no key the row admits: the pages
    the decode kernel skips (unless the row admits no key at all)."""
    pos_pool, table, positions = (t.cpu() for t in state[3:6])
    kpos = pos_pool[table.long()]                        # (C, NB, P)
    ok = kpos <= positions[:, None, None]
    if window is not None:
        ok &= kpos > positions[:, None, None] - window
    return int((~ok.any(-1)).sum())


def rows_alone_match(state, window=None) -> bool:
    """Each row decoded alone gives the bits it gets inside the batch: the
    split of a row's walk depends on its own shape, not on the row count."""
    q, kp, vp, pp_, table, positions = state
    batch = pa.paged_attention_decode(*state, window=window)
    alone = [pa.paged_attention_decode(q[c:c + 1], kp, vp, pp_,
                                       table[c:c + 1], positions[c:c + 1],
                                       window=window)
             for c in range(q.shape[0])]
    torch.cuda.synchronize()
    return all(torch.equal(batch[c:c + 1], a) for c, a in enumerate(alone))


def scatter_pair(pool, pages, values):
    return (pa.paged_prefill_scatter(pool.clone(), pages, values),
            pa.paged_prefill_scatter_plain(pool.clone(), pages, values))


def admission_case(rng, S, NP_, P, Hkv, D, pages, ring, vdt, dev):
    """One attention sub-layer's admission: random bf16 pools and position
    pool, and a dense ring of K and V as a row of a batched prefill (stage
    stride three rows' worth), as the continuous engine hands it over."""
    pools = [torch.from_numpy(rng.standard_normal(
        (S, NP_, P, Hkv, D)).astype(np.float32)).to(dev, torch.bfloat16)
        for _ in range(2)]
    pos_pool = torch.from_numpy(rng.integers(
        0, 1 << 20, (NP_, P)).astype(np.int32)).to(dev)
    srcs = [torch.from_numpy(rng.standard_normal(
        (S, 3, ring, Hkv, D)).astype(np.float32)).to(dev, vdt)[:, 1]
        for _ in range(2)]
    pos_src = torch.arange(1000, 1000 + ring, dtype=torch.int32, device=dev)
    return (*pools, pos_pool, torch.tensor(pages, dtype=torch.int32,
                                           device=dev), *srcs, pos_src)


def hold_admission(errs: Errors, case, what: str,
                   positions: bool = True) -> None:
    """The admission entry against its plain version on copies of the same
    pools, bit for bit: K, V and (unless ``positions`` is False, a second
    sub-layer) the position pool, which is otherwise left alone."""
    kp, vp, pp = case[:3]
    got = [t.clone() for t in (kp, vp, pp)]
    want = [t.clone() for t in (kp, vp, pp)]
    if not positions:
        got[2] = want[2] = None
    pa.paged_admit_kv(*got, *case[3:])
    pa.paged_admit_kv_plain(*want, *case[3:])
    for tag, a, b in zip(("K", "V", "positions"), got, want):
        if b is not None:
            errs.hold_bits(K4, a, b, f"admission {what}: {tag}")


def decode_bound_ms(C, NB, P, H, Hkv, D, q_bytes):
    """Each named page's K and V tile and positions read once, the table,
    positions and q read once, the f32 output written once, at the memory
    rate; or the two products (4 flops per query head, key and element)
    at the bf16 rate -- whichever is larger."""
    nbytes = (C * NB * P * (2 * Hkv * D * 2 + 4) + C * NB * 4 + C * 4
              + C * H * D * (q_bytes + 4))
    flops = 4 * C * H * NB * P * D
    by, op = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


def scatter_bound_ms(S, nb, E, value_bytes):
    """The values read once and the named pages written once (bf16), at the
    memory rate; the cast is no arithmetic to speak of."""
    return (S * nb * E * (value_bytes + 2) + nb * 4) / PEAK_BYTES_PER_S * 1e3


def admission_bound_ms(S, nb, P, row, ring, value_bytes):
    """One sub-layer's admission: the dense K and V rings read once, their
    pages written once (bf16), the positions read and their pages' rows
    written once, the page list read once, at the memory rate."""
    nbytes = (2 * S * ring * row * value_bytes + 2 * S * nb * P * row * 2
              + ring * 4 + nb * P * 4 + nb * 4)
    return nbytes / PEAK_BYTES_PER_S * 1e3


def phase_paged_small(errs: Errors, dev) -> None:
    """Both paged kernels against their plain versions over the cases of
    tests/test_paged_attention.py and the edges the kernels handle."""
    rng = np.random.default_rng(2)
    for P, NB, H, Hkv, window in PAGED_CASES:
        for qdt in (torch.float32, torch.bfloat16):
            st = rand_paged_state(rng, C=3, NB=NB, P=P, H=H, Hkv=Hkv, D=8,
                                  dev=dev, q_dtype=qdt)
            errs.hold(K3, *decode_pair(st, window),
                      f"P{P} NB{NB} H{H} Hkv{Hkv} window {window} q {qdt}")
    for P, NB, H, Hkv, D, window in PAGED_WIDE:
        st = rand_paged_state(rng, C=3, NB=NB, P=P, H=H, Hkv=Hkv, D=D,
                              dev=dev, q_dtype=torch.bfloat16)
        errs.hold(K3, *decode_pair(st, window),
                  f"P{P} NB{NB} H{H} Hkv{Hkv} D{D} window {window}")
    # a row whose table is all SENTINEL: the uniform average of the full
    # softmax over an all -1e30 row, finite
    st = list(rand_paged_state(rng, C=2, NB=2, P=4, H=2, Hkv=2, D=8, dev=dev))
    st[4][0] = PagedKVCache.SENTINEL
    errs.hold(K3, *decode_pair(st), "all-masked row")
    st = rand_paged_state(rng, C=4, NB=3, P=4, H=4, Hkv=2, D=8, dev=dev,
                          full=True)
    errs.hold(K3, *decode_pair(st), "every row one full ring")
    # the split walk's edges through the wrapper's own split
    # (pa.decode_split, from a row's kv heads and table width): at 2 kv
    # heads every split is one entry; at 24 a split takes ceil(NB / 3)
    # entries (NB 7: 3 + 3 + 1, NB 11: 4 + 4 + 3); at 66 up to 8 (NB 7: one
    # split, NB 11: 8 + 3).  NB 1, table lengths no split divides, SENTINEL
    # in the middle of every row, a window that masks rows' early pages
    # whole, an all-masked row beside live ones; each row alone gives the
    # bits it gets in the batch
    for C, Hkv in ((3, 2), (5, 24), (4, 66)):
        geo = dict(C=C, P=4, H=2 * Hkv, Hkv=Hkv, D=8, dev=dev)
        for NB in (1, 7, 11):
            st = rand_paged_state(rng, NB=NB, q_dtype=torch.bfloat16, **geo)
            errs.hold(K3, *decode_pair(st),
                      f"C{C} Hkv{Hkv} NB{NB}, split "
                      f"{pa.decode_split(Hkv, NB)}")
            check(rows_alone_match(st), f"C{C} Hkv{Hkv} NB{NB}: a row "
                                        "decoded alone differs from its batch")
        st = with_sentinel_column(rand_paged_state(rng, NB=5, full=True,
                                                   **geo), 2)
        check(unreadable_entries(st) == C, "SENTINEL column not in place")
        errs.hold(K3, *decode_pair(st), f"C{C} Hkv{Hkv}: SENTINEL in the "
                                        "middle of every row")
        st = rand_paged_state(rng, NB=6, full=True, **geo)
        check(unreadable_entries(st, 6) > 0, "the window masks no page whole")
        errs.hold(K3, *decode_pair(st, 6),
                  f"C{C} Hkv{Hkv}: window 6 masking early pages")
        check(rows_alone_match(st, 6), f"C{C} Hkv{Hkv} window 6: a row "
                                       "decoded alone differs from its batch")
        st = list(rand_paged_state(rng, NB=4, **geo))
        st[4][1] = PagedKVCache.SENTINEL
        errs.hold(K3, *decode_pair(st),
                  f"C{C} Hkv{Hkv}: an all-masked row beside live ones")
    # no atomics in any sum: two calls give the same bits
    for C, Hkv in ((4, 2), (33, 8)):
        st = rand_paged_state(rng, C=C, NB=9, P=4, H=4 * Hkv, Hkv=Hkv, D=32,
                              dev=dev, q_dtype=torch.bfloat16)
        a, b = (pa.paged_attention_decode(*st) for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"C{C} Hkv{Hkv}: two decode calls differ")
    # a head size the 16-byte loads cannot take is refused, not computed
    st = rand_paged_state(rng, C=2, NB=2, P=4, H=2, Hkv=2, D=12, dev=dev)
    try:
        pa.paged_attention_decode(*st)
    except ValueError:
        pass
    else:
        raise PhaseFailed("the decode kernel took a head size of 12")
    # physical page ids are routing only: relabelling every page (pool rows
    # and table entries alike) leaves the output bit for bit
    for _ in range(6):
        q, kp, vp, pp_, pt, pos = rand_paged_state(rng, C=3, NB=3, P=4, H=4,
                                                   Hkv=2, D=8, dev=dev)
        perm = np.arange(kp.shape[0])
        body = perm[PagedKVCache.RESERVED:].copy()
        rng.shuffle(body)
        perm[PagedKVCache.RESERVED:] = body
        inv = torch.from_numpy(np.argsort(perm)).to(dev)
        relabel = torch.from_numpy(perm.astype(np.int32)).to(dev)
        base = pa.paged_attention_decode(q, kp, vp, pp_, pt, pos)
        got = pa.paged_attention_decode(q, kp[inv], vp[inv], pp_[inv],
                                        relabel[pt.long()], pos)
        torch.cuda.synchronize()
        check(torch.equal(base, got), "a page permutation changed the "
                                      "decode output")
    # the scatter: f32 and bf16 values into a bf16 pool, contiguous and as
    # a row sliced out of a batched prefill (strided stage axis)
    for vdt in (torch.float32, torch.bfloat16):
        for S, NP_, P, Hkv, D, pages in SCATTER_CASES:
            pool = torch.from_numpy(rng.standard_normal(
                (S, NP_, P, Hkv, D)).astype(np.float32)).to(dev,
                                                           torch.bfloat16)
            wide = torch.from_numpy(rng.standard_normal(
                (S, 3, len(pages), P, Hkv, D)).astype(np.float32)).to(dev, vdt)
            pg = torch.tensor(pages, dtype=torch.int32, device=dev)
            for tag, values in (("contiguous", wide[:, 0].contiguous()),
                                ("stage-strided", wide[:, 1])):
                errs.hold_bits(K4, *scatter_pair(pool, pg, values),
                               f"S{S} NP{NP_} P{P} Hkv{Hkv} D{D} {vdt} {tag}")
    # admission's entry into the same kernel: rings that fill their last
    # page, leave one position of it, and take one position of it
    n_scatter = errs.cases[K4]
    for vdt in (torch.float32, torch.bfloat16):
        for S, NP_, P, Hkv, D, pages in SCATTER_CASES:
            full = len(pages) * P
            for ring in (full, full - 1, full - P + 1):
                hold_admission(errs, admission_case(
                    rng, S, NP_, P, Hkv, D, pages, ring, vdt, dev),
                    f"S{S} NP{NP_} P{P} Hkv{Hkv} D{D} ring {ring} {vdt}")
    hold_admission(errs, admission_case(rng, 2, 9, 4, 2, 8, [4, 2, 7], 10,
                                        torch.bfloat16, dev),
                   "a second sub-layer", positions=False)
    say("paged", f"reference cases hold: decode {errs.cases[K3]} comparisons "
                 f"(rtol={PAGED_RTOL} atol={PAGED_ATOL}; split edges at "
                 f"1, ceil(NB / 3) and up to 8 entries a split), six page "
                 f"permutations bit for bit, two calls bit-identical, each "
                 f"row alone bit-identical with its batch, "
                 f"scatter {n_scatter} and admission "
                 f"{errs.cases[K4] - n_scatter} comparisons bit-exact")


def phase_paged_full(errs: Errors, dev, NB: int) -> dict:
    """Both kernels at the serving path's full-width shapes: held against
    their plain versions, then timed beside their bounds."""
    rng = np.random.default_rng(3)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    C, H, Hkv, D, P, S = FULL_C, FULL_H, FULL_HKV, FULL_D, FULL_P, FULL_S
    st = rand_paged_state(rng, C=C, NB=NB, P=P, H=H, Hkv=Hkv, D=D, dev=dev,
                          q_dtype=torch.bfloat16, full=True)
    errs.hold(K3, *decode_pair(st), f"full width C{C} NB{NB}")
    check(rows_alone_match(st), f"full width C{C} NB{NB}: a row decoded "
                                "alone differs from its batch")
    d_ms = cuda_ms(lambda: pa.paged_attention_decode(*st), 50, flush)
    d_plain = cuda_ms(lambda: pa.paged_attention_decode_plain(*st), 10, flush)
    d_bound, d_by = decode_bound_ms(C, NB, P, H, Hkv, D, 2)
    d_shape = (f"q ({C}, {H}, {D}) bf16, pools ({st[1].shape[0]}, {P}, "
               f"{Hkv}, {D}) bf16, table ({C}, {NB}), every page named")
    say("paged", f"decode {d_shape}: {d_ms:.4f} ms, plain {d_plain:.4f} ms, "
                 f"bound {d_bound:.4f} ms by {d_by}")
    del st

    E = P * Hkv * D
    NP_ = PagedKVCache.RESERVED + C * NB
    pool = torch.zeros((S, NP_, P, Hkv, D), dtype=torch.bfloat16, device=dev)
    timed_inputs = {}
    for nb in sorted({8, 12, NB}):
        pages = torch.from_numpy(rng.permutation(np.arange(
            PagedKVCache.RESERVED, NP_))[:nb].astype(np.int32)).to(dev)
        for vdt in (torch.float32, torch.bfloat16):
            values = torch.randn((S, nb, P, Hkv, D), device=dev).to(vdt)
            errs.hold_bits(K4, *scatter_pair(pool, pages, values),
                           f"full width S{S} nb{nb} {vdt}")
            if nb == 12:             # the bucket of a 64 + 128-token prompt
                timed_inputs[str(vdt).split(".")[1]] = (pages, values)
    # the scatter entry alone (one pool), timed in turns (f32, bf16, bf16,
    # f32 values), each figure the median of its two turns
    turns = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        pages, values = timed_inputs[name]
        long_pages, vb = pages.long(), values.to(torch.bfloat16)
        turns[name].append((
            cuda_ms(lambda: pa.paged_prefill_scatter(pool, pages, values),
                    50, flush),
            cuda_ms(lambda: pa.paged_prefill_scatter_plain(pool, pages,
                                                           values),
                    20, flush),
            cuda_ms(lambda: pool.index_copy_(1, long_pages, vb), 20, flush)))
    scatter = {}
    for name, runs in turns.items():
        k, plain, lib = (statistics.median(col) for col in zip(*runs))
        bound = scatter_bound_ms(S, 12, E, 4 if name == "float32" else 2)
        scatter[name] = dict(ms=k, plain_ms=plain, library_ms=lib,
                             bound_ms=bound)
        say("paged", f"scatter pool ({S}, {NP_}, {P}, {Hkv}, {D}) bf16, 12 "
                     f"pages, values {name}: {k:.4f} ms, plain {plain:.4f} "
                     f"ms, index_copy_ of bf16 values {lib:.4f} ms, bound "
                     f"{bound:.4f} ms (turns: {[round(r[0], 4) for r in runs]})")
    del pool, timed_inputs

    # admission (the path's entry): K, V and positions of one attention
    # sub-layer in one call, from a ring that fills its 12 pages (a 64 +
    # 128-token prompt) and from one that does not; held bit for bit, then
    # timed in turns (f32, bf16, bf16, f32 sources) beside its plain
    # version (the ops admission ran before) and two index_copy_ calls of
    # the already padded bf16 page blocks (K, then V; no positions)
    row = Hkv * D
    cases = {}
    for vdt in (torch.float32, torch.bfloat16):
        for ring in (12 * P, 12 * P - 7):
            pages = rng.permutation(np.arange(PagedKVCache.RESERVED,
                                              NP_))[:12].tolist()
            case = admission_case(rng, S, NP_, P, Hkv, D, pages, ring, vdt,
                                  dev)
            hold_admission(errs, case, f"full width S{S} 12 pages ring "
                                       f"{ring} {vdt}")
            if ring == 12 * P:
                cases[str(vdt).split(".")[1]] = case
    turns = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        case = cases[name]
        kp, vp, _, pages, ks, vs, _ = case
        long_pages = pages.long()
        blocks = [src.to(torch.bfloat16).reshape(S, 12, P, Hkv, D)
                  for src in (ks, vs)]

        def two_index_copies():
            kp.index_copy_(1, long_pages, blocks[0])
            vp.index_copy_(1, long_pages, blocks[1])

        turns[name].append((
            cuda_ms(lambda: pa.paged_admit_kv(*case), 50, flush),
            cuda_ms(lambda: pa.paged_admit_kv_plain(*case), 20, flush),
            cuda_ms(two_index_copies, 20, flush)))
    timed = {}
    for name, runs in turns.items():
        k, plain, lib = (statistics.median(col) for col in zip(*runs))
        bound = admission_bound_ms(S, 12, P, row, 12 * P,
                                   4 if name == "float32" else 2)
        timed[name] = dict(ms=k, plain_ms=plain, library_ms=lib,
                           bound_ms=bound)
        say("paged", f"admission pools 2 x ({S}, {NP_}, {P}, {Hkv}, {D}) "
                     f"bf16, 12 pages, ring {12 * P}, sources {name}: "
                     f"{k:.4f} ms, plain {plain:.4f} ms, two index_copy_ "
                     f"{lib:.4f} ms, bound {bound:.4f} ms (turns: "
                     f"{[round(r[0], 4) for r in runs]})")
    del cases
    a = timed["bfloat16"]            # the main path hands it bf16 values
    return {K3: {"ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
                 "bound_by": d_by, "library_ms": None, "shape": d_shape},
            K4: {**a, "bound_by": "bytes",
                 "shape": f"admission: pools 2 x ({S}, {NP_}, {P}, {Hkv}, "
                          f"{D}) bf16, 12 pages, ring {12 * P}, bf16 "
                          f"sources, positions",
                 "library_call": "index_copy_ of K, then of V (padded bf16 "
                                 "page blocks, no positions)",
                 "f32_sources": timed["float32"],
                 "scatter_entry": {"shape": f"pool ({S}, {NP_}, {P}, {Hkv}, "
                                            f"{D}) bf16, 12 pages",
                                   **scatter}}}

# the chat deployment's decode round (perfbench's internlm2-chat): capacity
# rows, table width, live rows and retired rows (their stale tables and
# positions) of CHAT_PAGES pages each; the rest never held a request
# (SENTINEL everywhere)
CHAT_C, CHAT_NB, CHAT_LIVE, CHAT_STALE, CHAT_PAGES = 64, 128, 17, 13, 48


def chat_round_state(rng, dev):
    """K3's arguments at the chat round's shape (internlm2's heads) and
    its row mask: CHAT_LIVE live rows and CHAT_STALE retired ones, each
    naming CHAT_PAGES pages of a full ring (the retired ones keep their
    last position), the other rows SENTINEL at position 0, rows in a
    random order."""
    C, NB, P, H, Hkv, D = (CHAT_C, CHAT_NB, FULL_P, FULL_H, FULL_HKV,
                           FULL_D)
    named = CHAT_LIVE + CHAT_STALE
    q, kp, vp, pp_, pt, pos = rand_paged_state(
        rng, C=named, NB=CHAT_PAGES, P=P, H=H, Hkv=Hkv, D=D, dev=dev,
        q_dtype=torch.bfloat16, full=True)
    order = torch.from_numpy(rng.permutation(C)).to(dev)
    rows = order[:named]
    table = torch.full((C, NB), PagedKVCache.SENTINEL, dtype=torch.int32,
                       device=dev)
    table[rows, :CHAT_PAGES] = pt
    positions = torch.zeros((C,), dtype=torch.int32, device=dev)
    positions[rows] = pos
    q_all = torch.from_numpy(rng.standard_normal((C, H, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    q_all[rows] = q
    mask = torch.zeros((C,), dtype=torch.bool, device=dev)
    mask[order[:CHAT_LIVE]] = True
    return (q_all, kp, vp, pp_, table, positions), mask


def phase_paged_chat(errs: Errors, dev) -> dict:
    """K3 at the chat deployment's decode round, with the round's row
    mask and without: live rows bit for bit, masked rows zero, the masked
    call held against its plain version; two masked calls bit-identical
    and an unmasked one after them unchanged (no ticket left behind); one
    masked call captured in a CUDA graph and replayed under three other
    masks, each bit for bit the eager call.  Then both calls timed beside
    the bound of the live rows' pages (``perfbench/roofline/k3.py``) and
    the plain version."""
    bench = os.path.join(ROOT, "perfbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from roofline import k3 as k3_roofline
    rng = np.random.default_rng(31)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    state, mask = chat_round_state(rng, dev)
    C, H, D = state[0].shape
    Hkv, P = state[1].shape[2], state[1].shape[1]
    what = (f"chat round C{C} table {CHAT_NB}: {CHAT_LIVE} live, "
            f"{CHAT_STALE} retired, {C - CHAT_LIVE - CHAT_STALE} SENTINEL")
    full = pa.paged_attention_decode(*state)
    got = pa.paged_attention_decode(*state, row_mask=mask)
    again = pa.paged_attention_decode(*state, row_mask=mask)
    after = pa.paged_attention_decode(*state)
    torch.cuda.synchronize()
    check(torch.equal(got[mask], full[mask]),
          f"{what}: live rows differ with the row mask")
    check(not bool(got[~mask].any()), f"{what}: a masked row is not zero")
    check(torch.equal(got, again), f"{what}: two masked calls differ")
    check(torch.equal(after, full), f"{what}: an unmasked call after masked "
                                    "ones differs")
    errs.hold(K3, got, pa.paged_attention_decode_plain(*state,
                                                       row_mask=mask), what)
    # one captured call serves any set of live rows: the mask is read on
    # the device at every replay
    side = torch.cuda.Stream(device=dev)
    buf = mask.clone()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention_decode(*state, row_mask=buf)     # its scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = pa.paged_attention_decode(*state, row_mask=buf)
    held = pa.detach_scratch(dev, side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    named = state[4][:, 0] != PagedKVCache.SENTINEL
    for tag, other in (("every named row", named),
                       ("every row", torch.ones_like(mask)),
                       ("the retired rows", named & ~mask)):
        buf.copy_(other)
        graph.replay()
        want = pa.paged_attention_decode(*state, row_mask=other)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"{what}: the captured call replayed "
                                      f"with {tag} live differs")
    del graph, held, out
    ms = cuda_ms(lambda: pa.paged_attention_decode(*state, row_mask=mask), 50,
                 flush)
    ms_all = cuda_ms(lambda: pa.paged_attention_decode(*state), 50, flush)
    plain = cuda_ms(lambda: pa.paged_attention_decode_plain(
        *state, row_mask=mask), 10, flush)
    bound_s, by = k3_roofline.bound(CHAT_LIVE, CHAT_PAGES, P, H, Hkv, D)
    bound = bound_s * 1e3
    shape = (f"q ({C}, {H}, {D}) bf16, pools ({state[1].shape[0]}, {P}, "
             f"{Hkv}, {D}) bf16, table ({C}, {CHAT_NB}); {CHAT_LIVE} live "
             f"rows and {CHAT_STALE} retired of {CHAT_PAGES} pages, "
             f"{C - CHAT_LIVE - CHAT_STALE} SENTINEL")
    say("paged", f"decode at the chat round {shape}: masked {ms:.4f} ms, "
                 f"unmasked {ms_all:.4f} ms, plain (masked) {plain:.4f} ms, "
                 f"bound of the live rows {bound:.4f} ms by {by} "
                 f"({100 * bound / ms:.1f} % masked, "
                 f"{100 * bound / ms_all:.1f} % unmasked); live rows bit for "
                 "bit, a captured call replayed under three masks")
    return dict(ms=ms, unmasked_ms=ms_all, plain_ms=plain, bound_ms=bound,
                bound_by=by, shape=shape)


# ---------------------------------------------------------------------------
# the SSD scan: the pure-SSM serving path's kernel
# ---------------------------------------------------------------------------
# (b, L, H, P, N, chunk): tests/test_kernels_ssd.py::SWEEP, then the serving
# path's chunk of 256 at its head geometry (P 64, N 128), two chunks long
SSD_SWEEP = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 32, 32),
             (2, 32, 8, 4, 8, 8), (1, 256, 1, 64, 128, 64),
             (2, 512, 4, 64, 128, 256)]
# the serving path's prefill: 8 admissions of 384-token prompts at once,
# padded by ops.ssd to two chunks of 256; x, B and C in bfloat16, B and C
# one group viewed over the 80 heads
SSD_FULL = dict(b=8, L=384, H=80, P=64, N=128, chunk=256)
# jamba's Mamba-2 layers: d_inner 16,384 in 256 heads of 64, state 128, at
# its 1024-token prefill, widths 8 (continuous) and 4 (a slot)
SSD_JAMBA = dict(b=8, L=1024, H=256, P=64, N=128, chunk=256)
# (b, L, H, P, N, chunk) in bfloat16 through the tensor-core kernel
SSD_MMA_EDGES = [(2, 200, 3, 32, 64, 100), (1, 128, 5, 24, 40, 64),
                 (8, 512, 6, 64, 128, 256), (1, 512, 80, 64, 128, 256)]
# one group's B/C at widths where the wrapper takes two heads a block and a
# row alone one (ssd.head_tile on 132 SMs), the last head tile ragged
SSD_TILE_EDGES = [(2, 128, 81, 64, 128, 64), (4, 200, 67, 24, 40, 100)]


def ssd_case(rng, b, L, H, P, N, dev, *, decay=1.0, dtype=torch.float32,
             one_group=False):
    """x, dt, a, B, C, h0 as tests/test_kernels_ssd.py::_case draws them
    (A scaled by ``decay``); with ``one_group`` B and C are one group's
    projection viewed over every head (head stride 0)."""
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, L, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H)) * decay).astype(np.float32)
    a = (A[None, None, :] * dt).astype(np.float32)
    G = 1 if one_group else H
    B = rng.standard_normal((b, L, G, N)).astype(np.float32)
    C = rng.standard_normal((b, L, G, N)).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    on = lambda v: torch.from_numpy(v).to(dev)
    x, B, C = (on(v).to(dtype) for v in (x, B, C))
    if one_group:
        B, C = (t.expand(-1, -1, H, -1) for t in (B, C))
    return x, on(dt), on(a), B, C, on(h0)


def ssd_pair(args, chunk, h0=None):
    return (ssd.ssd_chunked(*args, chunk=chunk, initial_state=h0),
            ssd.ssd_chunked_plain(*args, chunk=chunk, initial_state=h0))


def ssd_rows_alone_match(args, chunk, h0=None) -> bool:
    """Each row scanned alone gives the bits it gets inside the batch,
    whatever head tile the wrapper picks at either width."""
    y, h = ssd.ssd_chunked(*args, chunk=chunk, initial_state=h0)
    for i in range(y.shape[0]):
        yi, hi = ssd.ssd_chunked(*(t[i:i + 1] for t in args), chunk=chunk,
                                 initial_state=None if h0 is None
                                 else h0[i:i + 1])
        if not (torch.equal(y[i:i + 1], yi) and torch.equal(h[i:i + 1], hi)):
            return False
    return True


def check_two_tilings(b, H, P, sms, what: str) -> None:
    """The batch of ``b`` rows takes two heads a block, a row alone one."""
    tiles = (ssd.head_tile(b, H, P, True, sms), ssd.head_tile(1, H, P, True,
                                                              sms))
    check(tiles == (2, 1), f"{what}: head tiles {tiles} for the batch and a "
                           f"row alone on {sms} SMs, need (2, 1)")


def hold_ssd(errs: Errors, pair, what: str) -> None:
    """y and the final state of the kernel against its plain version, at
    the tolerance of the inputs' type."""
    (y, h), (yw, hw) = pair
    bf16 = y.dtype == torch.bfloat16
    errs.hold(K6, y, yw, what + " y",
              tol=(SSD_BF16_Y,) * 2 if bf16 else None)
    errs.hold(K6, h, hw, what + " state",
              tol=(SSD_BF16_STATE,) * 2 if bf16 else None)


def ssd_bound_ms(b, L, H, P, N, Q, in_bytes, bc_heads, h0=False):
    """Each input read once (B and C as stored: ``bc_heads`` heads of them)
    and y and the state written once at the memory rate, or the function's
    operations at the peak rate for the inputs' type (the bf16 tensor rate
    for bfloat16 inputs, the float32 rate otherwise), whichever is larger.
    Per (row, head, chunk): the causal half of C.B^T (2N per pair), the
    masked decay (4 per pair), the product with x (2P per pair), the
    carried-state term (Q P (2N + 2)), the state update (2 Q P N + Q P + 2 P
    N) and the chunk's cumulative sum and exponentials (4 Q)."""
    pairs = Q * (Q + 1) // 2
    per_chunk = (pairs * (2 * N + 4 + 2 * P) + Q * P * (2 * N + 2)
                 + 2 * Q * P * N + Q * P + 2 * P * N + 4 * Q)
    flops = b * H * (L // Q) * per_chunk
    nbytes = (2 * b * L * H * P * in_bytes + 2 * b * L * H * 4
              + 2 * b * L * bc_heads * N * in_bytes
              + (2 if h0 else 1) * b * H * P * N * 4)
    peak = PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_F32_FLOPS
    by, op = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


def phase_ssd_small(errs: Errors, dev) -> None:
    """The SSD scan kernel against its plain version over the reference's
    sweep (with and without an initial state), bfloat16 inputs, the pad of
    ops.ssd, a decay large enough to overflow exp in the masked half, B and
    C as one group's stride-0 view, x as a strided view."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    for b, L, H, P, N, chunk in SSD_SWEEP:
        for with_h0 in (False, True):
            *args, h0 = ssd_case(rng, b, L, H, P, N, dev)
            hold_ssd(errs, ssd_pair(args, chunk, h0 if with_h0 else None),
                     f"b{b} L{L} H{H} P{P} N{N} chunk{chunk} h0 {with_h0}")
    for b, L, H, P, N, chunk in ((1, 32, 2, 8, 16, 16), (2, 512, 4, 64, 128,
                                                         256)):
        *args, h0 = ssd_case(rng, b, L, H, P, N, dev, dtype=torch.bfloat16)
        hold_ssd(errs, ssd_pair(args, chunk, h0), f"bf16 b{b} L{L} chunk{chunk}")
    # the tensor-core kernel's edges: per-head B/C (one head a block), Q not
    # a multiple of its 64-step tiles, P 32 and N 64, P and N not multiples
    # of 16, an initial state or none, one group's B/C at widths 1 and 8;
    # then widths where the batch takes two heads a block (a ragged last
    # tile at H 81 and 67) and a row alone one: every row bit for bit
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, L, H, P, N, chunk in SSD_MMA_EDGES + SSD_TILE_EDGES:
        for with_h0 in (False, True):
            what = f"bf16 b{b} L{L} H{H} P{P} N{N} chunk{chunk} h0 {with_h0}"
            if (b, L, H, P, N, chunk) in SSD_MMA_EDGES:
                *args, h0 = ssd_case(rng, b, L, H, P, N, dev,
                                     dtype=torch.bfloat16)
                hold_ssd(errs, ssd_pair(args, chunk, h0 if with_h0 else None),
                         what + " per-head B/C")
            *args, h0 = ssd_case(rng, b, L, H, P, N, dev,
                                 dtype=torch.bfloat16, one_group=True)
            init = h0 if with_h0 else None
            hold_ssd(errs, ssd_pair(args, chunk, init), what + " one group")
            if (b, L, H, P, N, chunk) in SSD_TILE_EDGES:
                check_two_tilings(b, H, P, sms, what)
                check(ssd_rows_alone_match(args, chunk, init),
                      f"{what}: a row alone (one head a block) differs from "
                      "its bits in the batch (two heads a block)")
    *args, _ = ssd_case(rng, 2, 128, 3, 16, 32, dev, decay=40.0,
                        dtype=torch.bfloat16, one_group=True)
    hold_ssd(errs, ssd_pair(args, 64), "bf16 large decay (masked half)")
    # rows not on 16 bytes: the kernel's element-wise tile loads
    wide = torch.randn((2, 64, 4 * 16 + 41), device=dev).to(torch.bfloat16)
    x = wide[..., 1:65].reshape(2, 64, 4, 16)
    *args, _ = ssd_case(rng, 2, 64, 4, 16, 32, dev, dtype=torch.bfloat16)
    check(x.data_ptr() % 16 != 0, "the unaligned x view is aligned")
    hold_ssd(errs, ssd_pair([x] + args[1:], 32), "bf16 x an unaligned view")
    check(ssd.variant_counts["bf16_mma"] > 0
          and ssd.variant_counts["f32_simt"] > 0,
          f"SSD variants {ssd.variant_counts}: both kernels should have run")
    # L 384 through ops.ssd: padded to two chunks of 256, y cut back to L
    for with_h0 in (False, True):
        *args, h0 = ssd_case(rng, 2, 384, 4, 64, 128, dev)
        init = h0 if with_h0 else None
        before = ssd.launch_counts[K6]
        y, h = kops.ssd(*args, chunk=256, initial_state=init)
        check(ssd.launch_counts[K6] == before + 1 and y.shape[1] == 384,
              "ops.ssd did not launch the kernel once on the padded input")
        yw, hw = ssd.ssd_chunked_plain(
            *(kops._pad_steps(t, 128) for t in args), chunk=256,
            initial_state=init)
        hold_ssd(errs, ((y, h), (yw[:, :384], hw)), f"ops.ssd pad L384 h0 "
                 f"{with_h0}")
    *args, _ = ssd_case(rng, 2, 128, 3, 16, 32, dev, decay=40.0)
    a_cum = torch.cumsum(args[2].reshape(2, 2, 64, 3), dim=2)
    check(float((a_cum[:, :, 0] - a_cum[:, :, -1]).max()) > 89.0,
          "the large-decay case does not reach exp's overflow")
    hold_ssd(errs, ssd_pair(args, 64), "large decay (masked half past exp)")
    # B and C as the serving path hands them over: one group, stride 0
    *args, h0 = ssd_case(rng, 2, 128, 8, 64, 128, dev, one_group=True)
    check(args[3].stride(2) == 0, "B is not a stride-0 view")
    got = ssd.ssd_chunked(*args, chunk=64, initial_state=h0)
    want = ssd.ssd_chunked_plain(*args[:3], args[3].contiguous(),
                                 args[4].contiguous(), chunk=64,
                                 initial_state=h0)
    hold_ssd(errs, (got, want), "B/C one group, head stride 0")
    # x as a view into a wider tensor (the conv output's x columns)
    wide = torch.randn((2, 64, 4 * 16 + 40), device=dev)
    x = wide[..., :64].reshape(2, 64, 4, 16)
    *args, _ = ssd_case(rng, 2, 64, 4, 16, 32, dev)
    hold_ssd(errs, ssd_pair([x] + args[1:], 32), "x a strided view")
    for P, N in ((80, 128), (64, 256)):
        *args, _ = ssd_case(rng, 1, 32, 2, P, N, dev)
        try:
            ssd.ssd_chunked(*args, chunk=16)
        except ValueError:
            pass
        else:
            raise PhaseFailed(f"the SSD kernel took P={P}, N={N}")
    say("ssd", f"sweep and edge cases hold: {errs.cases[K6]} comparisons "
               f"(float32 rtol=atol={SSD_RTOL}; bfloat16 y {SSD_BF16_Y}, "
               f"state {SSD_BF16_STATE}); P 80 and N 256 refused")


SSD_FULL_WIDTHS = (SSD_FULL["b"], 4, 1)   # continuous prefill, a tenant
                                         # slot's, a single admission's


def phase_ssd_full(errs: Errors, dev) -> dict:
    """The SSD kernel at mamba2's full-width prefill shapes -- the
    continuous path's width 8, a tenant slot's 4 and a single admission's
    1 -- held, timed and each row scanned alone (``ssd_shapes``); the batch
    takes two heads a block and a row alone one."""
    out = ssd_shapes(errs, dev, SSD_FULL, SSD_FULL_WIDTHS, two_tilings=True)
    full = out[SSD_FULL["b"]]
    return {K6: {**full, "library_ms": None, "slot_width": out[4],
                 "single_admission": out[1]}}


def ssd_shapes(errs: Errors, dev, f: dict, widths, two_tilings: bool
               ) -> dict:
    """The SSD kernel at one arch's full-width prefill shape ``f`` at each
    of ``widths``, held against its plain version in bf16 (the paths' type)
    and on the same numbers in float32, then timed beside its bound.  At
    widths over 1 each row scanned alone gives its bits in the batch."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    Q, L = f["chunk"], f["L"]
    pad = (-L) % Q
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for b in widths:
        g = torch.Generator(device=dev).manual_seed(7)
        rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
        x = rnd(b, L, f["H"], f["P"]).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(rnd(b, L, f["H"]))
        a = -torch.exp(rnd(f["H"]))[None, None, :] * dt
        B, C = (rnd(b, L, 1, f["N"]).to(torch.bfloat16).expand(
            -1, -1, f["H"], -1) for _ in range(2))
        args = [kops._pad_steps(t, pad) for t in (x, dt, a, B, C)]
        check(args[3].stride(2) == 0, "the padded B is not a stride-0 view")
        Lp = L + pad
        ht = ssd.head_tile(b, f["H"], f["P"], True, sms)
        blocks = b * -(-f["H"] // ht) * -(-f["P"] // ssd.P_TILE)
        shape = (f"x ({b}, {Lp}, {f['H']}, {f['P']}) bf16, B/C ({b}, {Lp}, 1 "
                 f"-> {f['H']}, {f['N']}) bf16, chunk {Q}")
        before = ssd.variant_counts["bf16_mma"]
        hold_ssd(errs, ssd_pair(args, Q), "full width " + shape)
        check(ssd.variant_counts["bf16_mma"] == before + 1,
              f"{shape}: the tensor-core kernel did not run")
        before = ssd.variant_counts["f32_simt"]
        hold_ssd(errs, ssd_pair([t.float() for t in args], Q),
                 f"full width {shape} as float32")
        check(ssd.variant_counts["f32_simt"] == before + 1,
              f"{shape} as float32: the float32 kernel did not run")
        ms = cuda_ms(lambda: ssd.ssd_chunked(*args, chunk=Q), 10, flush)
        plain = cuda_ms(lambda: ssd.ssd_chunked_plain(*args, chunk=Q), 3,
                        flush)
        bound, by = ssd_bound_ms(b, Lp, f["H"], f["P"], f["N"], Q, 2, 1)
        say("ssd", f"{shape} ({blocks} blocks of {ht} heads x "
                   f"{ssd.P_TILE} columns): {ms:.4f} ms, plain "
                   f"{plain:.4f} ms, bound {bound:.4f} ms by {by} "
                   f"({bound / ms:.1%} of it)")
        out[b] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                      shape=shape, head_tile=ht, blocks=blocks)
        if b > 1:
            if two_tilings:
                check_two_tilings(b, f["H"], f["P"], sms,
                                  f"full width {b}")
            check(ssd_rows_alone_match(args, Q),
                  f"full width {shape}: a row alone (head tile "
                  f"{ssd.head_tile(1, f['H'], f['P'], True, sms)}) differs "
                  f"from its bits in the batch (head tile {ht})")
        del args, x, dt, a, B, C
    return out


# ---------------------------------------------------------------------------
# FlashAttention: every attention prefill's kernel
# ---------------------------------------------------------------------------
# (B, Sq, Skv, Hq, Hkv, D, causal, window): tests/test_kernels_flash.py's
# SWEEP and test_cross_lengths, then the edges: a ragged length, a length
# whose reference blocks would be 4 rows (1500), h2o-danube's head size of
# 80, windows whose rows' early key tiles are masked whole, causal Sq != Skv
# both ways (top-left), rows that admit no key at all (they average every
# key), a non-causal window, and the serving archs' head geometries; then
# the tensor-core kernel's own edges: D 24 (padded to 32 in shared memory),
# Sq not a multiple of its query tile (64 / G positions for G heads of a
# group in a block), GQA 4:1 and 8:1 (one K/V tile for the whole group),
# and a group of 32 (two blocks of 16 heads)
FLASH_SWEEP = [
    (2, 64, 64, 4, 2, 16, True, None), (1, 128, 128, 8, 2, 32, True, None),
    (2, 64, 64, 4, 4, 16, False, None), (1, 128, 128, 4, 1, 16, True, 32),
    (1, 32, 32, 2, 2, 64, False, 8), (1, 32, 128, 4, 2, 16, False, None),
    (1, 100, 100, 4, 2, 16, True, None), (1, 1500, 1500, 2, 2, 64, False, None),
    (1, 200, 200, 8, 2, 80, True, 64), (2, 300, 300, 4, 1, 32, True, 100),
    (1, 48, 32, 4, 2, 16, True, None), (1, 32, 96, 4, 2, 16, True, None),
    (1, 140, 20, 2, 1, 16, True, 8), (1, 24, 200, 4, 2, 16, False, 16),
    (2, 130, 130, 16, 8, 128, True, None), (1, 192, 192, 16, 16, 128, True, None),
    (2, 40, 40, 4, 2, 8, True, None),
    (1, 77, 77, 4, 4, 24, True, None), (2, 37, 37, 8, 2, 64, True, None),
    (1, 45, 90, 16, 2, 32, False, None), (1, 203, 203, 8, 1, 128, True, 50),
    (1, 50, 50, 32, 1, 16, True, 12),
]
# the full-width shapes of the serving paths: olmoe's prefill at widths 8
# and 1 (1024-token prompts, MHA), internlm2's at width 8 (GQA 2:1), both
# at a tenant slot's width of 4, and serve-archs' prefills
FLASH_FULL = [("olmoe-1b-7b width 8", 8, 1024, 16, 16, 128),
              ("olmoe-1b-7b width 1", 1, 1024, 16, 16, 128),
              ("internlm2-1.8b width 8", 8, 128, 16, 8, 128),
              ("olmoe-1b-7b width 4", 4, 1024, 16, 16, 128),
              ("internlm2-1.8b width 4", 4, 128, 16, 8, 128),
              # the four archs of serve-archs: GQA 12:1, 8:1, 5:1 and 4:1 at
              # the continuous path's width 8, jamba and llava also at a
              # slot's width 4
              ("mistral-large-123b width 8", 8, 512, 96, 8, 128),
              ("jamba-1.5-large-398b width 8", 8, 1024, 64, 8, 128),
              ("llama4-maverick-400b-a17b width 8", 8, 512, 40, 8, 128),
              ("llava-next-mistral-7b width 8", 8, 640, 32, 8, 128),
              ("jamba-1.5-large-398b width 4", 4, 1024, 64, 8, 128),
              ("llava-next-mistral-7b width 4", 4, 640, 32, 8, 128)]


def flash_case(rng, B, Sq, Skv, Hq, Hkv, D, dev, dtype=torch.float32):
    on = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)
    return on(B, Sq, Hq, D), on(B, Skv, Hkv, D), on(B, Skv, Hkv, D)


def flash_pair(q, k, v, causal, window):
    return (fa.flash_attention(q, k, v, causal=causal, window=window),
            fa.flash_attention_plain(q, k, v, causal=causal, window=window))


def flash_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, window, in_bytes):
    """q, k and v read once and o written once at the memory rate, or the
    products the function needs -- two of 2D flops per admissible (query,
    key) pair and head, the pairs this mask admits -- at the peak rate for
    the inputs' type (bf16 tensor cores, or float32), whichever is
    larger."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    flops = 4 * D * B * Hq * int(ok.sum())
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * in_bytes
    rate = PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_F32_FLOPS
    by, op = nbytes / PEAK_BYTES_PER_S * 1e3, flops / rate * 1e3
    return max(by, op), "bytes" if by >= op else "operations"


def phase_flash_small(errs: Errors, dev) -> None:
    """The FlashAttention kernel against its plain version over the
    reference's sweep and the edges, float32 and bfloat16, a strided q,
    and the head sizes it refuses."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    for B, Sq, Skv, Hq, Hkv, D, causal, window in FLASH_SWEEP:
        what = (f"B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} D{D} causal {causal} "
                f"window {window}")
        q, k, v = flash_case(rng, B, Sq, Skv, Hq, Hkv, D, dev)
        errs.hold(K5, *flash_pair(q, k, v, causal, window), what)
        # bfloat16 inputs against the float32 plain version of the same
        # (rounded) numbers
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        got = fa.flash_attention(qb, kb, vb, causal=causal, window=window)
        check(got.dtype == torch.bfloat16, f"{what}: bf16 output dtype")
        want = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(),
                                        causal=causal, window=window)
        errs.hold(K5, got.float(), want, what + " bf16",
                  tol=(FLASH_BF16_RTOL, FLASH_BF16_ATOL))
    # rows that admit no key: the dense oracle's uniform average, through
    # either kernel
    q, k, v = flash_case(rng, 1, 140, 20, 2, 1, 16, dev)
    errs.hold(K5, fa.flash_attention(q, k, v, causal=True, window=8),
              kref.flash_attention_ref(q, k, v, True, 8),
              "rows with no admissible key vs the dense oracle")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    errs.hold(K5, fa.flash_attention(qb, kb, vb, causal=True,
                                     window=8).float(),
              kref.flash_attention_ref(qb.float(), kb.float(), vb.float(),
                                       True, 8),
              "rows with no admissible key vs the dense oracle, bf16",
              tol=(FLASH_BF16_RTOL, FLASH_BF16_ATOL))
    # q a strided view (a wider projection's columns), k and v views too
    wide = torch.randn((2, 96, 4, 48), device=dev)
    q, k, v = wide[..., :16], wide[:, :, :2, 16:32], wide[:, :, 2:, 32:48]
    check(not q.is_contiguous(), "q is not a strided view")
    errs.hold(K5, *flash_pair(q, k, v, True, None), "strided q, k, v")
    for D in (12, 136):
        q, k, v = flash_case(rng, 1, 16, 16, 2, 2, D, dev)
        try:
            fa.flash_attention(q, k, v)
        except ValueError:
            pass
        else:
            raise PhaseFailed(f"the flash kernel took a head size of {D}")
    say("flash", f"sweep and edge cases hold: {errs.cases[K5]} comparisons "
                 f"(float32 rtol=atol={FLASH_RTOL}; bfloat16 inputs "
                 f"rtol={FLASH_BF16_RTOL} atol={FLASH_BF16_ATOL} against "
                 "float32); D 12 and 136 refused")


def flash_timed(errs: Errors, dev, name: str, B, Sq, Skv, Hq, Hkv, D,
                causal: bool, flush: torch.Tensor) -> dict:
    """The FlashAttention kernel at one prefill shape: held against its
    plain version on the same inputs in float32 and in bf16 and against
    ``scaled_dot_product_attention``, then timed (bf16) in turns with
    that library call, beside its bound and its plain version."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((B, s, h, D), generator=g, device=dev).to(
        torch.bfloat16) for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    errs.hold(K5, *flash_pair(q.float(), k.float(), v.float(), causal,
                              None), f"full width {name} float32")
    got, want = flash_pair(q, k, v, causal, None)
    errs.hold(K5, got, want, f"full width {name} bf16",
              tol=(FLASH_BF16_RTOL, FLASH_BF16_ATOL))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = sdpa(qt, kt, vt, is_causal=causal,
               enable_gqa=Hq != Hkv).transpose(1, 2).float()
    lib_err = float((got.float() - lib).abs().max())
    check(bool(torch.allclose(got.float(), lib, rtol=FLASH_SDPA,
                              atol=FLASH_SDPA)),
          f"{K5} full width {name} vs scaled_dot_product_attention: "
          f"max abs err {lib_err:.3g} outside rtol=atol={FLASH_SDPA}")
    turns = []
    for _ in range(2):             # kernel, library, library, kernel
        turns.append(cuda_ms(lambda: fa.flash_attention(q, k, v,
                                                        causal=causal),
                             10, flush))
        turns.append(cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                          enable_gqa=Hq != Hkv),
                             10, flush))
    ms = statistics.median(turns[0::2])
    lib_ms = statistics.median(turns[1::2])
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                     causal=causal),
                    3, flush)
    bound, by = flash_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, None, 2)
    shape = (f"q ({B}, {Sq}, {Hq}, {D}), k/v ({B}, {Skv}, {Hkv}, {D}) bf16, "
             + ("causal" if causal else "non-causal"))
    say("flash", f"{name}: held against the plain version in float32 "
                 f"and bf16 (running max abs err {errs.abs[K5]:.3g}) and "
                 f"against scaled_dot_product_attention (max abs err "
                 f"{lib_err:.3g})")
    say("flash", f"{name}: {shape}: {ms:.4f} ms, plain {plain:.4f} ms, "
                 f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
                 f"{bound:.4f} ms by {by} (bf16 tensor-core rate) (turns "
                 f"{[round(t, 4) for t in turns]})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, shape=shape)


def phase_flash_full(errs: Errors, dev) -> dict:
    """The FlashAttention kernel at the serving paths' full-width prefill
    shapes (causal): held against its plain version on the same inputs in
    float32 and in bf16, then timed (bf16) beside its bound, its plain
    version and one PyTorch call computing the same function
    (``scaled_dot_product_attention``, used nowhere in the port)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    out = {name: flash_timed(errs, dev, name, B, S, S, Hq, Hkv, D, True,
                             flush)
           for name, B, S, Hq, Hkv, D in FLASH_FULL}
    main = out[FLASH_FULL[0][0]]
    return {K5: {**main, "other_shapes": {
        n: r for n, r in out.items() if r is not main}}}


def generate_oracle(eng: ServingEngine, ceng, req) -> np.ndarray:
    """``generate`` on the request's page-aligned left-padded prompt, with
    its extra inputs: the continuous path's exactness contract.  A
    temperature row draws what ``generate`` at its temperature draws for
    its seed; top-k 1 is greedy; a wider top-k has no oracle (None)."""
    b = ceng.bucket_len(req.prompt.size)
    padded = np.zeros((1, b), np.int32)
    padded[0, b - req.prompt.size:] = req.prompt
    temp = req.temperature or 0.0
    if temp > 0 and req.top_k > 1:
        return None
    if temp > 0 and req.top_k != 1:
        eng = ServingEngine(eng.cfg, eng.params, temperature=temp,
                            device=eng.device)
    extras = {k: np.asarray(v)[None]
              for k, v in (req.extra_inputs or {}).items()}
    return eng.generate(padded, max_new_tokens=req.max_new_tokens,
                        extra_inputs=extras or None,
                        seed=req.seed).tokens[0]


def dense_hybrid_config():
    """Reduced jamba without its MoE: Mamba-2 and attention layers with
    dense MLPs, whose rows are independent, so its continuous tokens are
    held to ``generate``'s."""
    return dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                               name="jamba-dense-hybrid-reduced", moe=None,
                               moe_period=0)


# the reduced archs of the continuous path on the card, with the page size
# of each run: every decoder-only arch the port serves, and the dense hybrid
REDUCED_ARCHS = (("internlm2-1.8b", 8), ("h2o-danube-1.8b", 4),
                 ("mamba2-2.7b", 8), ("olmoe-1b-7b", 8),
                 ("mistral-large-123b", 8), ("jamba-1.5-large-398b", 8),
                 ("dense hybrid", 8), ("llama4-maverick-400b-a17b", 8),
                 ("llava-next-mistral-7b", 8))


def phase_serve_reduced(dev) -> dict:
    """The continuous engine of every reduced decoder-only arch in float32
    on the card (h2o-danube's sliding window masked by the decode and
    prefill kernels; mamba2's prefills through the SSD scan kernel;
    jamba's and the dense hybrid's through both, beside attention pages;
    llava's requests with one image's patch embeddings): shared prefixes,
    copy-on-write forks, a repeated prompt (a prefill skip on a
    pure-attention arch, a prefill on a hybrid), eviction and reuse under
    churn, ragged prompts and budgets -- every request's greedy tokens
    equal to ``generate``'s, every attention prefill through the
    FlashAttention kernel.  The MoE archs (olmoe, llama4, jamba) run the
    same schedule with their own gates (completion, finite rows,
    conservation): capacity routing couples rows, so their agreement with
    ``generate`` is a number."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, page in REDUCED_ARCHS:
        cfg = (dense_hybrid_config() if arch == "dense hybrid"
               else get_config(arch).reduced())
        eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
        rng = np.random.default_rng(37)
        V = cfg.vocab_size
        # one image for every request (a vision arch's prompts share pages
        # only under identical patch embeddings)
        image = serve_cli.synth_extra_inputs(cfg, rng) or None
        sys_prompt = rng.integers(1, V, 16).astype(np.int32)
        mk = lambda t: Request(f"t{t}", np.concatenate(
            [sys_prompt, rng.integers(1, V, 8).astype(np.int32)]),
            max_new_tokens=6, extra_inputs=image)
        wave = [mk(t) for t in range(3)]
        batches = [wave, [Request("t0", wave[0].prompt.copy(),
                                  max_new_tokens=6, extra_inputs=image)],
                   [Request("x", rng.integers(1, V, 32).astype(np.int32),
                            max_new_tokens=2, extra_inputs=image)
                    for _ in range(6)],
                   [Request(f"r{i}", rng.integers(1, V, 5 + 7 * i).astype(
                       np.int32), max_new_tokens=3 + 4 * i,
                       extra_inputs=image) for i in range(4)],
                   [mk(t) for t in range(3)],
                   # sampling tiers: more than one round key is captured
                   [Request(f"s{i}", rng.integers(1, V, 9 + 5 * i).astype(
                       np.int32), max_new_tokens=4 + 3 * i, seed=i,
                       extra_inputs=image, **kw)
                    for i, kw in enumerate(
                        [{}, dict(temperature=0.8),
                         dict(temperature=0.9, top_k=1),
                         dict(temperature=1.1, top_k=5), {}])]]
        ceng = ContinuousBatchingEngine(eng, capacity=3, page_size=page,
                                        inner_steps=4, max_prompt_len=32,
                                        device=dev)
        moe = ContinuousBatchingEngine.supported_modes(cfg)[
            "continuous"]["exactness"] == "statistical"
        pa.reset_counts()                # just before this run
        ssd.reset_counts()
        fa.reset_counts()
        done = []
        for batch in batches:
            done += ceng.run_all(batch)
        launches = {**pa.launch_counts, **ssd.launch_counts,
                    **fa.launch_counts}
        variants = dict(fa.variant_counts)
        plains = {**pa.plain_counts, **ssd.plain_counts, **fa.plain_counts}
        n = sum(len(b) for b in batches)
        check(len(done) == n, f"{arch} reduced: {len(done)} of {n} done")
        n_attn = ceng.n_stages * len(ceng.kv.attn_subs)
        n_ssm = ceng.n_stages * len(ceng.ssm_subs)
        # each state kind's kernels, and only those: attention prefills
        # through K5 and admissions through K4, decode through K3; Mamba-2
        # prefills through K6 (a hybrid arch all four)
        ran = ((K3, K4, K5) if n_attn else ()) + ((K6,) if n_ssm else ())
        check(all((launches[k] > 0) == (k in ran) for k in launches)
              and not any(plains.values()),
              f"{arch} reduced: launches {launches}, plain calls {plains}")
        check(launches[K5] == ceng.prefill_calls * n_attn
              and launches[K6] == ceng.prefill_calls * n_ssm,
              f"{arch} reduced: {launches[K5]} K5 and {launches[K6]} K6 "
              f"launches for {ceng.prefill_calls} prefills over {n_attn} "
              f"attention and {n_ssm} Mamba-2 layers")
        check(launches[K3] == ceng.rounds * ceng.inner_steps * n_attn,
              f"{arch} reduced: {launches[K3]} K3 launches for "
              f"{ceng.rounds} rounds")
        graphs = graph_rounds(ceng, f"{arch} reduced")
        check(graphs["keys_captured"] >= 2,
              f"{arch} reduced: one round key captured, not several")
        check(variants == {"bf16_mma": 0, "f32_simt": launches[K5]},
              f"{arch} reduced (float32): flash variants {variants}")
        check(ssd.variant_counts == {"bf16_mma": 0,
                                     "f32_simt": launches[K6]},
              f"{arch} reduced (float32): SSD variants {ssd.variant_counts}")
        ceng.assert_conserved()
        check(ceng.nonfinite_rows == 0, f"{arch} reduced: non-finite logits")
        if cfg.sliding_window is None and n_attn:
            check(ceng.kv.pages_shared > 0
                  and ceng.kv.cow_forks + ceng.kv.pristine_forks > 0,
                  f"{arch} reduced: the sharing lifecycle did not run")
            # a hybrid row's SSM state is neither paged nor cached: its
            # repeated prompt is prefilled again
            check(ceng.prefill_skips >= 1 if not n_ssm
                  else ceng.prefill_skips == 0,
                  f"{arch} reduced: {ceng.prefill_skips} prefill skips")
        same = []
        for req, toks in done:
            check(toks.shape == (req.max_new_tokens,) and 0 <= toks.min()
                  and toks.max() < V, f"{arch} reduced: tokens {toks}")
            want = generate_oracle(eng, ceng, req)
            if want is None:
                continue
            check(moe or np.array_equal(toks, want),
                  f"{arch} reduced: continuous {toks.tolist()} != generate "
                  f"{want.tolist()} (prompt of {req.prompt.size}, "
                  f"temperature {req.temperature}, top-k {req.top_k})")
            same.append(float(np.mean(toks == want)))
        out[arch] = dict(requests=n, launches=launches,
                         pages_shared=ceng.kv.pages_shared,
                         cow_forks=ceng.kv.cow_forks,
                         pristine_forks=ceng.kv.pristine_forks,
                         prefill_skips=ceng.prefill_skips,
                         pages_reused=ceng.kv.pages_reused,
                         token_agreement=float(np.mean(same)), **graphs)
        say("serve", f"{arch} reduced, float32 on the card: {n} requests "
                     + ("(MoE: agreement with generate is a number)"
                        if moe else "token-exact with generate")
                     + f"; {out[arch]}")
        del eng, ceng
    torch.cuda.empty_cache()
    return out


def graph_rounds(ceng, what: str) -> dict:
    """The round program of an engine that served on the card: one graph
    per key, as many keys as ``decode_traces``, every other round a
    replay."""
    prog = ceng.round_program
    check(prog is not None and len(prog.rounds) == ceng.decode_traces > 0,
          f"{what}: rounds did not go through CUDA graphs (keys "
          f"{list(prog.rounds) if prog else None}, decode traces "
          f"{ceng.decode_traces})")
    replays = sum(c.replays for c in prog.rounds.values())
    check(replays + len(prog.rounds) == ceng.rounds,
          f"{what}: {replays} replays and {len(prog.rounds)} captures for "
          f"{ceng.rounds} rounds")
    return dict(keys_captured=len(prog.rounds), replays=replays,
                capture_ms={str(k): c.capture_ms
                            for k, c in prog.rounds.items()})


class ServeRecorder:
    """The ``observe`` hook of ``launch.serve.main``: keeps the scheduler,
    every retired (request, tokens), and a copy of one live round's paged
    state (first layer's pools, position pool, page table, positions)."""

    def __init__(self, snap: bool = True):
        self.sched = None
        self.finished = []
        self.want_snap = snap
        self.snap = None
        self.init_peak_gib = None
        self.t_first = None

    def __call__(self, sched) -> None:
        eng = sched.continuous_engine
        if self.sched is None:
            # first call: the weights are drawn, cast and the float32 draw
            # dropped; nothing has run yet
            self.init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
            self.t_first = time.perf_counter()
            self.sched = sched
            collect = eng.collect

            def recording_collect(handle):
                res = collect(handle)
                self.finished.extend((r, t) for r, t, _ in res.finished)
                return res

            eng.collect = recording_collect
        elif (self.want_snap and self.snap is None and eng.kv.attn_subs
              and eng.active_count() == eng.capacity):
            # enqueued behind the round in flight: the state it leaves
            st, sub = eng.state, eng.kv.attn_subs[0]
            self.snap = dict(k_pool=st["caches"][sub]["k"][0].clone(),
                             v_pool=st["caches"][sub]["v"][0].clone(),
                             pos_pool=st["pos_pool"].clone(),
                             page_table=st["page_table"].clone(),
                             positions=(st["pos"] - 1).clamp_min(0))


def phase_serve_full(errs: Errors, dev) -> dict:
    """The serving main path: ``launch.serve.main`` at the published width
    of internlm2-1.8b, 12 requests from 3 tenants, without and with a
    64-token shared prefix (prefix hits, copy-on-write forks as the decode
    ring wraps onto the shared pages)."""
    recs = {}
    walls = {}
    agg.reset_counts()
    ssd.reset_counts()
    fa.reset_counts()
    pa.reset_counts()                    # just before the serving path
    for spl in SHARED_PREFIXES:
        rec = ServeRecorder()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rc = serve_cli.main(SERVE_ARGV + ["--shared-prefix-len", str(spl)],
                            observe=rec)
        walls[spl] = time.perf_counter() - t0
        check(rc == 0, f"serve returned {rc}")
        rec.peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        recs[spl] = rec
    launches = {**pa.launch_counts, **fa.launch_counts}
    variants = dict(fa.variant_counts)
    plains = {**pa.plain_counts, **fa.plain_counts}
    other = sum(agg.launch_counts.values()) + sum(
        ssd.launch_counts.values()) + sum(ssd.plain_counts.values())
    # just after

    check(not any(plains.values()) and other == 0,
          f"the serving path took another route: plain {plains}, "
          f"aggregate or SSD calls {other}")
    want_k3 = want_k4 = want_k5 = 0
    runs = {}
    rng = np.random.default_rng(4)
    for spl, rec in recs.items():
        sched, eng = rec.sched, rec.sched.continuous_engine
        cfg = eng.cfg
        tag = f"shared prefix {spl}"
        n_sub = len(eng.kv.attn_subs)
        want_k3 += eng.rounds * eng.inner_steps * eng.n_stages * n_sub
        want_k4 += n_sub * (len(rec.finished) - eng.prefill_skips)
        want_k5 += eng.n_stages * n_sub * eng.prefill_calls
        check(len(rec.finished) == 12 and all(
            t.shape == (32,) for _, t in rec.finished),
            f"{tag}: {len(rec.finished)} requests finished, token counts "
            f"{sorted({t.size for _, t in rec.finished})}")
        check(all(int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
                  for _, t in rec.finished), f"{tag}: token out of vocab")
        check(eng.nonfinite_rows == 0, f"{tag}: non-finite logits")
        eng.kv.assert_conserved()
        check(eng.active_count() == 0 and sched.pending() == 0,
              f"{tag}: rows left after the drain")
        if spl:
            check(eng.kv.pages_shared > 0
                  and eng.kv.cow_forks + eng.kv.pristine_forks > 0,
                  f"{tag}: no prefix hits or forks")
        # one live round's real pool, table and positions: kernel vs plain
        check(rec.snap is not None, f"{tag}: no live round was observed")
        q = torch.randn((eng.capacity, cfg.num_heads, cfg.head_dim),
                        device=dev).to(torch.bfloat16)
        s = rec.snap
        state = (q, s["k_pool"], s["v_pool"], s["pos_pool"], s["page_table"],
                 s["positions"])
        errs.hold(K3, *decode_pair(state, cfg.sliding_window),
                  f"{tag}: a live round's pool and table")
        # agreement with the blocking engine on the same prompts: at bf16
        # the two paths' GEMMs differ in shape, so this is a number
        reqs = [r for r, _ in rec.finished]
        prompts = np.stack([r.prompt for r in reqs])
        check(prompts.shape[1] % eng.page_size == 0,
              f"{tag}: prompts need no padding for this comparison")
        gen = eng.engine.generate(prompts, max_new_tokens=32).tokens
        got = np.stack([t for _, t in rec.finished])
        same = got == gen
        first_diff = [int(np.argmin(row)) if not row.all() else row.size
                      for row in same]
        pre, rnd = eng.prefill_ms(), eng.round_ms
        runs[spl] = dict(
            wall_s=walls[spl], prefill_calls=len(pre),
            prefill_ms=pre, rounds=len(rnd), round_ms_mean=float(np.mean(rnd)),
            round_ms_median=float(np.median(rnd)),
            decode_tokens=eng.row_steps,
            decode_tokens_per_s=eng.row_steps / (sum(rnd) * 1e-3),
            occupancy=eng.occupancy(), peak_gib=rec.peak_gib,
            pages_allocated=eng.kv.pages_allocated,
            pages_shared=eng.kv.pages_shared, cow_forks=eng.kv.cow_forks,
            pristine_forks=eng.kv.pristine_forks,
            token_agreement=float(same.mean()),
            requests_identical=int(same.all(axis=1).sum()),
            mean_first_divergence=float(np.mean(first_diff)),
            overlap_pairs=sum(timeline_overlaps(sched.timeline)),
            timeline_rounds=len(sched.timeline), **graph_rounds(eng, tag))
        say("serve", f"internlm2-1.8b full width, {tag}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in runs[spl].items() if k != "prefill_ms")
            + f", prefill ms {[round(x, 3) for x in pre]}")
    check(launches[K3] == want_k3 and launches[K4] == want_k4
          and launches[K5] == want_k5,
          f"launches {launches}, expected decode {want_k3}, admission "
          f"{want_k4}, flash {want_k5}")
    check(variants == {"bf16_mma": launches[K5], "f32_simt": 0},
          f"internlm2 full width (bf16): flash variants {variants}")
    say("serve", f"serving path launches: decode {launches[K3]}, admission "
                 f"{launches[K4]}, flash {launches[K5]} (variants "
                 f"{variants}); plain calls 0")
    max_blocks = max(r.sched.continuous_engine.kv.max_blocks
                     for r in recs.values())
    plane_off = served_run(recs[0])
    rounds = compare_rounds(recs[0].sched.engine, dev, prompt_len=128,
                            scratch_check=True)
    del recs
    gc.collect()                         # the recorders' hooks form cycles
    torch.cuda.empty_cache()
    return {"launches": launches, "variants": variants, "runs": runs,
            "max_blocks": max_blocks, "rounds": rounds,
            "plane_off": plane_off}


def served_run(rec: ServeRecorder) -> dict:
    """What a serve run gave: tokens by prompt, the captured round keys,
    the rounds and their CUDA-event times."""
    eng = rec.sched.continuous_engine
    return {"tokens": {r.prompt.tobytes(): t for r, t in rec.finished},
            "keys": set(eng.round_program.rounds)
            if eng.round_program is not None else set(),
            "decode_traces": eng.decode_traces, "rounds": eng.rounds,
            "round_ms": list(eng.round_ms)}


OBS_LAYERS = {"sched", "round", "admit", "kv"}
STATS_EVERY = 4


def phase_serve_obs(dev, plane_off: dict) -> dict:
    """``launch.serve`` at internlm2-1.8b's full width, shared prefix 0,
    with ``--trace-out``, ``--metrics-out`` and ``--stats-every``: the
    trace loads and covers the scheduler, round, admission and page-pool
    layers with one ``round.device`` span a round; the metrics parse; the
    ``obs:`` lines print; tokens, captured keys and decode traces equal
    the same run's with the plane off (``phase_serve_full``)."""
    with tempfile.TemporaryDirectory(prefix="serve-obs-") as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        prom_path = os.path.join(tmp, "metrics.prom")
        rec = ServeRecorder()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve_cli.main(SERVE_ARGV + [
                "--shared-prefix-len", "0", "--trace-out", trace_path,
                "--metrics-out", prom_path,
                "--stats-every", str(STATS_EVERY)], observe=rec)
        printed = out.getvalue()
        check(rc == 0, f"serve with the plane returned {rc}")
        check(not TELEMETRY.enabled, "the plane was left on")
        with open(trace_path) as fh:
            trace = json.load(fh)
        with open(prom_path) as fh:
            metrics_text = fh.read()
    on = served_run(rec)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    layers = {e["cat"] for e in spans}
    n_device = sum(e["name"] == "round.device" for e in spans)
    prom = parse_prometheus_text(metrics_text)
    obs_lines = [l for l in printed.splitlines() if l.startswith("obs: ")]
    check(OBS_LAYERS <= layers, f"serve-obs: trace layers {sorted(layers)}")
    check(n_device == on["rounds"] > 0,
          f"serve-obs: {n_device} round.device spans for {on['rounds']} "
          f"rounds")
    check(prom.get("repro_kv_pages_allocated", 0) > 0
          and prom.get("repro_heartbeat_beats", 0) > 0,
          f"serve-obs: metrics {sorted(prom)[:8]}")
    check(len(obs_lines) >= 1, "serve-obs: no obs: line was printed")
    check(on["tokens"].keys() == plane_off["tokens"].keys() and all(
        np.array_equal(t, plane_off["tokens"][k])
        for k, t in on["tokens"].items()),
        "serve-obs: tokens differ from the same run with the plane off")
    check(on["keys"] == plane_off["keys"]
          and on["decode_traces"] == plane_off["decode_traces"],
          f"serve-obs: captured keys {on['keys']} / decode traces "
          f"{on['decode_traces']} against {plane_off['keys']} / "
          f"{plane_off['decode_traces']} with the plane off")
    graph_rounds(rec.sched.continuous_engine, "serve-obs")
    res = {"spans": len(spans), "layers": sorted(layers),
           "round_device_spans": n_device, "metrics": len(prom),
           "obs_lines": len(obs_lines),
           "round_ms_median_on": float(np.median(on["round_ms"])),
           "round_ms_median_off": float(np.median(plane_off["round_ms"])),
           "rounds": on["rounds"]}
    say("serve-obs", f"internlm2-1.8b full width with the plane: {len(spans)} "
                     f"spans over layers {sorted(layers)}, {n_device} "
                     f"round.device spans for {on['rounds']} rounds, "
                     f"{len(prom)} metrics, {len(obs_lines)} obs: lines "
                     f"({obs_lines[-1][5:80]}...); tokens, keys and decode "
                     f"traces as with the plane off; replayed round median "
                     f"{res['round_ms_median_on']:.2f} ms on, "
                     f"{res['round_ms_median_off']:.2f} ms off")
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


# the pure-SSM serving path: launch.serve at the published width of mamba2;
# 384-token prompts bucket to 384, so each prefill's scan runs chunk 256
# padded to 512 -- two chunks per launch, the state carried between them,
# and ops.ssd's pad
MAMBA_ARGV = ["--arch", "mamba2-2.7b", "--no-reduced", "--mode",
              "continuous", "--tenants", "3", "--requests", "12",
              "--prompt-len", "384", "--new-tokens", "32", "--capacity", "8",
              "--inner-steps", "4"]


def phase_serve_mamba2(dev) -> dict:
    """The pure-SSM serving path: ``launch.serve.main`` at the published
    width and depth of mamba2-2.7b, 12 requests from 3 tenants, capacity 8;
    every prefill through the SSD scan kernel (64 launches a call)."""
    cfg = get_config("mamba2-2.7b")
    n_params = param_count(build_model(cfg).init(0, "meta"))
    rec = ServeRecorder()
    gc.collect()                         # nothing of earlier phases is held
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    agg.reset_counts()
    pa.reset_counts()
    fa.reset_counts()
    ssd.reset_counts()                   # just before the serving path
    t0 = time.perf_counter()
    rc = serve_cli.main(MAMBA_ARGV, observe=rec)
    wall = time.perf_counter() - t0
    launches = {**ssd.launch_counts, **pa.launch_counts, **agg.launch_counts,
                **fa.launch_counts}
    plains = {**ssd.plain_counts, **pa.plain_counts, **agg.plain_counts,
              **fa.plain_counts}
    variants = dict(ssd.variant_counts)
    # just after
    check(rc == 0, f"serve returned {rc}")
    sched, eng = rec.sched, rec.sched.continuous_engine
    check(len(rec.finished) == 12 and all(t.shape == (32,)
                                          for _, t in rec.finished),
          f"mamba2: {len(rec.finished)} requests finished, token counts "
          f"{sorted({t.size for _, t in rec.finished})}")
    check(all(int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
              for _, t in rec.finished), "mamba2: token out of vocab")
    check(eng.nonfinite_rows == 0, "mamba2: non-finite logits")
    check(eng.active_count() == 0 and sched.pending() == 0,
          "mamba2: rows left after the drain")
    eng.kv.assert_conserved()
    check(eng.kv.pages_allocated == 0, "mamba2: pages were allocated")
    check(launches[K6] == cfg.num_layers * eng.prefill_calls
          and launches[K6] > 0,
          f"mamba2: {launches[K6]} scan launches for {eng.prefill_calls} "
          f"prefill calls of {cfg.num_layers} layers")
    check(not any(plains.values())
          and all(v == 0 for k, v in launches.items() if k != K6),
          f"mamba2: another route was taken: launches {launches}, plain "
          f"calls {plains}")
    check(variants == {"bf16_mma": launches[K6], "f32_simt": 0},
          f"mamba2 full width (bf16): SSD variants {variants}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # agreement with the blocking engine on the same prompts: at bf16 the
    # two paths' products differ in shape, so this is a number
    prompts = np.stack([r.prompt for r, _ in rec.finished])
    check(prompts.shape[1] % eng.page_size == 0,
          "mamba2: prompts need no padding for this comparison")
    gen = eng.engine.generate(prompts, max_new_tokens=32).tokens
    got = np.stack([t for _, t in rec.finished])
    same = got == gen
    first_diff = [int(np.argmin(row)) if not row.all() else row.size
                  for row in same]
    pre, rnd = eng.prefill_ms(), eng.round_ms
    run = dict(
        params=n_params, wall_s=wall, prefill_calls=len(pre),
        prefill_ms=pre, rounds=len(rnd),
        round_ms_mean=float(np.mean(rnd)),
        round_ms_median=float(np.median(rnd)), decode_tokens=eng.row_steps,
        decode_tokens_per_s=eng.row_steps / (sum(rnd) * 1e-3),
        occupancy=eng.occupancy(), peak_gib=peak,
        init_peak_gib=rec.init_peak_gib,
        token_agreement=float(same.mean()),
        requests_identical=int(same.all(axis=1).sum()),
        mean_first_divergence=float(np.mean(first_diff)),
        overlap_pairs=sum(timeline_overlaps(sched.timeline)),
        timeline_rounds=len(sched.timeline), scan_launches=launches[K6],
        scan_variants=variants, **graph_rounds(eng, "mamba2"))
    say("serve", "mamba2-2.7b full width: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in run.items() if k != "prefill_ms")
        + f", prefill ms {[round(x, 3) for x in pre]}")
    run["rounds"] = compare_rounds(sched.engine, dev, prompt_len=384)
    del rec, sched, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches[K6], "run": run}


# the MoE serving path: launch.serve at the published width of olmoe; every
# admission's prefill attention (1024-token prompts, MHA) through the
# FlashAttention kernel, every decode step's through the paged decode kernel
# at group size 1
OLMOE_ARGV = ["--arch", "olmoe-1b-7b", "--no-reduced", "--mode",
              "continuous", "--tenants", "3", "--requests", "12",
              "--prompt-len", "1024", "--new-tokens", "32", "--capacity", "8",
              "--page-size", "16", "--inner-steps", "4",
              "--shared-prefix-len", "0"]


def phase_serve_olmoe(dev) -> dict:
    """The MoE serving path: ``launch.serve.main`` at the published width
    and depth of olmoe-1b-7b (16 layers, 64 experts top-8), 12 requests of
    1024 random tokens from 3 tenants, capacity 8."""
    cfg = get_config("olmoe-1b-7b")
    n_params = param_count(build_model(cfg).init(0, "meta"))
    rec = ServeRecorder()
    gc.collect()                         # nothing of earlier phases is held
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    agg.reset_counts()
    ssd.reset_counts()
    pa.reset_counts()
    fa.reset_counts()                    # just before the serving path
    t0 = time.perf_counter()
    rc = serve_cli.main(OLMOE_ARGV, observe=rec)
    wall = time.perf_counter() - t0
    launches = {**fa.launch_counts, **pa.launch_counts, **ssd.launch_counts,
                **agg.launch_counts}
    variants = dict(fa.variant_counts)
    plains = {**fa.plain_counts, **pa.plain_counts, **ssd.plain_counts,
              **agg.plain_counts}
    # just after
    check(rc == 0, f"serve returned {rc}")
    sched, eng = rec.sched, rec.sched.continuous_engine
    check(len(rec.finished) == 12 and all(t.shape == (32,)
                                          for _, t in rec.finished),
          f"olmoe: {len(rec.finished)} requests finished, token counts "
          f"{sorted({t.size for _, t in rec.finished})}")
    check(all(int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
              for _, t in rec.finished), "olmoe: token out of vocab")
    check(eng.nonfinite_rows == 0, "olmoe: non-finite logits")
    check(eng.active_count() == 0 and sched.pending() == 0,
          "olmoe: rows left after the drain")
    eng.kv.assert_conserved()
    n_attn = eng.n_stages * len(eng.kv.attn_subs)
    want = {K5: n_attn * eng.prefill_calls,
            K3: n_attn * eng.rounds * eng.inner_steps,
            # one launch (every stage's K and V, the positions) per
            # attention sub-layer and admission
            K4: len(eng.kv.attn_subs) * (len(rec.finished)
                                         - eng.prefill_skips)}
    check(n_attn == cfg.num_layers and launches[K5] > 0
          and all(launches[k] == n for k, n in want.items()),
          f"olmoe: launches {launches}, expected {want} ({eng.prefill_calls}"
          f" prefill calls, {eng.rounds} rounds of {eng.inner_steps} steps)")
    check(not any(plains.values())
          and all(v == 0 for k, v in launches.items() if k not in want),
          f"olmoe: another route was taken: launches {launches}, plain "
          f"calls {plains}")
    check(variants == {"bf16_mma": launches[K5], "f32_simt": 0},
          f"olmoe full width (bf16): flash variants {variants}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # agreement with the blocking engine on the same prompts: capacity
    # routing couples rows (and the widths differ), so this is a number
    prompts = np.stack([r.prompt for r, _ in rec.finished])
    gen = eng.engine.generate(prompts, max_new_tokens=32).tokens
    got = np.stack([t for _, t in rec.finished])
    same = got == gen
    first_diff = [int(np.argmin(row)) if not row.all() else row.size
                  for row in same]
    pre, rnd = eng.prefill_ms(), eng.round_ms
    run = dict(
        params=n_params, wall_s=wall, prefill_calls=len(pre),
        prefill_ms=pre, rounds=len(rnd),
        round_ms_mean=float(np.mean(rnd)),
        round_ms_median=float(np.median(rnd)), decode_tokens=eng.row_steps,
        decode_tokens_per_s=eng.row_steps / (sum(rnd) * 1e-3),
        occupancy=eng.occupancy(), peak_gib=peak,
        init_peak_gib=rec.init_peak_gib,
        pages_allocated=eng.kv.pages_allocated,
        token_agreement=float(same.mean()),
        requests_identical=int(same.all(axis=1).sum()),
        mean_first_divergence=float(np.mean(first_diff)),
        overlap_pairs=sum(timeline_overlaps(sched.timeline)),
        timeline_rounds=len(sched.timeline),
        launches={k: launches[k] for k in want}, flash_variants=variants,
        **graph_rounds(eng, "olmoe"))
    say("serve", "olmoe-1b-7b full width: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in run.items() if k != "prefill_ms")
        + f", prefill ms {[round(x, 3) for x in pre]}")
    run["rounds"] = compare_rounds(sched.engine, dev, prompt_len=1024)
    run["profile_prefill"] = profile_prefill(sched.engine, dev, 8, 1024)
    run["max_blocks"] = eng.kv.max_blocks
    del rec, sched, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "variants": variants, "run": run}


def phase_paged_olmoe(errs: Errors, dev, NB: int) -> dict:
    """The paged decode kernel at olmoe's decode shape -- group size 1
    (16 query heads over 16 kv heads), every row's ring of 1024 tokens 64
    pages long -- held against its plain version and timed beside its
    bound: with the path's page table (``NB`` entries a row, the rest
    SENTINEL padding, whose pages the kernel skips after reading their
    positions) and with a table of the 64 named pages alone."""
    rng = np.random.default_rng(10)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    C, H, D, P = 8, 16, 128, 16
    named = int(OLMOE_ARGV[OLMOE_ARGV.index("--prompt-len") + 1]) // P
    st = rand_paged_state(rng, C=C, NB=named, P=P, H=H, Hkv=H, D=D, dev=dev,
                          q_dtype=torch.bfloat16, full=True)
    pad = torch.full((C, NB - named), PagedKVCache.SENTINEL,
                     dtype=torch.int32, device=dev)
    path = st[:4] + (torch.cat([st[4], pad], dim=1),) + st[5:]
    out = {}
    for tag, state, nb in (("path", path, NB), ("named", st, named)):
        errs.hold(K3, *decode_pair(state),
                  f"olmoe shape C{C} table {nb} ({named} named) group 1")
        again = [pa.paged_attention_decode(*state) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*again), f"olmoe shape table {nb}: two decode "
                                   "calls differ")
        check(rows_alone_match(state), f"olmoe shape table {nb}: a row "
                                       "decoded alone differs from its batch")
        ms = cuda_ms(lambda: pa.paged_attention_decode(*state), 50, flush)
        plain = cuda_ms(lambda: pa.paged_attention_decode_plain(*state), 10,
                        flush)
        # the named pages read once (the SENTINEL page adds one page)
        bound, by = decode_bound_ms(C, named, P, H, H, D, 2)
        shape = (f"q ({C}, {H}, {D}) bf16, pools ({st[1].shape[0]}, {P}, {H},"
                 f" {D}) bf16, table ({C}, {nb}), {named} pages named a row")
        say("paged", f"decode at olmoe's shape {shape}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, bound {bound:.4f} ms by {by}")
        out[tag] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                        shape=shape)
    return {**out["path"], "named_pages_only": out["named"]}


def profile_prefill(eng: ServingEngine, dev, width: int, prompt_len: int
                    ) -> dict:
    """Where one full-width prefill call's time goes: ``width`` random
    prompts of ``prompt_len`` (with the arch's synthetic extra inputs, an
    encoder-decoder's frames) through ``ServingEngine.prefill`` under
    ``torch.profiler``, device time by kernel against the call's CUDA-event
    window."""
    rng = np.random.default_rng(11)
    prompts = rng.integers(1, eng.cfg.vocab_size,
                           (width, prompt_len)).astype(np.int32)
    rows = [serve_cli.synth_extra_inputs(eng.cfg, rng) for _ in range(width)]
    batch = eng._make_batch(prompts, {k: np.stack([r[k] for r in rows])
                                      for k in rows[0]})
    eng.prefill(batch)                               # warm
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        eng.prefill(batch)
        b.record()
        b.synchronize()
    window_ms = a.elapsed_time(b)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    out = dict(window_ms=window_ms, launches=sum(k[2] for k in kernels),
               device_busy_ms=busy_ms if kernels else None,
               device_idle_share=(1 - busy_ms / window_ms) if kernels
               else None,
               top=[(n[:60], round(ms, 4), c) for n, ms, c in kernels[:8]])
    say("serve", f"{eng.cfg.name} profiled prefill (width {width} x "
                 f"{prompt_len}): CUDA-event window {window_ms:.2f} ms, "
                 f"device busy {busy_ms:.2f} ms over {out['launches']} "
                 f"kernels; by kernel: {out['top']}")
    return out


MIB_LEFT_PER_ENGINE = 2
ROUNDS_COMPARED = 12         # decode rounds each engine of compare_rounds
ROUNDS_TIMED = slice(2, -1)  # runs; timed: after the capture round (0) and
                             # the synchronisation check (1), before the
                             # profiled last one


def profile_one_round(ceng) -> tuple:
    """One round dispatched and collected under ``torch.profiler``: device
    time by kernel against the round's CUDA-event window and the host's
    enqueue time.  Returns (numbers, the round's handle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle = ceng.dispatch_round()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ceng.collect(handle)
    window_ms = ceng.round_ms[-1]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return dict(round_window_ms=window_ms, host_enqueue_ms=enqueue_ms,
                launches=sum(k[2] for k in kernels),
                device_busy_ms=busy_ms if kernels else None,
                device_idle_share=(1 - busy_ms / window_ms) if kernels
                else None,
                top=[(n[:60], round(ms, 4), c) for n, ms, c in kernels[:8]]
                ), handle


def scratch_probe(ceng, dev) -> int:
    """After the first capture: one eager paged-decode call on the graph
    engine's capture stream at a table wider than the round's.  The
    captured round took its scratch out of the kernel's cache, so the call
    allocates its own; the rounds replayed after it must still give the
    eager engine's tokens.  Returns the launches it made (1)."""
    prog = ceng.round_program
    held = [sc for cap in prog.rounds.values() for sc in cap.held]
    check(len(held) == len(prog.rounds),
          f"captured rounds hold {len(held)} K3 scratch sets for "
          f"{len(prog.rounds)} keys")
    st, sub, cfg = ceng.state, ceng.kv.attn_subs[0], ceng.cfg
    C, NB = st["page_table"].shape
    table = torch.cat([st["page_table"], torch.full(
        (C, NB + 1), PagedKVCache.SENTINEL, dtype=torch.int32, device=dev)],
        dim=1)
    q = torch.randn((C, cfg.num_heads, cfg.head_dim),
                    device=dev).to(torch.bfloat16)
    side, cur = prog.backend.stream, torch.cuda.current_stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        pa.paged_attention_decode(q, st["caches"][sub]["k"][0],
                                  st["caches"][sub]["v"][0], st["pos_pool"],
                                  table, st["pos"])
    cur.wait_stream(side)
    new = pa._SCRATCH[(dev.index, side.cuda_stream)]
    check(all(new[k].data_ptr() != h[k].data_ptr() for h in held for k in h),
          "an eager call on the capture stream reused a graph's K3 scratch")
    say("serve", f"{cfg.name}: an eager K3 call at a table of {2 * NB + 1} "
                 f"entries (the round's {NB}) on the capture stream took "
                 "scratch of its own; the captured rounds keep theirs")
    return 1


def compare_rounds(eng: ServingEngine, dev, prompt_len: int,
                   scratch_check: bool = False) -> dict:
    """Rounds as CUDA graphs against rounds enqueued op by op (after the
    main path, whose launch counts are already read): the same 8 admissions
    of ``prompt_len`` random prompts through an eager engine
    (``round_graphs=False``) and then a graph engine, ``ROUNDS_COMPARED``
    rounds of 4 steps each, every row live throughout.  Per engine: round
    ms by CUDA events, decode tokens/s, peak memory, K3 launches (equal
    for the two), one profiled round; for the graph engine the keys
    captured and the capture ms, and its second round -- a replay --
    dispatched under ``set_sync_debug_mode("error")``.  The emitted tokens
    of the two engines are compared round by round."""
    V = eng.cfg.vocab_size
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, V, prompt_len).astype(np.int32)
               for _ in range(8)]
    out, tokens, logits = {}, {}, {}
    for mode in ("eager", "graph"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
        ceng = ContinuousBatchingEngine(eng, capacity=8, page_size=16,
                                        inner_steps=4,
                                        max_prompt_len=2 * prompt_len,
                                        device=dev,
                                        round_graphs=mode == "graph")
        n_attn = ceng.n_stages * len(ceng.kv.attn_subs)
        reqs = [Request("p", p.copy(), max_new_tokens=4 * ROUNDS_COMPARED)
                for p in prompts]
        check(all(ceng.try_admit_batch(reqs)), "compare: admission failed")
        pa.reset_counts()
        probes = 0
        em, lg, host_ms = [], [], []
        for r in range(ROUNDS_COMPARED):
            if mode == "graph" and r == 1:
                if scratch_check and n_attn:
                    probes += scratch_probe(ceng, dev)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    handle = ceng.dispatch_round()
                except RuntimeError as e:
                    raise PhaseFailed(f"dispatching a replayed round "
                                      f"synchronised the host: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                ceng.collect(handle)
            elif r == ROUNDS_COMPARED - 1:
                prof, handle = profile_one_round(ceng)
                out.setdefault(mode, {})["profile"] = prof
            else:
                t0 = time.perf_counter()
                handle = ceng.dispatch_round()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                ceng.collect(handle)
            em.append(handle.emitted.numpy().copy())
            lg.append(ceng.state["logits"].cpu())
        k3 = pa.launch_counts[K3] - probes
        check(k3 == ROUNDS_COMPARED * ceng.inner_steps * n_attn,
              f"{mode} rounds: {k3} K3 launches for {ROUNDS_COMPARED} rounds "
              f"of {ceng.inner_steps} steps over {n_attn} attention layers")
        ms = ceng.round_ms[ROUNDS_TIMED]
        busy = out[mode]["profile"]["device_busy_ms"]
        run = dict(round_ms_median=float(np.median(ms)),
                   round_ms_min=float(np.min(ms)), rounds_timed=len(ms),
                   host_dispatch_ms_median=float(np.median(host_ms[1:])),
                   # the profiled round's busy time against an unprofiled
                   # round: tracing stretches a round's window
                   idle_share_of_median_round=None if busy is None
                   else 1 - busy / float(np.median(ms)),
                   decode_tokens_per_s=8 * ceng.inner_steps * len(ms)
                   / (sum(ms) * 1e-3),
                   first_round_ms=ceng.round_ms[0], k3_launches=k3,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   peak_reserved_gib=torch.cuda.max_memory_reserved(dev)
                   / 2**30, decode_traces=ceng.decode_traces)
        if mode == "graph":
            check(ceng.decode_traces == 1, f"graph engine: "
                  f"{ceng.decode_traces} keys for one sampling tier")
            run.update(graph_rounds(ceng, "graph engine"))
        else:
            check(ceng.round_program is None, "eager engine holds graphs")
        out.setdefault(mode, {}).update(run)
        tokens[mode], logits[mode] = np.stack(em), lg
        if probes:                       # the probe's own scratch
            pa.detach_scratch(dev, ceng.round_program.backend.stream
                              .cuda_stream)
        held_mib = (torch.cuda.memory_reserved(dev) - reserved0) / 2**20
        del ceng, handle
        gc.collect()
        torch.cuda.empty_cache()
        left_mib = (torch.cuda.memory_reserved(dev) - reserved0) / 2**20
        out[mode].update(reserved_mib_held=held_mib,
                         reserved_mib_left_after_drop=left_mib)
        # an engine's graphs and their pool go with it (a stray small
        # tensor elsewhere may hold one 2 MiB segment)
        check(mode == "eager" or left_mib <= MIB_LEFT_PER_ENGINE,
              f"{mode} engine: {left_mib:.1f} MiB still reserved after it "
              f"was dropped ({held_mib:.1f} MiB while it lived)")
    same = np.array_equal(tokens["eager"], tokens["graph"])
    diff = [float((a - b).abs().max())
            for a, b in zip(logits["eager"], logits["graph"])]
    out["tokens_identical"] = same
    out["max_logit_diff"] = max(diff)
    if not same:
        r, step, row = (int(i[0]) for i in np.nonzero(
            tokens["eager"] != tokens["graph"]))
        out["first_difference"] = dict(round=r, step=step, row=row,
                                       max_logit_diff_to_it=max(diff[:r + 1]))
    e, g = out["eager"], out["graph"]
    say("serve", f"{eng.cfg.name} rounds, eager against CUDA graph (8 rows, "
                 f"4 steps, {ROUNDS_COMPARED} rounds): tokens "
                 + ("identical" if same else
                    f"DIFFER first at {out['first_difference']}")
                 + f" (largest logit difference {out['max_logit_diff']:.3g});"
                 f" round ms median {e['round_ms_median']:.3f} / "
                 f"{g['round_ms_median']:.3f}, decode tokens/s "
                 f"{e['decode_tokens_per_s']:.1f} / "
                 f"{g['decode_tokens_per_s']:.1f}; host dispatch ms "
                 f"{e['host_dispatch_ms_median']:.2f} / "
                 f"{g['host_dispatch_ms_median']:.2f}; capture ms "
                 f"{g['capture_ms']} ({g['keys_captured']} key, "
                 f"{g['replays']} replays); first round "
                 f"{e['first_round_ms']:.1f} / {g['first_round_ms']:.1f} ms; "
                 f"peak {e['peak_gib']:.2f} / {g['peak_gib']:.2f} GiB "
                 f"(reserved {e['peak_reserved_gib']:.2f} / "
                 f"{g['peak_reserved_gib']:.2f}); K3 launches "
                 f"{e['k3_launches']} / {g['k3_launches']}; reserved MiB "
                 f"while it lived {e['reserved_mib_held']:.1f} / "
                 f"{g['reserved_mib_held']:.1f}, left after it was dropped "
                 f"{e['reserved_mib_left_after_drop']:.1f} / "
                 f"{g['reserved_mib_left_after_drop']:.1f}")
    for mode in ("eager", "graph"):
        p = out[mode]["profile"]
        say("serve", f"{eng.cfg.name} profiled {mode} round: " + (
            f"CUDA-event window {p['round_window_ms']:.2f} ms, host enqueue "
            f"{p['host_enqueue_ms']:.2f} ms, device busy "
            f"{p['device_busy_ms']:.2f} ms over {p['launches']} kernels "
            f"(idle {p['device_idle_share']:.1%} of this window, "
            f"{out[mode]['idle_share_of_median_round']:.1%} of the median "
            f"unprofiled round); by kernel: {p['top']}"
            if p["device_busy_ms"] is not None else
            f"CUDA-event window {p['round_window_ms']:.2f} ms, host enqueue "
            f"{p['host_enqueue_ms']:.2f} ms; the profiler recorded no device "
            "time"))
    say("serve", "no host synchronisation while a replayed round was "
                 "dispatched; every capture ran in the 'global' capture mode, "
                 "so no launch touched the legacy default stream")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the tenant-slot schedules: launch.serve at full width, overlapped (the
# default) against blocking -- 12 requests of 3 tenants, 4 a slot, so 3
# slots of 4 rows a run; then a stage-depth sweep on one warm engine
SLOT_ARGV = ["--no-reduced", "--tenants", "3", "--requests", "12",
             "--new-tokens", "32", "--max-batch", "4", "--stage-depth", "1"]
SLOT_ARCHS = (("internlm2-1.8b", 128), ("mamba2-2.7b", 384),
              ("olmoe-1b-7b", 1024))
STAGE_DEPTHS = (1, 2, 3)
# a warm dispatch's host ms, at most this share of a replayed slot's decode
# ms: a dispatch stalled behind the slot's loop takes about the whole slot
# (0.9-1.05 of it on an H100), the host-free path's median a third to a
# half (host times vary by half between machines)
DISPATCH_SHARE = 0.75
SWEEP_REQUESTS = 24          # 6 slots of 4: deeper than the deepest stage
SWEEP_PASSES = 2             # timed passes, the second in reverse order
MIB_LEFT_SLOTS = 4           # reserved after the sweep's engines are dropped


def serve_requests(cfg, n: int, tenants: int, prompt_len: int,
                   new_tokens: int) -> list:
    """The requests ``launch.serve`` submits with no shared prefix and no
    priority tiers (the same generator, the same draws)."""
    rng = np.random.default_rng(0)
    rng.integers(1, cfg.vocab_size, 0)          # the empty shared prefix
    return [Request(f"tenant-{i % tenants}",
                    rng.integers(1, cfg.vocab_size,
                                 prompt_len).astype(np.int32), new_tokens)
            for i in range(n)]


class SlotRecorder:
    """Records a slot schedule's work on an engine: every batch handed to
    ``dispatch`` or ``generate`` (prompts, steps, extra inputs), the host
    ms of each
    dispatch, and every ``GenerationResult`` in completion order (which is
    dispatch order).  ``install`` wraps the engine's methods, ``remove``
    restores them."""

    def __init__(self):
        self.batches, self.results, self.dispatch_ms = [], [], []

    def install(self, eng: ServingEngine) -> None:
        dispatch, await_result, generate = (eng.dispatch, eng.await_result,
                                            eng.generate)

        def rec_dispatch(prompts, steps, **kw):
            t0 = time.perf_counter()
            handle = dispatch(prompts, steps, **kw)
            self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            self.batches.append((np.array(prompts), steps,
                                 kw.get("extra_inputs")))
            return handle

        def rec_await(handle):
            res = await_result(handle)
            self.results.append(res)
            return res

        def rec_generate(prompts, steps, **kw):
            res = generate(prompts, steps, **kw)
            self.batches.append((np.array(prompts), steps,
                                 kw.get("extra_inputs")))
            self.results.append(res)
            return res

        eng.dispatch, eng.await_result, eng.generate = (
            rec_dispatch, rec_await, rec_generate)

    @staticmethod
    def remove(eng: ServingEngine) -> None:
        for name in ("dispatch", "await_result", "generate"):
            eng.__dict__.pop(name, None)

    def by_prompt(self, responses) -> dict:
        """prompt bytes -> tokens: the responses come back slot by slot in
        dispatch order, each slot's in its batch's row order."""
        rows = [row for prompts, *_ in self.batches for row in prompts]
        check(len(rows) == len(responses),
              f"{len(rows)} batch rows for {len(responses)} responses")
        return {row.tobytes(): r.tokens for row, r in zip(rows, responses)}

    def device_numbers(self) -> dict:
        """CUDA-event numbers of the recorded slots: prefill and decode ms a
        slot, decode tokens/s over the decode windows, the device gap from
        each slot's end to the next one's start, the device span.

        A slot's decode window opens when its prefill has ended and the
        previous slot's loop is done, whichever is later: a dispatched
        slot's loop queues behind the previous one on the program's
        stream, while its prefill runs beside it on another (a negative
        gap: the next prefill started before this slot's loop ended)."""
        ev = [r.events for r in self.results]
        check(all(e is not None for e in ev), "a slot has no CUDA events")
        ev[-1][2].synchronize()
        pre = [a.elapsed_time(b) for a, b, _ in ev]
        dec = [b.elapsed_time(c) - (max(0.0, b.elapsed_time(p[2])) if p
                                    else 0.0)
               for p, (_, b, c) in zip([None] + ev[:-1], ev)]
        gaps = [x[2].elapsed_time(y[0]) for x, y in zip(ev, ev[1:])]
        toks = [r.tokens.size for r in self.results]
        return dict(slots=len(ev), prefill_ms=pre, decode_ms=dec,
                    decode_tokens_per_s=sum(toks) / (sum(dec) * 1e-3),
                    # without the first slot (a fresh engine's capture)
                    decode_tokens_per_s_after_first=sum(toks[1:])
                    / (sum(dec[1:]) * 1e-3) if len(dec) > 1 else None,
                    gap_ms=gaps, gap_ms_max=max(gaps) if gaps else None,
                    device_span_ms=ev[0][0].elapsed_time(ev[-1][2]))


class SlotServeRecorder(SlotRecorder):
    """The ``observe`` hook of ``launch.serve.main`` in a slot mode: keeps
    the scheduler, its responses (in order), the serving wall from the
    first call (scheduler built, nothing submitted) to the last (the last
    step), the peak memory of the weights alone, and the engine's work."""

    def __init__(self):
        super().__init__()
        self.sched, self.responses = None, []
        self.t_first = self.t_last = 0.0
        self.init_peak_gib = None

    def __call__(self, sched) -> None:
        self.t_last = time.perf_counter()
        if self.sched is not None:
            return
        self.t_first = self.t_last
        self.init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        self.sched = sched
        self.install(sched.engine)
        step = sched.step

        def recording_step():
            r = step()
            self.responses.extend(r or [])
            return r

        sched.step = recording_step


def hold_staged_under_decode(tag: str, gaps_ms) -> None:
    """On the device clock: each slot after the capture slot began its
    prefill before the previous slot's loop ended, so the host staged it
    while the device decoded (a host stalled behind the loop starts it
    after)."""
    check(all(g < 0 for g in gaps_ms),
          f"{tag}: a slot's prefill began after the previous slot's loop "
          f"ended (gaps ms {gaps_ms})")


def hold_dispatch_share(tag: str, dispatch_ms: float,
                        decode_ms: float) -> None:
    """The host is free under a slot: a warm dispatch (prefill enqueue,
    copies, replay) returns in at most ``DISPATCH_SHARE`` of a replayed
    slot's decode, so the overlapped schedule stages the next batch while
    the device decodes."""
    check(dispatch_ms <= DISPATCH_SHARE * decode_ms,
          f"{tag}: a warm dispatch holds the host {dispatch_ms:.1f} ms, over "
          f"{DISPATCH_SHARE} of a slot's decode ({decode_ms:.1f} ms)")


def slot_launches() -> tuple:
    """The kernel counts of the serving path, and their plain calls."""
    return ({**fa.launch_counts, **ssd.launch_counts, **pa.launch_counts,
             **agg.launch_counts},
            {**fa.plain_counts, **ssd.plain_counts, **pa.plain_counts,
             **agg.plain_counts})


def serve_slots_once(arch: str, prompt_len: int, mode: str, dev,
                     num_layers=None, mesh=None) -> dict:
    """One ``launch.serve.main`` run of ``arch`` at full width (its first
    ``num_layers`` layers, if given; on ``--mesh mesh``, every position on
    the one card, if given) in a slot mode: checks and numbers; the
    overlapped run's tokens are held against ``generate`` on each of its
    padded batches, with the batch's patch embeddings."""
    cfg = arch_config(arch, num_layers)
    rec = SlotServeRecorder()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for m in (agg, pa, fa, ssd):
        m.reset_counts()                 # just before the serving path
    rc = serve_cli.main(["--arch", arch, "--prompt-len", str(prompt_len),
                         "--mode", mode] + SLOT_ARGV
                        + depth_argv(num_layers)
                        + (["--mesh", mesh] if mesh else []), observe=rec)
    launches, plains = slot_launches()   # just after
    variants = {K5: dict(fa.variant_counts), K6: dict(ssd.variant_counts)}
    check(rc == 0, f"serve {arch} {mode} returned {rc}")
    tag = f"{arch} {mode}" + (f" mesh {mesh}" if mesh else "")
    sched, eng = rec.sched, rec.sched.engine
    check(mesh is None or eng.sh.mesh.shape["model"]
          == int(mesh.split("x")[1]), f"{tag}: engine mesh {eng.sh.mesh}")
    SlotRecorder.remove(eng)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    resp = rec.responses
    check(len(resp) == 12 and all(r.tokens.shape == (32,) for r in resp),
          f"{tag}: {len(resp)} responses, token counts "
          f"{sorted({r.tokens.size for r in resp})}")
    check(all(0 <= int(r.tokens.min()) and int(r.tokens.max())
              < cfg.vocab_size for r in resp), f"{tag}: token out of vocab")
    check(sched.pending() == 0 and len(rec.results) == 3
          and all(b[0].shape == (4, prompt_len) for b in rec.batches),
          f"{tag}: {len(rec.results)} slots, batches "
          f"{[b[0].shape for b in rec.batches]}")
    # one prefill a slot: K5 once per attention layer (an encoder-
    # decoder's once per encoder layer and twice per decoder layer), K6
    # once per Mamba-2 layer (a hybrid arch both), every one on the tensor
    # cores
    n_attn = sum(mixer == "attn" for mixer, _ in cfg.block_schedule())
    n_ssm = cfg.num_layers - n_attn
    want = {k: n * 3 for k, n in ((K5, k5_per_prefill(cfg)), (K6, n_ssm))
            if n}
    check(all(launches[k] == n for k, n in want.items())
          and all(v == 0 for k, v in launches.items() if k not in want)
          and not any(plains.values()),
          f"{tag}: launches {launches} (expected {want}), plain calls "
          f"{plains}")
    for kname, n in want.items():
        check(variants[kname] == {"bf16_mma": n, "f32_simt": 0},
              f"{tag}: {kname} variants {variants[kname]}")
    ov = timeline_overlaps(sched.timeline)
    prog = eng.decode_program
    out = dict(wall_ms=(rec.t_last - rec.t_first) * 1e3,
               overlap_pairs=sum(ov), pairs=len(ov), peak_gib=peak,
               init_peak_gib=rec.init_peak_gib, launches=want,
               **rec.device_numbers())
    if mode == "overlapped":
        check(sum(ov) >= 1, f"{tag}: no overlap pair ({ov})")
        check(prog is not None and len(prog.loops) == 1
              and sum(c.replays for c in prog.loops.values()) == 2,
              f"{tag}: decode loops {list(prog.loops) if prog else None}")
        cap = next(iter(prog.loops.values()))
        out.update(keys=len(prog.loops), capture_ms=cap.capture_ms,
                   dispatch_ms=rec.dispatch_ms,
                   dispatch_ms_warm=float(np.median(rec.dispatch_ms[1:])))
        hold_staged_under_decode(tag, out["gap_ms"][1:])
        # the overlapped tokens against generate on the same padded batch
        got = rec.by_prompt(resp)
        for prompts, steps, extras in rec.batches:
            gen = ServingEngine.generate(eng, prompts, steps,
                                         extra_inputs=extras).tokens
            for p, row in zip(prompts, gen):
                check(np.array_equal(got[p.tobytes()], row),
                      f"{tag}: a request's tokens differ from generate on "
                      f"its padded batch ({got[p.tobytes()][:8]} / "
                      f"{row[:8]})")
    else:
        check(sum(ov) == 0, f"{tag}: {sum(ov)} overlap pairs, expected 0")
        check(prog is None, f"{tag}: the blocking run made graphs")
    out["tokens"] = rec.by_prompt(resp)
    say("serve-slots", f"{tag} full width through launch.serve: "
        + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in out.items()
                    if k not in ("tokens", "prefill_ms", "decode_ms",
                                 "gap_ms", "dispatch_ms"))
        + f"; prefill ms {[round(x, 2) for x in out['prefill_ms']]}, decode "
          f"ms {[round(x, 2) for x in out['decode_ms']]}, gaps ms "
          f"{[round(x, 4) for x in out['gap_ms']]}")
    del rec, sched, eng, prog
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_schedule(eng: ServingEngine, ceng, reqs, mode: str, depth: int,
                 dev) -> dict:
    """The requests through a scheduler built directly on a warm engine:
    serving wall (submit to drain), peak memory, and for the slot modes
    the slots' CUDA-event numbers, for continuous the rounds'."""
    rec, finished = SlotRecorder(), {}
    if mode != "continuous":
        rec.install(eng)
    else:
        collect = ceng.collect

        def recording_collect(handle):
            res = collect(handle)
            finished.update((r.prompt.tobytes(), t)
                            for r, t, _ in res.finished)
            return res

        ceng.collect = recording_collect
    rounds0, steps0 = (len(ceng.round_ms), ceng.row_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sched = MultiTenantScheduler(eng, max_batch=4,
                                 tenancy=TenancyConfig(1, 3), mode=mode,
                                 stage_depth=depth, continuous_engine=ceng)
    for r in reqs:
        sched.submit(Request(r.tenant, r.prompt.copy(), r.max_new_tokens))
    resp = sched.drain()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    SlotRecorder.remove(eng)
    ceng.__dict__.pop("collect", None)
    check(len(resp) == len(reqs)
          and all(r.tokens.shape == (32,) for r in resp),
          f"sweep {mode}: {len(resp)} responses")
    ov = timeline_overlaps(sched.timeline)
    out = dict(wall_ms=wall, overlap_pairs=sum(ov), pairs=len(ov),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    if mode == "continuous":
        rnd = ceng.round_ms[rounds0:]
        out.update(rounds=len(rnd), round_ms_median=float(np.median(rnd)),
                   decode_tokens_per_s=(ceng.row_steps - steps0)
                   / (sum(rnd) * 1e-3))
    else:
        out.update(rec.device_numbers())
        if rec.dispatch_ms:
            out["dispatch_ms_median"] = float(np.median(rec.dispatch_ms))
    out["tokens"] = finished if mode == "continuous" else rec.by_prompt(resp)
    return out


def phase_slot_sweep(dev) -> dict:
    """On one internlm2-1.8b engine at full width, 24 of ``launch.serve``'s
    requests: blocking, overlapped at stage depths 1, 2 and 3, and
    continuous (capacity 8, the serving main path's engine).  Every mode
    runs once to warm (the decode loop's key and the round's key are
    captured there, and timed apart), then ``SWEEP_PASSES`` timed passes,
    the second in reverse order; each overlapped pass holds its median
    dispatch to ``DISPATCH_SHARE`` of a slot's decode and every slot's
    prefill begun under the previous slot's decode.  Then one warm
    dispatch under ``set_sync_debug_mode("error")``, the keys held, and the
    reserved memory left once both engines are dropped."""
    cfg = get_config("internlm2-1.8b")
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    ceng = ContinuousBatchingEngine(eng, capacity=8, page_size=16,
                                    inner_steps=4, max_prompt_len=256,
                                    device=dev)
    reqs = serve_requests(cfg, SWEEP_REQUESTS, 3, 128, 32)
    modes = ([("blocking", 1)] + [("overlapped", d) for d in STAGE_DEPTHS]
             + [("continuous", 1)])
    name = lambda m, d: m if m != "overlapped" else f"overlapped depth {d}"
    warm = {name(m, d): run_schedule(eng, ceng, reqs, m, d, dev)
            for m, d in modes}
    prog = eng.decode_program
    check(prog is not None and len(prog.loops) == 1,
          f"sweep: decode loop keys {list(prog.loops) if prog else None}")
    capture_ms = next(iter(prog.loops.values())).capture_ms
    round_capture_ms = [c.capture_ms
                        for c in ceng.round_program.rounds.values()]
    timed = {name(m, d): [] for m, d in modes}
    for p in range(SWEEP_PASSES):
        for m, d in (modes if p % 2 == 0 else modes[::-1]):
            timed[name(m, d)].append(run_schedule(eng, ceng, reqs, m, d,
                                                  dev))
    same = lambda a, b: a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)
    base = warm["blocking"]["tokens"]
    check(len(base) == SWEEP_REQUESTS
          and all(same(v["tokens"], base) for k, v in warm.items()
                  if k != "continuous")
          and all(same(r["tokens"], warm[k]["tokens"])
                  for k, runs in timed.items() for r in runs),
          "sweep: the slot schedules' tokens differ between modes or runs")
    # agreement of continuous with the slot batches is a number (bf16
    # GEMMs of 8 slot rows against batches of 4)
    cont = warm["continuous"]["tokens"]
    check(cont.keys() == base.keys(), "sweep: continuous served other "
                                      "requests")
    cont_same = sum(np.array_equal(cont[k], base[k]) for k in base)
    for k, runs in timed.items():
        if k.startswith("overlapped"):
            check(all(r["overlap_pairs"] >= 1 for r in runs),
                  f"sweep {k}: no overlap pair")
            for r in runs:
                hold_dispatch_share(f"sweep {k}", r["dispatch_ms_median"],
                                    float(np.median(r["decode_ms"])))
                hold_staged_under_decode(f"sweep {k}", r["gap_ms"])
        if k == "blocking":
            check(all(r["overlap_pairs"] == 0 for r in runs),
                  "sweep blocking: overlap pairs")
    # one warm dispatch with any host synchronisation an error
    prompts = np.stack([r.prompt for r in reqs[:4]])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        handle = eng.dispatch(prompts, 32)
        sync_free_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        raise PhaseFailed(f"a warm dispatch synchronised the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.await_result(handle)
    check(len(prog.loops) == 1, "the sync-checked dispatch made a new key")
    keys = len(prog.loops)
    held_mib = (torch.cuda.memory_reserved(dev) - reserved0) / 2**20
    del eng, ceng, prog, handle
    gc.collect()
    torch.cuda.empty_cache()
    left_mib = (torch.cuda.memory_reserved(dev) - reserved0) / 2**20
    check(left_mib <= MIB_LEFT_SLOTS,
          f"sweep: {left_mib:.1f} MiB still reserved after the engines "
          f"were dropped ({held_mib:.1f} MiB while they lived)")
    summary = {}
    for k, runs in timed.items():
        med = lambda f: float(np.median([r[f] for r in runs if f in r])) \
            if any(f in r for r in runs) else None
        summary[k] = dict(wall_ms=[r["wall_ms"] for r in runs],
                          wall_ms_median=med("wall_ms"),
                          decode_tokens_per_s=med("decode_tokens_per_s"),
                          gap_ms_max=med("gap_ms_max"),
                          dispatch_ms_median=med("dispatch_ms_median"),
                          device_span_ms=med("device_span_ms"),
                          round_ms_median=med("round_ms_median"),
                          overlap_pairs=[r["overlap_pairs"] for r in runs],
                          pairs=runs[0]["pairs"],
                          peak_gib=max(r["peak_gib"] for r in runs))
        say("serve-slots", f"sweep {k} (internlm2-1.8b, {SWEEP_REQUESTS} "
            f"requests, warm): " + ", ".join(
                f"{a}={v:.4g}" if isinstance(v, float) else f"{a}={v}"
                for a, v in summary[k].items()))
    out = dict(modes=summary, capture_ms=capture_ms,
               round_capture_ms=round_capture_ms, keys_held=keys,
               sync_checked_dispatch_ms=sync_free_ms,
               continuous_requests_equal_to_slots=cont_same,
               reserved_mib_held=held_mib,
               reserved_mib_left_after_drop=left_mib)
    say("serve-slots", f"sweep: decode loop capture {capture_ms:.1f} ms "
        f"(round capture {round_capture_ms} ms), {keys} key held; a warm "
        f"dispatch under set_sync_debug_mode('error') in {sync_free_ms:.2f} "
        f"ms; continuous gives the slot schedules' tokens for "
        f"{cont_same} "
        f"of {SWEEP_REQUESTS} requests; reserved {held_mib:.1f} MiB while "
        f"the engines lived, {left_mib:.1f} MiB after they were dropped")
    return out


def phase_serve_slots(dev) -> dict:
    """The tenant-slot path: ``launch.serve.main`` at full width for
    internlm2-1.8b, mamba2-2.7b and olmoe-1b-7b, overlapped then blocking
    (token-identical, overlap pairs >= 1 and 0, K5 or K6 on every prefill,
    each replayed slot's prefill begun under the previous slot's decode);
    then the internlm2 sweep on one warm engine."""
    out, launches = {}, {}
    for arch, prompt_len in SLOT_ARCHS:
        runs = {m: serve_slots_once(arch, prompt_len, m, dev)
                for m in ("overlapped", "blocking")}
        a, b = (runs[m].pop("tokens") for m in ("overlapped", "blocking"))
        check(len(a) == 12 and a.keys() == b.keys()
              and all(np.array_equal(a[k], b[k]) for k in a),
              f"{arch}: overlapped and blocking tokens differ")
        launches[arch] = {k: runs["overlapped"]["launches"].get(k, 0)
                          + runs["blocking"]["launches"].get(k, 0)
                          for k in (K5, K6)}
        out[arch] = runs
        o, b = runs["overlapped"], runs["blocking"]
        say("serve-slots", f"{arch}: overlapped and blocking token-identical"
            f" and equal to generate; wall ms {o['wall_ms']:.1f} / "
            f"{b['wall_ms']:.1f}, decode tokens/s after the first slot "
            f"{o['decode_tokens_per_s_after_first']:.1f} / "
            f"{b['decode_tokens_per_s_after_first']:.1f}, device gap between "
            f"slots ms {o['gap_ms']} / {b['gap_ms']}")
    out["sweep"] = phase_slot_sweep(dev)
    return {"runs": out, "launches": launches}


# ---------------------------------------------------------------------------
# serve-archs: the four remaining decoder-only archs at their published
# widths through launch.serve.  (arch, --num-layers or None for every
# layer, prompt length, modes); the depth cuts take a prefix of the
# published block schedule so that the weights fit one card: mistral-large
# 16 of 88 layers (45.9 GB of bf16 weights); jamba layers 0-4 (Mamba-2 at
# 0-3, attention at 4, MoE at 1 and 3: 48.0 GB -- one whole 8-layer period
# is 90.3 GB, so the 1:7 ratio is not kept); llama4 2 of 48 (69.3 GB, 128
# experts a layer); llava whole (29.0 GB float32, 14.5 GB cast to bf16)
ARCH_RUNS = (("mistral-large-123b", 16, 512, ("continuous",)),
             ("jamba-1.5-large-398b", 5, 1024, ("continuous", "overlapped")),
             ("llama4-maverick-400b-a17b", 2, 512, ("continuous",)),
             ("llava-next-mistral-7b", None, 640,
              ("continuous", "overlapped")))
ARCHS_ARGV = ["--no-reduced", "--tenants", "3", "--requests", "12",
              "--new-tokens", "32", "--capacity", "8", "--page-size", "16",
              "--inner-steps", "4", "--shared-prefix-len", "0"]
# per-step logits of the continuous engine against generate's arithmetic
# (the same padded prompts, fed the continuous engine's tokens): steps
# compared, and the bound on max |difference| / max |logit| of a row.  The
# two decode the same bf16 weights and K/V through different attention
# reads (the paged kernel's split online softmax against the dense
# einsum), whose float32 sums differ in their last bits; every bf16 cast
# downstream (the attention output, each projection and the residual
# stream, several a layer) can then round one ulp apart, 2^-8 = 0.39 % of
# a value, and the differences add up over 16 / 32 layers and 8 steps.  A
# fault in a row's cache, position or page (the wrong token's K/V) moves
# the logits by their own size, not by a few percent
LOGIT_STEPS = 8
LOGIT_BF16_TOL = 5e-2
# K3 at the four archs' decode shapes: (arch, query heads, kv heads, pages
# named a row = prompt / 16); the table is the path's, twice as wide
PAGED_LAYOUTS = (("mistral-large-123b", 96, 8, 32),
                 ("jamba-1.5-large-398b", 64, 8, 64),
                 ("llama4-maverick-400b-a17b", 40, 8, 32),
                 ("llava-next-mistral-7b", 32, 8, 40))


def k5_per_prefill(cfg) -> int:
    """FlashAttention launches of one prefill: one per attention layer; an
    encoder-decoder's per encoder layer and twice per decoder layer (its
    self-attention and its cross-attention)."""
    if cfg.enc_dec:
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return sum(mixer == "attn" for mixer, _ in cfg.block_schedule())


def arch_config(arch: str, num_layers=None):
    """The published config, cut to its first ``num_layers`` layers as
    ``launch.serve --num-layers`` cuts it."""
    cfg = get_config(arch)
    return (dataclasses.replace(cfg, num_layers=num_layers) if num_layers
            else cfg)


def depth_argv(num_layers) -> list:
    return ["--num-layers", str(num_layers)] if num_layers else []


def decode_bytes(eng: ServingEngine, rows: int) -> int:
    """Bytes a decode step reads at least: every leaf of the blocks once
    (every expert's too: the MoE product runs over all of them) and the
    unembedding; the embedding table's few rows and the patch projection
    (prefill only) left out.  An encoder-decoder's step reads its decoder
    (not the encoder, nor the cross K/V projections, which run at
    admission) and each of ``rows`` rows' cross K/V of every decoder
    layer."""
    cfg, params = eng.cfg, eng.params
    skip = ("embed", "mm_proj", "enc_stages", "enc_norm")
    leaves = []
    tree_map(leaves.append, {k: v for k, v in params.items()
                             if k not in skip})
    if cfg.enc_dec:
        leaves = [t for t in leaves if not any(
            t is params["dec_stages"]["cross"][w] for w in ("wk", "wv"))]
    leaves.append(unembed_operand(params["embed"], cfg))
    n = sum(t.numel() * t.element_size() for t in leaves)
    if cfg.enc_dec:
        n += cross_read_bytes(cfg, rows)
    return n


def cross_read_bytes(cfg, rows: int) -> int:
    """A decode step's cross K/V reads: every row's ``encoder_seq_len``
    keys and values of every decoder layer, in the compute dtype."""
    elt = torch.finfo(dtype_of(cfg.compute_dtype)).bits // 8
    return (rows * cfg.num_layers * 2 * cfg.encoder_seq_len
            * cfg.num_kv_heads * cfg.head_dim * elt)


def logits_against_generate(eng: ServingEngine, prompt_len: int, dev
                            ) -> dict:
    """Each step's logits of the continuous engine (8 rows, one decode step
    a round, rounds as graphs) against ``generate``'s arithmetic on the
    same padded prompts -- its prefill and ``decode_fn`` at width 8 -- fed
    the tokens the continuous engine emitted, so a token that parts does
    not end the comparison.  Held at ``LOGIT_BF16_TOL``."""
    cfg = eng.cfg
    rng = np.random.default_rng(12)
    reqs = [Request("l", rng.integers(1, cfg.vocab_size, prompt_len).astype(
        np.int32), LOGIT_STEPS + 1,
        extra_inputs=serve_cli.synth_extra_inputs(cfg, rng) or None)
        for _ in range(8)]
    ceng = ContinuousBatchingEngine(eng, capacity=8, page_size=16,
                                    inner_steps=1,
                                    max_prompt_len=2 * prompt_len,
                                    device=dev)
    check(all(ceng.try_admit_batch(reqs)) and ceng.prefill_calls == 1,
          "logits: the 8 requests were not admitted in one prefill")
    rows = torch.tensor([next(c for c, s in enumerate(ceng._slots)
                              if s is not None and s.req is r)
                         for r in reqs], device=dev)
    got, emitted = [ceng.state["logits"][rows].clone()], []
    for _ in range(LOGIT_STEPS):
        h = ceng.dispatch_round()
        ceng.collect(h)
        emitted.append(h.emitted[0].to(dev)[rows])
        got.append(ceng.state["logits"][rows].clone())
    extras = None
    if reqs[0].extra_inputs:
        extras = {k: np.stack([r.extra_inputs[k] for r in reqs])
                  for k in reqs[0].extra_inputs}
    V = cfg.vocab_size

    def dense(rows):
        """generate's arithmetic on requests ``rows`` as one batch, fed
        the emitted tokens: the logits of each step."""
        sub = [reqs[i] for i in rows]
        ex = None if extras is None else {k: v[rows]
                                          for k, v in extras.items()}
        with torch.no_grad():
            logits, caches, idx = eng.prefill(eng._make_batch(
                np.stack([r.prompt for r in sub]), ex))
            out = [logits]
            for t, tok in enumerate(emitted):
                logits, caches = eng.bundle.decode_fn(
                    eng.params, tok[rows, None].to(torch.int32), caches,
                    idx + t)
                out.append(logits)
        return out

    def rel_err(a, b):
        return [float(((x[:, :V] - y[:, :V]).abs().amax(dim=1)
                       / y[:, :V].abs().amax(dim=1)).max())
                for x, y in zip(a, b)]

    want = dense(list(range(8)))
    rel = rel_err(got, want)
    # the scale of rounding alone: the same dense arithmetic on the first
    # two requests at width 2 against their rows at width 8 (other GEMM
    # shapes, nothing else)
    scale = rel_err(dense([0, 1]), [w[:2] for w in want])
    agree = float(np.mean([bool(torch.equal(g[:, :V].argmax(1),
                                            w[:, :V].argmax(1)))
                           for g, w in zip(got, want)]))
    check(rel[0] == 0.0, f"{cfg.name}: the continuous engine's prefill "
                         f"logits differ from generate's ({rel[0]:.3g})")
    check(max(rel) <= LOGIT_BF16_TOL,
          f"{cfg.name}: a step's logits differ from generate's by "
          f"{max(rel):.3g} of the row's largest (bound {LOGIT_BF16_TOL}); "
          f"by step {[round(x, 4) for x in rel]}")
    del ceng
    return dict(steps=LOGIT_STEPS, rel_err_by_step=rel,
                rel_err_max=max(rel), argmax_same_share=agree,
                bound=LOGIT_BF16_TOL, rounding_scale_by_step=scale,
                rounding_scale_max=max(scale))


def hybrid_repeat(eng: ServingEngine, prompt_len: int, dev) -> dict:
    """A prompt repeated after its slot retired, on a hybrid arch (or with
    the same frames, on the encoder-decoder): its chain is still registered
    (pristine pages kept), yet it is prefilled again -- its SSM state is
    neither paged nor cached, its cross pages went with its slot -- and
    decodes the first admission's tokens; its attention pages are
    shared."""
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, eng.cfg.vocab_size, prompt_len).astype(np.int32)
    extra = serve_cli.synth_extra_inputs(eng.cfg, rng) or None
    ceng = ContinuousBatchingEngine(eng, capacity=1, page_size=16,
                                    inner_steps=4,
                                    max_prompt_len=2 * prompt_len,
                                    preserve_pristine="always", device=dev)
    first = ceng.run_all([Request("a", prompt, 8, extra_inputs=extra)])[0][1]
    again = ceng.run_all([Request("a", prompt.copy(), 8,
                                  extra_inputs=extra)])[0][1]
    out = dict(prefill_calls=ceng.prefill_calls,
               prefill_skips=ceng.prefill_skips,
               pages_shared=ceng.kv.pages_shared,
               same_tokens=bool(np.array_equal(first, again)))
    check(out["prefill_skips"] == 0 and out["prefill_calls"] == 2
          and out["pages_shared"] > 0 and out["same_tokens"],
          f"{eng.cfg.name}: the repeated prompt {out}")
    ceng.assert_conserved()
    del ceng
    return out


def serve_arch_continuous(errs: Errors, arch: str, num_layers, prompt_len,
                          dev, phase: str = "serve-archs") -> dict:
    """One arch through ``launch.serve.main --mode continuous`` at full
    width: 12 requests of 3 tenants, capacity 8.  Held: each kernel's
    launches by the arch's sub-layers (K5 and K6 per prefill, K3 per decode
    step, K4 per admission, one launch a sub-layer each), none plain, K5
    and K6 on the tensor cores; tokens in the vocabulary, logits finite,
    every state kind conserved; K3 on a live round's pool and table.  Then
    per-step logits against ``generate`` (no MoE), or the repeated prompt
    (the hybrid), and rounds eager against graph."""
    cfg = arch_config(arch, num_layers)
    weights, init_reckoned = init_footprint(cfg)
    rec = ServeRecorder()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for m in (agg, pa, fa, ssd):
        m.reset_counts()                 # just before the serving path
    t0 = time.perf_counter()
    rc = serve_cli.main(["--arch", arch, "--mode", "continuous",
                         "--prompt-len", str(prompt_len)] + ARCHS_ARGV
                        + depth_argv(num_layers), observe=rec)
    wall = time.perf_counter() - t0
    launches, plains = slot_launches()   # just after
    variants = {K5: dict(fa.variant_counts), K6: dict(ssd.variant_counts)}
    check(rc == 0, f"serve {arch} returned {rc}")
    sched, eng = rec.sched, rec.sched.continuous_engine
    tag = f"{arch} continuous"
    check(len(rec.finished) == 12 and all(t.shape == (32,)
                                          for _, t in rec.finished),
          f"{tag}: {len(rec.finished)} requests finished, token counts "
          f"{sorted({t.size for _, t in rec.finished})}")
    check(all(int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
              for _, t in rec.finished), f"{tag}: token out of vocab")
    check(eng.nonfinite_rows == 0, f"{tag}: non-finite logits")
    check(eng.active_count() == 0 and sched.pending() == 0,
          f"{tag}: rows left after the drain")
    eng.assert_conserved()
    if eng.cross_blocks:
        # every request's row of cross pages taken once and given back
        n_cross = len(rec.finished) * eng.cross_blocks
        check(eng.kv.cross_pages_allocated == eng.kv.cross_pages_freed
              == n_cross, f"{tag}: cross pages allocated "
              f"{eng.kv.cross_pages_allocated}, freed "
              f"{eng.kv.cross_pages_freed}, expected {n_cross}")
    n_attn = eng.n_stages * len(eng.kv.attn_subs)
    n_ssm = eng.n_stages * len(eng.ssm_subs)
    # an admission writes each attention sub-layer's pages in one launch,
    # and an encoder-decoder's cross K and V pages in one launch each
    want = {K5: k5_per_prefill(cfg) * eng.prefill_calls,
            K3: n_attn * eng.rounds * eng.inner_steps,
            K4: (len(eng.kv.attn_subs) + 2 * bool(eng.cross_blocks))
            * (len(rec.finished) - eng.prefill_skips),
            K6: n_ssm * eng.prefill_calls}
    want = {k: n for k, n in want.items() if n}
    check(n_attn + n_ssm == cfg.num_layers
          and all(launches[k] == n for k, n in want.items())
          and all(v == 0 for k, v in launches.items() if k not in want)
          and not any(plains.values()),
          f"{tag}: launches {launches}, expected {want} "
          f"({eng.prefill_calls} prefill calls, {eng.rounds} rounds of "
          f"{eng.inner_steps} steps), plain calls {plains}")
    for k in (K5, K6):
        check(variants[k] == {"bf16_mma": want.get(k, 0), "f32_simt": 0},
              f"{tag}: {k} variants {variants[k]}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    s = rec.snap
    check(s is not None, f"{tag}: no live round was observed")
    q = torch.randn((eng.capacity, cfg.num_heads, cfg.head_dim),
                    device=dev).to(torch.bfloat16)
    errs.hold(K3, *decode_pair((q, s["k_pool"], s["v_pool"], s["pos_pool"],
                                s["page_table"], s["positions"])),
              f"{tag}: a live round's pool and table (GQA "
              f"{cfg.num_heads}:{cfg.num_kv_heads})")
    pre, rnd = eng.prefill_ms(), eng.round_ms
    floor = decode_bytes(eng.engine, eng.capacity) / PEAK_BYTES_PER_S * 1e3
    run = dict(
        layers=cfg.num_layers, weights_gb=weights / 1e9,
        init_peak_reckoned_gb=init_reckoned / 1e9,
        init_peak_gib=rec.init_peak_gib, init_s=rec.t_first - t0,
        wall_s=wall, prefill_calls=len(pre), prefill_ms=pre,
        rounds=len(rnd), round_ms_median=float(np.median(rnd)),
        decode_tokens=eng.row_steps,
        decode_tokens_per_s=eng.row_steps / (sum(rnd) * 1e-3),
        decode_step_floor_ms=floor, occupancy=eng.occupancy(),
        peak_gib=peak, pages_allocated=eng.kv.pages_allocated,
        prefill_skips=eng.prefill_skips, launches=want,
        **graph_rounds(eng, tag))
    moe = ContinuousBatchingEngine.supported_modes(cfg)[
        "continuous"]["exactness"] == "statistical"
    if not moe:
        run["logits"] = logits_against_generate(eng.engine, prompt_len, dev)
    else:
        # capacity routing couples rows: agreement with generate on the
        # same prompts (widths differ) is a number
        prompts = np.stack([r.prompt for r, _ in rec.finished])
        gen = eng.engine.generate(prompts, max_new_tokens=32).tokens
        got = np.stack([t for _, t in rec.finished])
        run["token_agreement"] = float((got == gen).mean())
    if eng.cross_blocks:
        run.update(cross_blocks=eng.cross_blocks,
                   cross_pages_allocated=eng.kv.cross_pages_allocated,
                   cross_pages_freed=eng.kv.cross_pages_freed,
                   cross_read_mb_per_step=cross_read_bytes(
                       cfg, eng.capacity) / 1e6)
    if (n_ssm and n_attn) or eng.cross_blocks:
        run["repeat"] = hybrid_repeat(eng.engine, prompt_len, dev)
    say(phase, f"{tag} ({cfg.num_layers} layers) through "
        "launch.serve: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in run.items() if k != "prefill_ms")
        + f", prefill ms {[round(x, 2) for x in pre]}")
    run["rounds_compared"] = compare_rounds(eng.engine, dev,
                                            prompt_len=prompt_len)
    del rec, sched, eng, s, q
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_paged_layouts(errs: Errors, dev) -> dict:
    """The paged decode kernel at the four archs' decode shapes (GQA 12:1,
    8:1, 5:1, 4:1 at D 128; capacity 8, the path's table of twice the
    prompt's pages, SENTINEL past them), held against its plain version,
    each row alone bit-identical with its batch, timed beside its bound."""
    rng = np.random.default_rng(14)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    C, D, P = 8, 128, 16
    out = {}
    for arch, H, Hkv, named in PAGED_LAYOUTS:
        st = rand_paged_state(rng, C=C, NB=named, P=P, H=H, Hkv=Hkv, D=D,
                              dev=dev, q_dtype=torch.bfloat16, full=True)
        pad = torch.full((C, named), PagedKVCache.SENTINEL,
                         dtype=torch.int32, device=dev)
        state = st[:4] + (torch.cat([st[4], pad], dim=1),) + st[5:]
        what = f"{arch} shape: GQA {H}:{Hkv}, {named} pages a row"
        errs.hold(K3, *decode_pair(state), what)
        check(rows_alone_match(state), f"{what}: a row decoded alone "
                                       "differs from its batch")
        ms = cuda_ms(lambda: pa.paged_attention_decode(*state), 50, flush)
        plain = cuda_ms(lambda: pa.paged_attention_decode_plain(*state), 10,
                        flush)
        bound, by = decode_bound_ms(C, named, P, H, Hkv, D, 2)
        shape = (f"q ({C}, {H}, {D}) bf16, pools ({st[1].shape[0]}, {P}, "
                 f"{Hkv}, {D}) bf16, table ({C}, {2 * named}), {named} pages "
                 "named a row")
        say("paged", f"decode at {arch}'s shape {shape}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, bound {bound:.4f} ms by {by}")
        out[arch] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         shape=shape)
        del st, state
    return out


def phase_serve_archs(errs: Errors, dev) -> dict:
    """serve-archs: mistral-large-123b, jamba-1.5-large-398b,
    llama4-maverick-400b-a17b and llava-next-mistral-7b at their published
    widths (``ARCH_RUNS``' depth cuts) through ``launch.serve.main``, bf16,
    random weights from seed 0: each continuous (``serve_arch_continuous``),
    jamba and llava also overlapped (the serve driver's default: the
    decode loop one graph, over both state kinds for jamba; llava's tenant
    batches carrying patch embeddings).  Then K3, K5 and K6 held at the
    archs' shapes."""
    out, launches = {}, {}
    for arch, layers, prompt_len, modes in ARCH_RUNS:
        t0 = time.perf_counter()
        runs = {"continuous": serve_arch_continuous(errs, arch, layers,
                                                    prompt_len, dev)}
        launches[arch] = runs["continuous"]["launches"]
        if "overlapped" in modes:
            o = serve_slots_once(arch, prompt_len, "overlapped", dev,
                                 num_layers=layers)
            o.pop("tokens")
            runs["overlapped"] = o
            launches[f"{arch} slots"] = o["launches"]
        out[arch] = runs
        say("serve-archs", f"{arch}: {time.perf_counter() - t0:.1f} s")
    out["paged_layouts"] = phase_paged_layouts(errs, dev)
    out["ssd_jamba"] = ssd_shapes(errs, dev, SSD_JAMBA, (8, 4),
                                  two_tilings=False)
    return {"runs": out, "launches": launches}


# ---------------------------------------------------------------------------
# serve-whisper: the encoder-decoder arch at its published width and depth
# (6 + 6 layers, d_model 512, 8 heads of 64, 1,500 encoder frames); prompts
# of 64 tokens, so that prompt and output stay inside whisper's 448-token
# text context
WHISPER = "whisper-base"
WHISPER_PROMPT = 64
# K5 at whisper's prefill shapes, the continuous path's width 8 and a
# slot's width 4: (name, B, Sq, Skv, Hq, Hkv, D, causal)
WHISPER_FLASH = [(f"{WHISPER} {part} width {b}", b, sq, skv, 8, 8, 64, causal)
                 for part, sq, skv, causal in (
                     ("encoder", 1500, 1500, False),
                     ("cross", WHISPER_PROMPT, 1500, False),
                     ("decoder self", WHISPER_PROMPT, WHISPER_PROMPT, True))
                 for b in (8, 4)]


def whisper_paged(errs: Errors, dev) -> dict:
    """K3 and K4 at whisper's serving shapes, held against their plain
    versions and timed beside their bounds: the decode read at group size
    1, D 64 (8 rows, the prompt's 4 pages named of the path's 8-entry
    table); the admission of one request's self pages (a 64-token ring, 4
    pages of 16 KB blocks in 6 stages) and of its cross pages (the
    1,500-frame K or V zero-padded to 94 pages, in 6 stages)."""
    rng = np.random.default_rng(15)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    cfg = get_config(WHISPER)
    C, H, Hkv, D, P = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16
    S, named, NB = cfg.num_layers, WHISPER_PROMPT // P, 2 * WHISPER_PROMPT // P
    out = {}
    st = rand_paged_state(rng, C=C, NB=named, P=P, H=H, Hkv=Hkv, D=D,
                          dev=dev, q_dtype=torch.bfloat16, full=True)
    pad = torch.full((C, NB - named), PagedKVCache.SENTINEL,
                     dtype=torch.int32, device=dev)
    state = st[:4] + (torch.cat([st[4], pad], dim=1),) + st[5:]
    what = f"{WHISPER} shape: group 1, D {D}, {named} pages named a row"
    errs.hold(K3, *decode_pair(state), what)
    check(rows_alone_match(state), f"{what}: a row decoded alone differs "
                                   "from its batch")
    ms = cuda_ms(lambda: pa.paged_attention_decode(*state), 50, flush)
    plain = cuda_ms(lambda: pa.paged_attention_decode_plain(*state), 10,
                    flush)
    bound, by = decode_bound_ms(C, named, P, H, Hkv, D, 2)
    shape = (f"q ({C}, {H}, {D}) bf16, pools ({st[1].shape[0]}, {P}, {Hkv}, "
             f"{D}) bf16, table ({C}, {NB}), {named} pages named a row")
    say("paged", f"decode at {WHISPER}'s shape {shape}: {ms:.4f} ms, plain "
                 f"{plain:.4f} ms, bound {bound:.4f} ms by {by}")
    out[K3] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                   shape=shape)
    del st, state

    # the self pages: paged_admit_kv, as admission calls it
    NP_ = PagedKVCache.RESERVED + C * NB
    pages = rng.permutation(np.arange(PagedKVCache.RESERVED,
                                      NP_))[:named].tolist()
    case = admission_case(rng, S, NP_, P, Hkv, D, pages, WHISPER_PROMPT,
                          torch.bfloat16, dev)
    hold_admission(errs, case, f"{WHISPER} self pages: {named} pages of "
                               f"{P * Hkv * D * 2} B blocks, {S} stages")
    ms = cuda_ms(lambda: pa.paged_admit_kv(*case), 50, flush)
    plain = cuda_ms(lambda: pa.paged_admit_kv_plain(*case), 20, flush)
    bound = admission_bound_ms(S, named, P, Hkv * D, WHISPER_PROMPT, 2)
    shape = (f"admission: pools 2 x ({S}, {NP_}, {P}, {Hkv}, {D}) bf16, "
             f"{named} pages, ring {WHISPER_PROMPT}, bf16 sources, positions")
    say("paged", f"{WHISPER} {shape}: {ms:.4f} ms, plain {plain:.4f} ms, "
                 f"bound {bound:.4f} ms")
    out[f"{K4} self"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                             bound_by="bytes", shape=shape)
    del case

    # the cross pages: paged_prefill_scatter of the padded frames' K (or
    # V), as admission's paged_admit_cross calls it
    nbc = -(-cfg.encoder_seq_len // P)
    NPc = PagedKVCache.RESERVED + C * nbc
    pool = torch.zeros((S, NPc, P, Hkv, D), dtype=torch.bfloat16, device=dev)
    cpages = torch.from_numpy(rng.permutation(np.arange(
        PagedKVCache.RESERVED, NPc))[:nbc].astype(np.int32)).to(dev)
    dense = torch.randn((S, cfg.encoder_seq_len, Hkv, D),
                        device=dev).to(torch.bfloat16)
    values = torch.nn.functional.pad(
        dense, (0, 0, 0, 0, 0, nbc * P - cfg.encoder_seq_len)).reshape(
        S, nbc, P, Hkv, D)
    errs.hold_bits(K4, *scatter_pair(pool, cpages, values),
                   f"{WHISPER} cross pages: {nbc} pages, {S} stages")
    long_pages = cpages.long()
    ms = cuda_ms(lambda: pa.paged_prefill_scatter(pool, cpages, values), 50,
                 flush)
    plain = cuda_ms(lambda: pa.paged_prefill_scatter_plain(pool, cpages,
                                                           values),
                    20, flush)
    lib = cuda_ms(lambda: pool.index_copy_(1, long_pages, values), 20, flush)
    bound = scatter_bound_ms(S, nbc, P * Hkv * D, 2)
    shape = (f"scatter: pool ({S}, {NPc}, {P}, {Hkv}, {D}) bf16, {nbc} "
             f"pages, bf16 values ({S}, {nbc}, {P}, {Hkv}, {D})")
    say("paged", f"{WHISPER} cross {shape}: {ms:.4f} ms, plain {plain:.4f} "
                 f"ms, index_copy_ {lib:.4f} ms, bound {bound:.4f} ms")
    out[f"{K4} cross"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bound, bound_by="bytes", shape=shape)
    return out


def phase_serve_whisper(errs: Errors, dev) -> dict:
    """serve-whisper: whisper-base at its published width and depth, bf16,
    random weights from seed 0, through ``launch.serve.main``: continuous
    (``serve_arch_continuous``: launches by sub-layer -- K5 per encoder
    layer and twice per decoder layer a prefill, K3 per decoder layer a
    step, K4 three a admission: the self pages, the cross K, the cross V
    --, the pool and the cross space conserved, every request's cross row
    taken and given back, each step's logits against ``generate``'s, the
    repeated prompt with its frames prefilled again, rounds eager against
    graph), then overlapped (tokens equal to ``generate`` per batch).
    Then K3, K4 and K5 held and timed at whisper's shapes."""
    t0 = time.perf_counter()
    runs = {"continuous": serve_arch_continuous(errs, WHISPER, None,
                                                WHISPER_PROMPT, dev,
                                                phase="serve-whisper")}
    o = serve_slots_once(WHISPER, WHISPER_PROMPT, "overlapped", dev)
    o.pop("tokens")
    runs["overlapped"] = o
    cont = runs["continuous"]
    comp = cont["rounds_compared"]
    step_floor = cont["decode_step_floor_ms"]
    say("serve-whisper", f"{WHISPER}: prefill ms (encoder included) "
        f"{[round(x, 3) for x in cont['prefill_ms']]}; replayed round "
        f"{comp['graph']['round_ms_median']:.3f} ms, eager round "
        f"{comp['eager']['round_ms_median']:.3f} ms, against a floor of "
        f"{4 * step_floor:.4f} ms a round of 4 steps (weights and "
        f"{cont['cross_read_mb_per_step']:.1f} MB of cross K/V a step at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s); capture ms "
        f"{comp['graph']['capture_ms']}; peak {cont['peak_gib']:.2f} GiB "
        f"continuous, {o['peak_gib']:.2f} GiB overlapped")
    # where a width-8 prefill's time goes, on an engine of its own (the
    # served one went with its run)
    cfg = get_config(WHISPER)
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    runs["profile_prefill"] = profile_prefill(eng, dev, 8, WHISPER_PROMPT)
    del eng
    kern = {"paged": whisper_paged(errs, dev)}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    kern["flash"] = {name: flash_timed(errs, dev, name, *shape, flush)
                     for name, *shape in WHISPER_FLASH}
    del flush
    say("serve-whisper", f"{time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "kernels": kern,
            "launches": {WHISPER: cont["launches"],
                         f"{WHISPER} slots": o["launches"]}}


# ---------------------------------------------------------------------------
# serve-overload: a tier-0 burst against a slot table full of tier-1 rows
# (priority admission, swap preemption, shedding past max_backlog), then the
# same traffic under injected faults; each arch's victims held to the same
# requests run without preemption in the same engine
OVERLOAD_ARCHS = (("internlm2-1.8b", 128), ("mamba2-2.7b", 128),
                  (WHISPER, WHISPER_PROMPT))
OVERLOAD_CAPACITY = 8
OVERLOAD_NEW = 96            # a tier-1 row's tokens
OVERLOAD_HI_NEW = 24         # a tier-0 row's tokens
OVERLOAD_BURST = 4           # tier-0 requests of the burst
OVERLOAD_LATE = 4            # tier-1 requests arriving with it
OVERLOAD_BACKLOG = 4         # max_backlog: the burst and the late rows
#                              queue 8, so 4 are shed
OVERLOAD_FAULTS = dict(drop_round_every=5, stall_admission_every=3,
                       poison_swap_every=4)
OVERLOAD_CHECKED = 4         # restores held bit for bit against their
#                              snapshots, per arch and run


def overload_traffic(cfg, prompt_len: int, seed: int,
                     new=None, hi_new=None) -> dict:
    """The requests of one overload run (fresh objects each call, the same
    draws for one seed): 8 tier-1 rows -- greedy, seeded temperature, and
    temperature with top-k 20 -- the tier-0 burst and the late tier-1
    rows, each with its own tenant."""
    rng = np.random.default_rng(seed)
    new, hi_new = new or OVERLOAD_NEW, hi_new or OVERLOAD_HI_NEW

    def mk(tag, i, prio, n, sampled):
        kw = {}
        if sampled:
            kw = dict(temperature=0.8, seed=100 + i,
                      top_k=20 if i % 4 == 3 else 0)
        return Request(f"{tag}{i}", rng.integers(
            1, cfg.vocab_size, prompt_len).astype(np.int32), n,
            priority=prio, extra_inputs=serve_cli.synth_extra_inputs(
                cfg, rng) or None, **kw)

    return {"tier1": [mk("lo", i, 1, new, i % 2)
                      for i in range(OVERLOAD_CAPACITY)],
            "burst": [mk("hi", i, 0, hi_new, False)
                      for i in range(OVERLOAD_BURST)],
            "late": [mk("late", i, 1, new, i % 2)
                     for i in range(OVERLOAD_LATE)]}


def clone_request(r: Request) -> Request:
    return Request(r.tenant, r.prompt.copy(), r.max_new_tokens,
                   temperature=r.temperature, top_k=r.top_k, seed=r.seed,
                   priority=r.priority, extra_inputs=r.extra_inputs)


@contextlib.contextmanager
def sync_errors(dev):
    """``set_sync_debug_mode("error")`` for the block (a CUDA device)."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if tree is not None else 0


def record_bytes(rec) -> int:
    return (tree_bytes(rec.host_kv) + tree_bytes(rec.host_pos)
            + tree_bytes(rec.logits) + tree_bytes(rec.host_cross)
            + tree_bytes(rec.host_state))


def restored_matches(ceng, rec) -> bool:
    """The restored row of ``rec``'s request against the snapshot, bit for
    bit: every page of its row (K, V and positions in every stage), its
    cross pages, its SSM records, its logits row."""
    slot = next(c for c, s in enumerate(ceng._slots)
                if s is not None and s.req is rec.req)
    st, kv, dev = ceng.state, ceng.kv, ceng.device

    def same(a, b) -> bool:
        b = b.to(dev)
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                        else a, b.view(torch.int16)
                        if b.dtype == torch.bfloat16 else b))

    ok = same(st["logits"][slot], rec.logits)
    pages = kv.owned_pages(slot)
    if pages:
        idx = torch.tensor(pages, device=dev)
        ok &= same(st["pos_pool"].index_select(0, idx), rec.host_pos)
        for name, blocks in rec.host_kv.items():
            for k in "kv":
                ok &= same(st["caches"][name][k].index_select(1, idx),
                           blocks[k])
    if rec.host_cross is not None:
        idx = torch.tensor(kv.cross_pages_of(slot), device=dev)
        for k in "kv":
            ok &= same(st["caches"]["cross"][k].index_select(1, idx),
                       rec.host_cross[k])
    for name, leaves in (rec.host_state or {}).items():
        for k, v in leaves.items():
            ok &= same(st["caches"][name][k][:, slot], v)
    return ok


class SwapProbe:
    """Wraps one engine's swap path for a run: CUDA events around each
    swap-out (snapshot gather, copy to pinned memory, evict), around the
    compute stream's wait for each staged record, and around each restore's
    page writes (the scatter kernel's launches and the slot's scalars);
    every dispatch and restore under ``set_sync_debug_mode("error")``; the
    first restores held bit for bit against their snapshots; and per round
    whether a swap came before it."""

    def __init__(self, ceng, dev):
        self.ceng, self.dev = ceng, dev
        self.out, self.wait, self.write = [], [], []
        self.out_bytes, self.k4_restore, self.checked = [], 0, 0
        self.mismatch = 0
        self.swapped_before: list = []
        self._swap_since = False
        self._orig = {}
        store = ceng.swap_store
        store.prefetch_log.clear()
        self._patch(ceng, "preempt", self._preempt)
        self._patch(ceng, "try_restore", self._try_restore)
        self._patch(ceng, "_restore_row", self._restore_row)
        self._patch(ceng, "dispatch_round", self._dispatch)
        self._patch(store, "fetch", self._fetch)

    def _patch(self, obj, name, fn):
        self._orig[(obj, name)] = getattr(obj, name)
        setattr(obj, name, fn)

    def close(self):
        for (obj, name) in self._orig:
            delattr(obj, name)

    def _call(self, obj, name, *a):
        return self._orig[(obj, name)](*a)

    def _events(self):
        if self.dev.type != "cuda":
            return None, None
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _timed(self, sink, obj, name, *a):
        e0, e1 = self._events()
        if e0 is not None:
            e0.record()
        r = self._call(obj, name, *a)
        if e1 is not None:
            e1.record()
            sink.append((e0, e1))
        return r

    def _preempt(self, slot):
        ticket = self._timed(self.out, self.ceng, "preempt", slot)
        self.out_bytes.append(record_bytes(
            self.ceng.swap_store.record(ticket)))
        self._swap_since = True
        return ticket

    def _fetch(self, ticket):
        return self._timed(self.wait, self.ceng.swap_store, "fetch", ticket)

    def _restore_row(self, slot, rec, arrays, pages, n_shared, cross_pages):
        self.k4_restore += (len(self.ceng.kv.attn_subs)
                            * (len(pages) > n_shared)
                            + 2 * (cross_pages is not None))
        return self._timed(self.write, self.ceng, "_restore_row", slot, rec,
                           arrays, pages, n_shared, cross_pages)

    def _try_restore(self, ticket):
        rec = self.ceng.swap_store.record(ticket)
        with sync_errors(self.dev):
            ok = self._call(self.ceng, "try_restore", ticket)
        if ok:
            self._swap_since = True
            if self.checked < OVERLOAD_CHECKED:
                self.checked += 1
                self.mismatch += not restored_matches(self.ceng, rec)
        return ok

    def _dispatch(self):
        with sync_errors(self.dev):
            h = self._call(self.ceng, "dispatch_round")
        self.swapped_before.append(self._swap_since)
        self._swap_since = False
        return h

    def numbers(self, h2d_gbps: float) -> dict:
        ms = lambda evs: [a.elapsed_time(b) for a, b in evs]
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        pre = [(a.elapsed_time(b), n) for a, b, n in
               self.ceng.swap_store.prefetch_log]
        pre_bytes = [n for _, n in pre]
        rounds = self.ceng.round_ms[-len(self.swapped_before):] \
            if self.ceng.round_ms else []
        with_swap = [r for r, s in zip(rounds, self.swapped_before) if s]
        without = [r for r, s in zip(rounds, self.swapped_before) if not s]
        med = lambda x: float(np.median(x)) if x else None
        return dict(
            swap_outs=len(self.out_bytes), swap_out_ms=ms(self.out),
            swap_out_bytes=self.out_bytes, prefetches=len(pre),
            prefetch_ms=[m for m, _ in pre], prefetch_bytes=pre_bytes,
            prefetch_bound_ms=[n / (h2d_gbps * 1e9) * 1e3
                               for n in pre_bytes],
            h2d_gbps=h2d_gbps, restore_wait_ms=ms(self.wait),
            restore_write_ms=ms(self.write),
            restore_k4_launches=self.k4_restore,
            restores_checked=self.checked,
            round_ms_after_swap_median=med(with_swap),
            round_ms_no_swap_median=med(without),
            rounds_after_swap=len(with_swap), rounds_no_swap=len(without))


def overload_run(ceng, traffic, dev, h2d_gbps, faults=None) -> dict:
    """One overload run through ``MultiTenantScheduler``: 8 tier-1 rows
    admitted (4, then 4), a round on the card, then the tier-0 burst with
    the late tier-1 rows; drained.  Counts reset just before, read just
    after."""
    eng = ceng.engine
    plane = None
    if faults:
        plane = FaultPlane(**faults)
        ceng.fault_plane = ceng.swap_store.fault_plane = plane
    probe = SwapProbe(ceng, dev)
    calls0 = ceng.prefill_calls
    rounds0, pre0, res0 = ceng.rounds, ceng.preemptions, ceng.restores
    for m in (agg, pa, fa, ssd):
        m.reset_counts()                 # just before the serving path
    try:
        sched = MultiTenantScheduler(eng, mode="continuous",
                                     continuous_engine=ceng,
                                     max_backlog=OVERLOAD_BACKLOG)
        out = []
        tier1 = traffic["tier1"]
        for part in (tier1[:OVERLOAD_CAPACITY // 2],
                     tier1[OVERLOAD_CAPACITY // 2:]):
            for r in part:
                sched.submit(r)
            out += sched.step() or []
        while ceng.active_count() < len(tier1) and sched.pending():
            out += sched.step() or []    # stalled admissions retry
        out += sched.step() or []
        for r in traffic["burst"] + traffic["late"]:
            sched.submit(r)
        with torch.no_grad():
            out += sched.drain()
    finally:
        probe.close()
        ceng.fault_plane = ceng.swap_store.fault_plane = None
    launches, plains = slot_launches()   # just after
    variants = {K5: dict(fa.variant_counts), K6: dict(ssd.variant_counts)}
    return dict(out=out, sched=sched, probe=probe, plane=plane,
                launches=launches, plains=plains, variants=variants,
                prefill_calls=ceng.prefill_calls - calls0,
                rounds=ceng.rounds - rounds0,
                preemptions=ceng.preemptions - pre0,
                restores=ceng.restores - res0,
                numbers=probe.numbers(h2d_gbps))


def hold_overload_run(arch: str, tag: str, ceng, traffic, run, want,
                      traces: int) -> dict:
    """Every request in exactly one outcome; the completed tier-1 rows --
    the victims among them -- token-identical to their uninterrupted run;
    the shed count; both tiers conserved and the host tier empty; no key
    captured again; each kernel's launches by sub-layer, restores
    included."""
    out, sched = run["out"], run["sched"]
    what = f"{arch} {tag}"
    reqs = traffic["tier1"] + traffic["burst"] + traffic["late"]
    by = {}
    for r in out:
        check(r.tenant not in by, f"{what}: {r.tenant} has two outcomes")
        by[r.tenant] = r
    check(set(by) == {r.tenant for r in reqs},
          f"{what}: {len(by)} outcomes for {len(reqs)} requests")
    check(all(r.outcome in ("completed", "rejected", "failed")
              for r in out), f"{what}: outcomes {[r.outcome for r in out]}")
    shed = sum(int(s["shed"]) for s in sched.stats.values())
    victims = [r.tenant for r in traffic["tier1"]
               if by[r.tenant].preemptions > 0]
    for r in traffic["tier1"]:
        got = by[r.tenant]
        if got.outcome != "completed":
            continue
        check(np.array_equal(got.tokens, want[r.tenant]),
              f"{what}: {r.tenant} ({got.preemptions} preemptions, "
              f"temperature {r.temperature}) differs from its run without "
              "preemption")
    for r in reqs:
        got = by[r.tenant]
        if got.outcome == "completed":
            check(got.tokens.size == r.max_new_tokens
                  and int(got.tokens.min()) >= 0
                  and int(got.tokens.max()) < ceng.cfg.vocab_size,
                  f"{what}: {r.tenant} tokens")
    sampled = [t for t in victims
               if next(r for r in reqs if r.tenant == t).temperature]
    check(run["preemptions"] >= 1 and run["restores"] >= 1 and victims
          and (tag != "overload" or 0 < len(sampled) < len(victims)),
          f"{what}: {run['preemptions']} preemptions, {run['restores']} "
          f"restores, victims {victims} (sampled {sampled})")
    check(shed >= 1 and shed == sum(r.outcome == "rejected" for r in out),
          f"{what}: shed {shed}, rejected "
          f"{sum(r.outcome == 'rejected' for r in out)}")
    check(len(ceng.swap_store) == 0, f"{what}: host tier not empty")
    ceng.assert_conserved()
    check(ceng.nonfinite_rows == 0, f"{what}: non-finite logits")
    check(ceng.decode_traces == traces and (
        ceng.round_program is None
        or len(ceng.round_program.rounds) == traces),
          f"{what}: a round key was captured again ({ceng.decode_traces} "
          f"keys, {traces} before)")
    check(run["probe"].mismatch == 0,
          f"{what}: {run['probe'].mismatch} restored rows differ from "
          "their snapshots")
    eng, cfg = ceng.engine, ceng.cfg
    launches, plains = run["launches"], run["plains"]
    n_attn = ceng.n_stages * len(ceng.kv.attn_subs)
    n_ssm = ceng.n_stages * len(ceng.ssm_subs)
    admitted = run["prefill_calls"]      # one prefill an admission
    want_l = {K5: k5_per_prefill(cfg) * admitted,
              K3: n_attn * run["rounds"] * ceng.inner_steps,
              K4: (len(ceng.kv.attn_subs) + 2 * bool(ceng.cross_blocks))
              * admitted + run["probe"].k4_restore,
              K6: n_ssm * admitted}
    want_l = {k: n for k, n in want_l.items() if n}
    check(all(launches[k] == n for k, n in want_l.items())
          and all(v == 0 for k, v in launches.items() if k not in want_l)
          and not any(plains.values()),
          f"{what}: launches {launches}, expected {want_l} ({admitted} "
          f"admissions, {run['rounds']} rounds, {run['restores']} "
          f"restores), plain calls {plains}")
    if ceng.device.type == "cuda":
        for k in (K5, K6):
            check(run["variants"][k] == {"bf16_mma": want_l.get(k, 0),
                                         "f32_simt": 0},
                  f"{what}: {k} variants {run['variants'][k]}")
    outcomes = {o: sum(r.outcome == o for r in out)
                for o in ("completed", "rejected", "failed")}
    return dict(outcomes=outcomes, victims=victims,
                victims_sampled=len(sampled), shed=shed,
                preemptions=run["preemptions"], restores=run["restores"],
                rounds=run["rounds"], admissions=admitted, launches=want_l,
                **run["numbers"])


def serve_overload_arch(arch: str, prompt_len: int, dev,
                        h2d_gbps: float) -> dict:
    """One arch at its published width and depth, bf16, random weights
    from seed 0: capacity 8, 4 steps a round, preemption on, one prefill an
    admission (a prefill's bits in bf16 depend on its batch width; at width
    1 a request's tokens depend on the request alone, so runs with and
    without preemption are comparable bit for bit)."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    ceng = ContinuousBatchingEngine(
        eng, capacity=OVERLOAD_CAPACITY, page_size=16, inner_steps=4,
        max_prompt_len=2 * prompt_len, batch_admission=False)
    check(ceng.can_preempt, f"{arch}: the engine cannot preempt")
    with torch.no_grad():
        # every round key captured up front: greedy, temperature, top-k
        for kw in ({}, dict(temperature=0.8, seed=1),
                   dict(temperature=0.8, seed=2, top_k=20)):
            ceng.run_all([Request("warm", np.arange(1, 9, dtype=np.int32),
                                  4, extra_inputs=serve_cli.synth_extra_inputs(
                                      cfg, np.random.default_rng(0)) or None,
                                  **kw)])
        traces = ceng.decode_traces
        check(traces == 3, f"{arch}: {traces} round keys after the warm-up")
        traffic = overload_traffic(cfg, prompt_len, 0)
        want = {r.tenant: t for r, t in ceng.run_all(
            [clone_request(r) for r in traffic["tier1"]])}
    res = {}
    for tag, faults in (("overload", None), ("faults", OVERLOAD_FAULTS)):
        traffic = overload_traffic(cfg, prompt_len, 0)
        run = overload_run(ceng, traffic, dev, h2d_gbps, faults)
        res[tag] = hold_overload_run(arch, tag, ceng, traffic, run, want,
                                     traces)
        if faults:
            plane, sched = run["plane"], run["sched"]
            check(plane.total_injected() > 0
                  and sched.faults_survived == plane.total_injected(),
                  f"{arch} faults: injected {plane.injected}, survived "
                  f"{sched.faults_survived}")
            res[tag].update(injected=dict(plane.injected),
                            faults_survived=sched.faults_survived)
    res["wall_s"] = time.perf_counter() - t0
    del eng, ceng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_serve_overload(dev, h2d_gbps: float) -> dict:
    """serve-overload: ``serve_overload_arch`` for internlm2-1.8b (attention
    pages), mamba2-2.7b (SSM records) and whisper-base (self and cross
    pages); prints each arch's swap-out, prefetch (beside its bound at the
    risk staging's host-to-device rate), restore wait and restore-write
    times and the replayed round with and without a swap before it."""
    t0 = time.perf_counter()
    runs, launches = {}, {}
    for arch, prompt_len in OVERLOAD_ARCHS:
        r = serve_overload_arch(arch, prompt_len, dev, h2d_gbps)
        runs[arch] = r
        launches[f"{arch} overload"] = {
            k: r["overload"]["launches"].get(k, 0)
            + r["faults"]["launches"].get(k, 0) for k in (K3, K4, K5, K6)}
        for tag in ("overload", "faults"):
            n = r[tag]
            mean = lambda x: float(np.mean(x)) if x else float("nan")
            say("serve-overload", f"{arch} {tag}: outcomes {n['outcomes']}, "
                f"victims {len(n['victims'])}, preemptions "
                f"{n['preemptions']}, restores {n['restores']} "
                f"({n['restores_checked']} held bit for bit), shed "
                f"{n['shed']}; swap-out {mean(n['swap_out_ms']):.3f} ms "
                f"a row for {mean(n['swap_out_bytes']) / 1e6:.2f} MB; "
                f"prefetch {mean(n['prefetch_ms']):.3f} ms a record "
                f"(bound {mean(n['prefetch_bound_ms']):.3f} ms at "
                f"{h2d_gbps:.1f} GB/s); restore wait "
                f"{mean(n['restore_wait_ms']):.3f} ms, writes "
                f"{mean(n['restore_write_ms']):.3f} ms "
                f"({n['restore_k4_launches']} K4 launches); round "
                f"{n['round_ms_no_swap_median']} ms, after a swap "
                f"{n['round_ms_after_swap_median']} ms"
                + (f"; injected {n['injected']}" if "injected" in n else ""))
    say("serve-overload", f"{time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "launches": launches}


# ---------------------------------------------------------------------------
# serve-crash: launch.serve children killed by SIGKILL (at a dispatched
# round, and inside a swap-out), each followed by a --recover child; every
# recovered request's tokens held to an uncrashed run's journal
CRASH_ARGV = ["--arch", "internlm2-1.8b", "--no-reduced", "--mode",
              "continuous", "--tenants", "3", "--requests", "12",
              "--prompt-len", "128", "--new-tokens", "48", "--capacity", "8",
              "--page-size", "16", "--inner-steps", "4",
              "--no-batch-admission", "--checkpoint-every", "4"]
CRASH_ROUND = 6
CRASH_NEW, CRASH_HI_NEW = 48, 12        # the swap workload's tier-1 and tier-0
CRASH_CHILD_S = 600          # a child's time limit
CRASH_CHILD_ARGS = ["cuda", "full"]     # the workload child's device, size


def crash_workload(root: str, phase: str, dev, reduced: bool = False) -> dict:
    """The mid-preemption crash's workload (the serve CLI has no swap crash
    flag): internlm2-1.8b at full width with a journal and checkpoints
    every 4 rounds, 8 tier-1 rows, two rounds, then two tier-0 rows that
    preempt.  ``crash``: SIGKILL inside the first swap-out's put;
    ``recover``: rebuild from the journal and the latest checkpoint and
    drain; ``base``: the same traffic uncrashed."""
    cfg = get_config("internlm2-1.8b")
    if reduced:
        cfg = cfg.reduced()
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    plane = FaultPlane(crash_at_swap=1) if phase == "crash" else None
    ceng = ContinuousBatchingEngine(
        eng, capacity=8, page_size=16, inner_steps=4, max_prompt_len=256,
        batch_admission=False, fault_plane=plane)
    sched = MultiTenantScheduler(
        eng, mode="continuous", continuous_engine=ceng,
        journal=os.path.join(root, "journal.jsonl"),
        checkpoint_dir=os.path.join(root, "checkpoints"), checkpoint_every=4)
    traffic = overload_traffic(cfg, 128, 7, CRASH_NEW, CRASH_HI_NEW)
    out = {}
    with torch.no_grad():
        if phase == "recover":
            t0 = time.perf_counter()
            s = sched.recover()
            out["recover_ms"] = (time.perf_counter() - t0) * 1e3
            out.update(restored_live=s.restored_live,
                       restored_swapped=s.restored_swapped,
                       requeued=s.requeued, step=s.checkpoint_step)
        else:
            for r in traffic["tier1"]:
                sched.submit(r)
            while not sched.checkpoints_taken:
                sched.step()
            sched.step()
            for r in traffic["burst"][:2]:
                sched.submit(r)
        sched.drain()
    out.update(preemptions=ceng.preemptions, restores=ceng.restores)
    return out


def crash_child_main(phase: str, root: str, device: str = "cuda",
                     size: str = "full") -> int:
    """``chip_smoke.py --serve-crash-child PHASE ROOT [DEVICE SIZE]``:
    ``crash_workload`` in a process of its own; prints its numbers as one
    JSON line."""
    out = crash_workload(root, phase, torch.device(device),
                       reduced=size == "reduced")
    print("CRASH_CHILD " + json.dumps(out), flush=True)
    return 3 if phase == "crash" else 0      # a crash that did not fire


def retired_tokens(journal: str) -> dict:
    """rid -> tokens of the last RETIRE record of each rid."""
    return {r["rid"]: r["tokens"] for r in journal_mod.read_journal(journal)
            if r["kind"] == "RETIRE"}


def start_children(cmds) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return [subprocess.Popen(c, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env,
                             cwd=ROOT) for c in cmds]


def finish_children(procs) -> list:
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=CRASH_CHILD_S)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out.append((p.returncode, so, se))
    return out


def phase_serve_crash(dev) -> dict:
    """serve-crash: (1) ``launch.serve.main`` in this process with
    ``--journal-dir`` and ``--checkpoint-every 4``, uncrashed: its
    journal is the baseline, and each journal append (fsync included) and
    each checkpoint is timed; (2) two children at once, a ``launch.serve``
    child with ``--crash-at-round 6`` and a ``crash_workload`` child with
    ``crash_at_swap=1``, each to exit by SIGKILL (-9); (3) two recovering
    children at once, ``launch.serve --recover`` and ``crash_workload``'s
    recover; every request's final tokens in each journal equal the
    uncrashed run's (the workload's baseline runs here)."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="serve_crash_")
    dirs = {k: os.path.join(root, k) for k in ("base", "round", "swap",
                                               "swap_base")}
    appends = []
    write = journal_mod.JournalWriter.append

    def timed_append(self, kind, **fields):
        t = time.perf_counter()
        seq = write(self, kind, **fields)
        appends.append((kind, time.perf_counter() - t))
        return seq

    ckpts = []

    def observe(sched):
        if getattr(sched, "_timed", False):
            return
        sched._timed = True
        save = sched.save_checkpoint

        def timed_save():
            t = time.perf_counter()
            step = save()
            d = os.path.join(sched.checkpoint_dir, f"engine_{step}")
            ckpts.append(((time.perf_counter() - t) * 1e3, sum(
                os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))))
            return step

        sched.save_checkpoint = timed_save
        observe.sched = sched

    journal_mod.JournalWriter.append = timed_append
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = serve_cli.main(CRASH_ARGV + ["--journal-dir",
                                              dirs["base"]], observe=observe)
    finally:
        journal_mod.JournalWriter.append = write
    check(rc == 0, f"serve-crash baseline returned {rc}")
    ceng = observe.sched.continuous_engine
    round_ms = float(np.median(ceng.round_ms)) if ceng.round_ms else None
    n_rounds = len(ceng.round_ms) or ceng.rounds
    base = retired_tokens(os.path.join(dirs["base"], "journal.jsonl"))
    check(len(base) == 12, f"serve-crash baseline retired {len(base)}")
    del ceng, observe.sched
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    serve = [sys.executable, "-m", "repro_torch.launch.serve"] + CRASH_ARGV
    me = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
          "--serve-crash-child"]
    crashed = finish_children(start_children([
        serve + ["--journal-dir", dirs["round"], "--crash-at-round",
                 str(CRASH_ROUND)],
        me + ["crash", dirs["swap"]] + CRASH_CHILD_ARGS]))
    for (rc, so, se), what in zip(crashed, ("round", "swap")):
        check(rc == -9, f"serve-crash {what} child exited {rc}, not -9: "
                        f"{se[-2000:]}")
    swap_base = crash_workload(dirs["swap_base"], "base", dev,
                             reduced=CRASH_CHILD_ARGS[1] == "reduced")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_rec = time.perf_counter()
    recovered = finish_children(start_children([
        serve + ["--journal-dir", dirs["round"], "--recover"],
        me + ["recover", dirs["swap"]] + CRASH_CHILD_ARGS]))
    rec_wall = time.perf_counter() - t_rec
    for (rc, so, se), what in zip(recovered, ("round", "swap")):
        check(rc == 0, f"serve-crash {what} recovery exited {rc}: "
                       f"{se[-2000:]}")
    m = re.search(r"recovered in ([\d.]+) ms", recovered[0][1])
    check(m is not None, "serve-crash: no recovery line")
    swap_rec = json.loads(next(
        ln.split(" ", 1)[1] for ln in recovered[1][1].splitlines()
        if ln.startswith("CRASH_CHILD ")))
    got = retired_tokens(os.path.join(dirs["round"], "journal.jsonl"))
    check(got == base, f"serve-crash round: recovered tokens differ from "
          f"the uncrashed run's for rids "
          f"{sorted(r for r in base if got.get(r) != base[r])}")
    want = retired_tokens(os.path.join(dirs["swap_base"], "journal.jsonl"))
    got = retired_tokens(os.path.join(dirs["swap"], "journal.jsonl"))
    check(len(want) == 10 and got == want,
          f"serve-crash swap: recovered tokens differ from the uncrashed "
          f"run's for rids "
          f"{sorted(r for r in want if got.get(r) != want[r])}")
    check(swap_base["preemptions"] >= 1,
          "serve-crash: the swap workload's traffic did not preempt")
    kinds = [r["kind"] for r in journal_mod.read_journal(
        os.path.join(dirs["swap"], "journal.jsonl"))]
    check("PREEMPT" not in kinds[:kinds.index("RECOVER")],
          "serve-crash swap: a PREEMPT record before the crash")
    us = [s * 1e6 for _, s in appends]
    per_round = len(appends) / max(n_rounds, 1)
    out = dict(
        journal_appends=len(appends),
        journal_append_us_median=float(np.median(us)),
        journal_append_us_max=float(max(us)),
        appends_per_round=per_round,
        journal_share_of_round=(float(np.median(us)) * 1e-3 * per_round
                                / round_ms) if round_ms else None,
        replayed_round_ms=round_ms,
        checkpoints=len(ckpts),
        checkpoint_ms=[c for c, _ in ckpts],
        checkpoint_bytes=[b for _, b in ckpts],
        recover_round_ms=float(m.group(1)),
        recover_swap_ms=swap_rec["recover_ms"],
        recover_swap_summary=swap_rec, recovery_children_wall_s=rec_wall,
        swap_base=swap_base)
    say("serve-crash", f"both children killed (-9) and recovered token for "
        f"token; journal append {out['journal_append_us_median']:.1f} us "
        f"median (max {out['journal_append_us_max']:.1f}), "
        f"{per_round:.2f} a round: {out['journal_share_of_round']} of a "
        f"{round_ms} ms replayed round; checkpoints "
        f"{[round(c, 1) for c in out['checkpoint_ms']]} ms, "
        f"{[round(b / 1e6, 1) for b in out['checkpoint_bytes']]} MB; "
        f"recover {out['recover_round_ms']:.1f} ms (round crash), "
        f"{out['recover_swap_ms']:.1f} ms (swap crash: {swap_rec}); "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# mesh (slice 6a): KV pools split on KV heads over a one-process mesh whose
# positions are this one card, repeated; the risk step split over trials
# ---------------------------------------------------------------------------
MESH_KERNEL_WIDTHS = (2, 4, 8)       # model extents of the kernel checks
MESH_SERVE_WIDTHS = (2, 8)           # 1xM meshes of the Python-API runs
MESH_RISK = "1x4"
POOL4 = (None, None, "kv", None)     # a stage's pool (NP, P, Hkv, D)
POOL5 = (None, None, None, "kv", None)
MESH_ARGV = SERVE_ARGV + ["--shared-prefix-len", "64"]
MESH_REQUESTS = 16                   # half behind a 64-token shared prefix
MESH_PAGES = PagedKVCache.RESERVED + 40   # tight: cached pages recycled
MESH_NEW = 24


def mesh_sharder(m: int, dev):
    """A serving sharder on a 1xm mesh of ``dev`` repeated m times."""
    return serving_sharder(parse_mesh(f"1x{m}", [dev] * m))


def mesh_kernels(errs: Errors, dev) -> dict:
    """The sharded wrappers on the card against the unsharded kernels.
    First the reference's three dispatch shapes at 1x8
    (``tests/test_mesh_serving.py`` SHARDED_KERNEL_SCRIPT: GQA and
    indivisible heads bit for bit, MQA held at the decode's tolerance with
    its bitwise agreement a number) and its scatter; then internlm2's
    full-width decode and admission at M = 2, 4, 8, bit for bit the
    unsharded call's, the decode timed at each M beside it."""
    rng = np.random.default_rng(11)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sh8 = mesh_sharder(8, dev)
    C, H, Hkv, D, NP_, P, NB = 4, 16, 8, 16, 10, 4, 3
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    q = on(rng.normal(size=(C, H, D)).astype(np.float32))
    kp = on(rng.normal(size=(NP_, P, Hkv, D)).astype(np.float32)).to(
        torch.bfloat16)
    vp = on(rng.normal(size=(NP_, P, Hkv, D)).astype(np.float32)).to(
        torch.bfloat16)
    rest = (on(rng.integers(0, 8, (NP_, P)).astype(np.int32)),
            on(rng.integers(2, NP_, (C, NB)).astype(np.int32)),
            on(rng.integers(4, 12, (C,)).astype(np.int32)))
    out = {}
    for shape, (qq, k, v) in (
            ("gqa", (q, kp, vp)),
            ("mqa", (q, kp[:, :, :1].contiguous(), vp[:, :, :1].contiguous())),
            ("indivisible", (q[:, :12].contiguous(), kp[:, :, :3].contiguous(),
                             vp[:, :, :3].contiguous()))):
        ref = pa.paged_attention_decode(qq, k, v, *rest)
        got = sh8.constrain(pa.paged_attention_decode_sharded(
            qq, sh8.place(k, POOL4), sh8.place(v, POOL4), *rest, sh8),
            (None, None, None))
        same = torch.equal(got, ref)
        out[f"reference {shape} bitwise"] = same
        if shape == "mqa":
            errs.hold(K3, got, ref, "mesh 1x8 MQA, q split on heads")
        else:
            check(same, f"mesh 1x8 {shape}: the sharded decode is not bit "
                        "for bit the unsharded call")
    pool = torch.zeros((2, NP_, P, Hkv, D), dtype=torch.bfloat16, device=dev)
    pages = torch.tensor([3, 5, 7], dtype=torch.int32, device=dev)
    vals = torch.randn((2, 3, P, Hkv, D), device=dev)
    sp = sh8.place(pool.clone(), POOL5)
    pa.paged_prefill_scatter_sharded(sp, pages, vals, sh8)
    errs.hold_bits(K4, sp.full(), pa.paged_prefill_scatter(pool, pages, vals),
                   "mesh 1x8 scatter, the reference's case")

    # internlm2 at full width: the serving path's decode and admission
    Cf, Hf, Hkf, Df, Pf, Sf, NBf = (FULL_C, FULL_H, FULL_HKV, FULL_D, FULL_P,
                                    FULL_S, 20)
    st = rand_paged_state(rng, C=Cf, NB=NBf, P=Pf, H=Hf, Hkv=Hkf, D=Df,
                          dev=dev, q_dtype=torch.bfloat16, full=True)
    ref = pa.paged_attention_decode(*st)
    NPa = PagedKVCache.RESERVED + Cf * NBf
    case = admission_case(rng, Sf, NPa, Pf, Hkf, Df, list(range(3, 15)),
                          12 * Pf, torch.bfloat16, dev)
    want = [t.clone() for t in case[:3]]
    pa.paged_admit_kv(*want, *case[3:])
    timed = {1: cuda_ms(lambda: pa.paged_attention_decode(*st), 30, flush)}
    for m in MESH_KERNEL_WIDTHS:
        sh = mesh_sharder(m, dev)
        ks, vs = sh.place(st[1], POOL4), sh.place(st[2], POOL4)
        o = pa.paged_attention_decode_sharded(st[0], ks, vs, *st[3:], sh)
        check(len(o.unique()) == m
              and torch.equal(sh.constrain(o, (None, None, None)), ref),
              f"mesh 1x{m}: the full-width sharded decode is not bit for "
              "bit the unsharded call")
        errs.cases[K3] += 1
        timed[m] = cuda_ms(lambda: pa.paged_attention_decode_sharded(
            st[0], ks, vs, *st[3:], sh), 30, flush)
        kp5, vp5 = (sh.place(t.clone(), POOL5) for t in case[:2])
        pp = case[2].clone()
        pa.paged_admit_kv_sharded(kp5, vp5, pp, *case[3:], sh)
        for tag, a, b in (("K", kp5.full(), want[0]),
                          ("V", vp5.full(), want[1])):
            errs.hold_bits(K4, a, b, f"mesh 1x{m} full-width admission {tag}")
        check(torch.equal(pp, want[2]), f"mesh 1x{m} admission: positions")
        del ks, vs, kp5, vp5
    bound, by = decode_bound_ms(Cf, NBf, Pf, Hf, Hkf, Df, 2)
    say("mesh", f"sharded decode at internlm2's full width (q ({Cf}, {Hf}, "
                f"{Df}) bf16, table ({Cf}, {NBf})): ms by model extent "
                f"{ {k: round(v, 4) for k, v in timed.items()} }, bound "
                f"{bound:.4f} ms by {by}; MQA bitwise "
                f"{out['reference mqa bitwise']}")
    return {"decode_ms_by_extent": timed, "bound_ms": bound, **out}


def mesh_mix(cfg) -> list:
    """The reference's SHARDED_ENGINE_SCRIPT mix at full width: every other
    request behind one 64-token system prefix (trie hits, copy-on-write
    forks as the decode ring wraps onto shared pages), tails of 32-64
    tokens, greedy."""
    rng = np.random.default_rng(12)
    shared = rng.integers(1, cfg.vocab_size, 64).astype(np.int32)
    reqs = []
    for i in range(MESH_REQUESTS):
        tail = rng.integers(1, cfg.vocab_size,
                            32 + 16 * (i % 3)).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        reqs.append(Request(f"t{i % 3}", prompt, MESH_NEW, seed=i))
    return reqs


def mesh_engine_run(cfg, params, m, dev) -> dict:
    """One continuous engine at full width (no mesh for ``m`` None, else
    1xm over the card) serving :func:`mesh_mix` through ``run_all`` with a
    tight pool; counts reset just before, read just after."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, params, device=dev,
                        sh=mesh_sharder(m, dev) if m else None)
    ceng = ContinuousBatchingEngine(eng, capacity=8, page_size=16,
                                    inner_steps=4, max_prompt_len=192,
                                    num_pages=MESH_PAGES)
    reset_kernel_counts()
    with torch.no_grad():
        out = ceng.run_all([clone_request(r) for r in mesh_mix(cfg)])
    launches = {K3: pa.launch_counts[K3], K4: pa.launch_counts[K4],
                K5: fa.launch_counts[K5]}
    plains = sum(pa.plain_counts.values()) + sum(fa.plain_counts.values())
    tag = f"mesh {'1x%d' % m if m else 'none'}"
    check(len(out) == MESH_REQUESTS and plains == 0
          and ceng.nonfinite_rows == 0,
          f"{tag}: {len(out)} requests, plain calls {plains}, non-finite "
          f"rows {ceng.nonfinite_rows}")
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())
    ceng.assert_conserved()
    n_attn = ceng.n_stages * len(ceng.kv.attn_subs)
    # a launch a distinct shard: m where the kv heads split m ways
    width = m if m and cfg.num_kv_heads % m == 0 else 1
    want = {K3: ceng.rounds * ceng.inner_steps * n_attn * width,
            K4: (len(out) - ceng.prefill_skips) * len(ceng.kv.attn_subs)
            * width,
            K5: ceng.prefill_calls * n_attn}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    if m:
        pool = ceng.state["caches"][ceng.kv.attn_subs[0]]["k"]
        check(len(pool.unique()) == m and all(
            t.shape[3] == cfg.num_kv_heads // m for t in pool.locals),
            f"{tag}: pool shards {[tuple(t.shape) for t in pool.locals]}")
    ms = ceng.round_ms[1:]            # after the capture round: replays
    res = dict(tokens={r.prompt.tobytes(): t for r, t in out},
               logits=ceng.state["logits"].clone(), launches=launches,
               rounds=ceng.rounds, round_ms_median=float(np.median(ms)),
               round_ms_min=float(np.min(ms)),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               prefill_ms=float(np.sum(ceng.prefill_ms())),
               kv={k: getattr(ceng.kv, k) for k in (
                   "pages_allocated", "pages_shared", "pages_reused",
                   "cow_forks", "pristine_forks")},
               **graph_rounds(ceng, tag))
    del ceng, eng
    return res


def mesh_swap_cycle(cfg, params, m, dev) -> tuple:
    """Two 30-token tier-1 rows fill a capacity-2 table, then a tier-0
    arrival preempts one (the reference's swap_cycle), at full width; with
    a mesh every swap-in rides one lane per position."""
    rng = np.random.default_rng(13)
    eng = ServingEngine(cfg, params, device=dev,
                        sh=mesh_sharder(m, dev) if m else None)
    sched = MultiTenantScheduler(
        eng, mode="continuous", preemption=True,
        continuous=dict(capacity=2, page_size=16, num_pages=24,
                        inner_steps=4, max_prompt_len=128))
    prompts = [rng.integers(1, cfg.vocab_size, 48 + 16 * (i % 2))
               .astype(np.int32) for i in range(3)]
    with torch.no_grad():
        for i in range(2):
            sched.submit(Request(f"lo{i}", prompts[i], 30, priority=1,
                                 seed=i))
        sched.step()
        sched.submit(Request("hi", prompts[2], 8, priority=0))
        res = sched.drain()
    ceng = sched.continuous_engine
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())
    check(ceng.preemptions > 0 and ceng.restores > 0
          and all(r.outcome == "completed" for r in res),
          f"swap cycle 1x{m}: preemptions {ceng.preemptions}, restores "
          f"{ceng.restores}, outcomes {[r.outcome for r in res]}")
    lanes = ceng.swap_store.lanes
    logs = [len(e.log) for e in lanes.engines] if lanes else []
    toks = {(r.tenant, tuple(r.tokens.tolist())) for r in res}
    del sched, ceng, eng
    return toks, logs


def mesh_serve(errs: Errors, dev) -> dict:
    """``launch.serve --mesh 1x1`` at internlm2's full width against the
    same run without a mesh (tokens identical, final logits bit for bit);
    then the Python API over 1x2 and 1x8 meshes of the card against no
    mesh on a prefix-sharing mix with a pool tight enough to recycle cached
    pages (greedy tokens equal; the logits' bitwise agreement a number;
    replayed round ms, launches and peak memory beside the meshless
    engine's); then one preempt / restore cycle through the lanes at
    1x2."""
    runs, recs = {}, {}
    for tag, extra in (("none", []), ("1x1", ["--mesh", "1x1"])):
        rec = ServeRecorder(snap=False)
        reset_kernel_counts()
        check(serve_cli.main(MESH_ARGV + extra, observe=rec) == 0,
              f"serve --mesh {tag} failed")
        eng = rec.sched.continuous_engine
        n_attn = eng.n_stages * len(eng.kv.attn_subs)
        launches = {K3: pa.launch_counts[K3], K4: pa.launch_counts[K4],
                    K5: fa.launch_counts[K5]}
        want = {K3: eng.rounds * eng.inner_steps * n_attn,
                K4: (len(rec.finished) - eng.prefill_skips)
                * len(eng.kv.attn_subs),
                K5: eng.prefill_calls * n_attn}
        check(launches == want and len(rec.finished) == 12,
              f"serve --mesh {tag}: launches {launches}, expected {want}; "
              f"{len(rec.finished)} requests")
        recs[tag] = rec
        runs[f"serve {tag}"] = dict(launches=launches, rounds=eng.rounds,
                                    **graph_rounds(eng, f"serve {tag}"))
    a, b = (recs[t] for t in ("none", "1x1"))
    ta = {r.prompt.tobytes(): t for r, t in a.finished}
    tb = {r.prompt.tobytes(): t for r, t in b.finished}
    check(ta.keys() == tb.keys()
          and all(np.array_equal(ta[k], tb[k]) for k in ta),
          "serve --mesh 1x1: tokens differ from the run without a mesh")
    la = a.sched.continuous_engine.state["logits"]
    lb = b.sched.continuous_engine.state["logits"]
    check(torch.equal(la, lb), "serve --mesh 1x1: final logits differ from "
                               "the run without a mesh")
    say("mesh", f"launch.serve --mesh 1x1 at full width: 12 requests "
                f"token-identical, final logits bit for bit; launches "
                f"{runs['serve 1x1']['launches']}")
    cfg = b.sched.continuous_engine.cfg
    del recs, a, b, la, lb
    gc.collect()
    torch.cuda.empty_cache()

    params = build_model(cfg).init(0, dev)
    base = mesh_engine_run(cfg, params, None, dev)
    check(base["kv"]["pages_reused"] > 0
          and base["kv"]["cow_forks"] + base["kv"]["pristine_forks"] > 0,
          f"mesh mix: no recycled pages or forks {base['kv']}")
    runs["none"] = {k: v for k, v in base.items()
                    if k not in ("tokens", "logits")}
    for m in MESH_SERVE_WIDTHS:
        r = mesh_engine_run(cfg, params, m, dev)
        same = [np.array_equal(r["tokens"][k], t)
                for k, t in base["tokens"].items()]
        check(all(same) and r["tokens"].keys() == base["tokens"].keys(),
              f"mesh 1x{m}: {sum(same)} of {len(same)} requests "
              "token-identical with no mesh")
        check(r["kv"] == base["kv"], f"mesh 1x{m}: page accounting "
                                     f"{r['kv']} against {base['kv']}")
        runs[f"1x{m}"] = {k: v for k, v in r.items()
                          if k not in ("tokens", "logits")}
        runs[f"1x{m}"]["logits_bitwise"] = int(torch.equal(r["logits"],
                                                           base["logits"]))
        runs[f"1x{m}"]["logits_max_abs_diff"] = float(
            (r["logits"] - base["logits"]).abs().max())
        say("mesh", f"1x{m} over the card: {MESH_REQUESTS} requests "
                    f"token-identical; replayed round median "
                    f"{r['round_ms_median']:.3f} ms (no mesh "
                    f"{base['round_ms_median']:.3f}), launches "
                    f"{r['launches']}, peak {r['peak_gib']:.2f} GiB (no mesh "
                    f"{base['peak_gib']:.2f}); logits bitwise "
                    f"{runs[f'1x{m}']['logits_bitwise']}")
    want, _ = mesh_swap_cycle(cfg, params, None, dev)
    got, logs = mesh_swap_cycle(cfg, params, 2, dev)
    check(got == want and len(logs) == 2 and all(logs),
          f"swap cycle 1x2: tokens equal {got == want}, lane logs {logs}")
    runs["swap 1x2"] = dict(lane_transfers=logs)
    say("mesh", f"preempt / restore at 1x2: victims token-identical, lane "
                f"transfers {logs}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_mesh(errs: Errors, dev) -> dict:
    kern = mesh_kernels(errs, dev)
    runs = mesh_serve(errs, dev)
    launches = {f"internlm2-1.8b mesh {k}": v["launches"]
                for k, v in runs.items() if "launches" in v}
    return {"kernels": kern, "runs": runs, "launches": launches}


def phase_mesh_risk(cfg: RiskAppConfig, tables: RiskTables, dev) -> dict:
    """The risk step at the published size with its trials split over a
    1x4 mesh of the card (``make_sharded_step``: K1 on each quarter)
    against ``run_single`` at ``YLT_RTOL``; both timed on the
    device-resident YET (CUDA events, the same inputs)."""
    ara = AggregateRiskAnalysis(cfg, device=dev)
    single = ara.run_single(tables)
    elt, ret, lim = ara._resident_tables(tables)[0]
    yet = torch.from_numpy(tables.yet).to(dev)
    a_ret, a_lim, chunk = (float(tables.agg_ret), float(tables.agg_lim),
                           ara._chunk(tables))
    mesh = parse_mesh(MESH_RISK, [dev] * 4)
    step = ara.make_sharded_step(mesh, chunk=chunk)
    agg.reset_counts()                    # just before the mesh path
    ylt = step(yet, elt, ret, lim, a_ret, a_lim)
    torch.cuda.synchronize()
    launches, rows = agg.launch_counts[G], agg.launch_counts[R]
    check(launches == rows == mesh.size and ylt.shape == (len(single),),
          f"mesh risk step: {launches} gather and {rows} row launches on "
          f"{mesh.size} positions, ylt {tuple(ylt.shape)}")
    got = ylt.cpu().numpy()
    check(np.allclose(got, single, rtol=YLT_RTOL, atol=0),
          f"mesh risk step: max rel diff "
          f"{np.max(np.abs(got - single) / np.maximum(np.abs(single), 1e-30))}"
          f" outside rtol={YLT_RTOL}")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    ms = {"single": [], "mesh": []}
    for name in ("single", "mesh", "mesh", "single"):
        fn = (lambda: ara._step(yet, elt, ret, lim, a_ret, a_lim, chunk)) \
            if name == "single" else \
            (lambda: step(yet, elt, ret, lim, a_ret, a_lim))
        ms[name].append(cuda_ms(fn, 5, flush))
    res = dict(trials=len(single), launches=launches, row_launches=rows,
               bitwise=bool(np.array_equal(got, single)),
               ms=statistics.median(ms["mesh"]),
               single_ms=statistics.median(ms["single"]), turns=ms)
    say("mesh", f"risk step {MESH_RISK} over the card at {len(single):,} "
                f"trials: {res['ms']:.3f} ms against the single call's "
                f"{res['single_ms']:.3f} ms; equal to run_single at "
                f"rtol={YLT_RTOL} (bitwise {res['bitwise']})")
    del yet, flush
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# training (slice 5): the autograd Functions against autograd through the
# plain versions, every arch reduced against the CPU, three archs at full
# width through launch.train, finite differences, tenant microbatches,
# recovery, and the example that learns
# ---------------------------------------------------------------------------
# the Functions' grads against autograd through the plain versions:
# tests/test_attention.py's 2e-3 (blockwise VJP vs naive autodiff) and
# tests/test_kernels_ssd.py's 1e-4 (the Pallas VJP vs the oracle's
# autodiff).  bfloat16 attention: the reference's own bf16 attention
# tolerance, 5e-2 (tests/test_attention.py::test_bf16_path), against the
# float32 plain version on the same rounded inputs, the absolute part
# scaled by the largest |grad| (a grad is a sum of bf16-rounded terms of
# that size).  The SSD's bfloat16 grads are one arithmetic on both sides
# (the backward recomputes the oracle): 1e-4, also scaled by the largest.
TRAIN_ATTN_GRAD = 2e-3
TRAIN_ATTN_BF16 = 5e-2
TRAIN_SSD_GRAD = 1e-4
# tests/test_attention.py's grad cases, then FLASH_SWEEP's windows, cross
# lengths, the ragged 1500 and the rows with no admissible key:
# (B, Sq, Skv, Hq, Hkv, D, causal, window)
TRAIN_FLASH_SWEEP = [
    (2, 64, 64, 4, 2, 16, True, None), (2, 64, 64, 4, 2, 16, True, 16),
    (2, 64, 64, 4, 2, 16, False, None), (1, 128, 128, 4, 1, 16, True, 32),
    (1, 32, 32, 2, 2, 64, False, 8), (1, 32, 128, 4, 2, 16, False, None),
    (1, 45, 90, 16, 2, 32, False, None), (1, 24, 200, 4, 2, 16, False, 16),
    (1, 203, 203, 8, 1, 128, True, 50), (1, 1500, 1500, 2, 2, 64, False, None),
    (1, 140, 20, 2, 1, 16, True, 8)]
# the training path's attention shapes at full width (batch 8)
TRAIN_FLASH_FULL = [
    ("internlm2-1.8b", 8, 512, 512, 16, 8, 128, True),
    ("whisper-base encoder", 8, 1500, 1500, 8, 8, 64, False),
    ("whisper-base decoder self", 8, 64, 64, 8, 8, 64, True),
    ("whisper-base cross", 8, 64, 1500, 8, 8, 64, False)]
# mamba2-2.7b's training scan: 512 tokens a row, two chunks of 256, one
# group's B and C over the 80 heads
TRAIN_SSD_FULL = dict(b=8, L=512, H=80, P=64, N=128, chunk=256)
# full width through launch.train: (arch, --seq, reckoned GB of params,
# grads and AdamW's m and v at 16 B a parameter)
TRAIN_RUNS = (("internlm2-1.8b", 512, 30.2), ("mamba2-2.7b", 512, 43.2),
              ("whisper-base", 64, 1.8))
TRAIN_BATCH, TRAIN_STEPS, TRAIN_PROFILED = 8, 6, 3
TRAIN_ARGV = ["--batch", str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS),
              "--log-every", "1", "--profile-step", str(TRAIN_PROFILED)]
# finite differences on internlm2-1.8b in float32: a batch of 2 x 128,
# steps of FD_EPS (and a tenth and ten times it) along the unit gradient
FD_BATCH, FD_SEQ, FD_EPS, FD_TOL = 2, 128, 1e-3, 0.02
# tests/test_system.py::test_microbatch_tenancy_matches_single_shot
MB_LOSS_TOL, MB_PARAM_TOL = 2e-3, 5e-3
# tests/test_system.py::test_train_checkpoint_restart_bitexact
RECOVERY_ATOL = 1e-6
TRAIN_LM_STEPS, TRAIN_LM_DROP = 300, 1.0
TRAIN_LM_ARGV = ["--steps", str(TRAIN_LM_STEPS)]


def reset_kernel_counts() -> None:
    for m in (agg, pa, ssd, fa):
        m.reset_counts()


def mamba_count(cfg) -> int:
    return sum(mixer == "mamba" for mixer, _ in cfg.block_schedule())


def keyless_rows(Sq, Skv, causal, window) -> bool:
    """Whether some query row admits no key under this mask."""
    qp, kp = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return not bool(ok.any(axis=1).all())


def hold_scaled(errs: Errors, name: str, got, want, what: str, tol: float):
    """``got`` against ``want`` at rtol ``tol`` and atol ``tol`` times the
    largest |want|."""
    scale = float(want.float().abs().max()) or 1.0
    errs.hold(name, got.float(), want.float(), what, tol=(tol, tol * scale))


def flash_grads_case(errs: Errors, rng, B, Sq, Skv, Hq, Hkv, D, causal,
                     window, dev, what: str) -> None:
    """``FlashAttentionFn`` on the card (the kernel forward, the
    reference's backward) against autograd through the plain version on
    the same tensors: o, the log-sum-exp, dq, dk, dv; float32 at 2e-3 and
    bfloat16 inputs against float32 on the same rounded numbers.  A case
    with rows that admit no key is held against the reference's own
    backward of the plain forward (its p = exp(s - lse) is 1 there, not
    autograd's 1/Skv)."""
    q0, k0, v0 = flash_case(rng, B, Sq, Skv, Hq, Hkv, D, dev)
    do0 = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D)).astype(
        np.float32)).to(dev)
    keyless = keyless_rows(Sq, Skv, causal, window)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype).requires_grad_() for t in (q0, k0, v0))
        do = do0.to(dtype)
        o = kops.FlashAttentionFn.apply(q, k, v, causal, window)
        grads = torch.autograd.grad(o, (q, k, v), do)
        _, lse = fa.flash_attention(q.detach(), k.detach(), v.detach(),
                                    causal=causal, window=window,
                                    return_lse=True)
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        ow, lw = kref.blockwise_attention(qf, kf, vf, causal=causal,
                                          window=window, return_lse=True)
        if keyless:
            want = blockwise_attention_bwd(qf.detach(), kf.detach(),
                                           vf.detach(), ow.detach(),
                                           lw.detach(), do.float(),
                                           causal=causal,
                                           window=window)
        else:
            want = torch.autograd.grad(ow, (qf, kf, vf), do.float())
        tag = f"{what} {str(dtype)[6:]}"
        bf16 = dtype == torch.bfloat16
        errs.hold(K5, o.detach().float(), ow.detach(), tag + " o",
                  tol=(FLASH_BF16_RTOL, FLASH_BF16_ATOL) if bf16 else None)
        errs.hold(K5, lse, lw.detach(), tag + " lse")
        for n, g, w in zip("qkv", grads, want):
            if bf16:
                hold_scaled(errs, K5B, g, w, f"{tag} d{n}", TRAIN_ATTN_BF16)
            else:
                errs.hold(K5B, g, w, f"{tag} d{n}",
                          tol=(TRAIN_ATTN_GRAD, TRAIN_ATTN_GRAD))


def ssd_grads_case(errs: Errors, rng, b, L, H, P, N, chunk, dev, *,
                   h0: bool, one_group: bool, dtype, what: str) -> None:
    """``SsdChunkedFn`` on the card (the kernel forward, the oracle's
    recomputed backward) against autograd through the chunked oracle on
    the same tensors: y, the state and the grads of x, dt, a, B, C (one
    group's, summed through the stride-0 view) and h0."""
    x, dt, a, Bm, Cm, hh = ssd_case(rng, b, L, H, P, N, dev, dtype=dtype,
                                    one_group=one_group)
    if one_group:                    # the leaves are the group's
        Bm, Cm = Bm[:, :, :1], Cm[:, :, :1]
    dy = torch.from_numpy(rng.standard_normal((b, L, H, P)).astype(
        np.float32)).to(dev, dtype)
    dh = torch.from_numpy(rng.standard_normal((b, H, P, N)).astype(
        np.float32)).to(dev)
    outs = {}
    for side in ("fn", "ref"):
        ins = [t.detach().clone().requires_grad_()
               for t in (x, dt, a, Bm, Cm, hh)]
        Bv, Cv = ((t.expand(-1, -1, H, -1) for t in ins[3:5]) if one_group
                  else ins[3:5])
        h_in = ins[5] if h0 else None
        if side == "fn":
            y, h = kops.SsdChunkedFn.apply(ins[0], ins[1], ins[2], Bv, Cv,
                                           h_in, chunk)
        else:
            y, h = kref.ssd_chunked_ref(ins[0], ins[1], ins[2], Bv, Cv,
                                        chunk, initial_state=h_in)
        wrt = ins if h0 else ins[:5]
        outs[side] = (y, h, torch.autograd.grad((y, h), wrt, (dy, dh)))
    (y, h, g), (yw, hw, gw) = outs["fn"], outs["ref"]
    bf16 = dtype == torch.bfloat16
    tag = f"{what} {str(dtype)[6:]}"
    errs.hold(K6, y.detach(), yw.detach(), tag + " y",
              tol=(SSD_BF16_Y,) * 2 if bf16 else None)
    errs.hold(K6, h.detach(), hw.detach(), tag + " state",
              tol=(SSD_BF16_STATE,) * 2 if bf16 else None)
    for n, gi, wi in zip(("x", "dt", "a", "B", "C", "h0"), g, gw):
        hold_scaled(errs, K6B, gi, wi, f"{tag} d{n}", TRAIN_SSD_GRAD)


def sdpa_fwd_bwd(q, k, v, do, causal):
    """One PyTorch call's forward and backward of the same attention
    (``scaled_dot_product_attention``, used nowhere in the port): the
    library time beside the kernel and the backward."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = sdpa(qt, kt, vt, is_causal=causal,
             enable_gqa=q.shape[2] != k.shape[2])
    return torch.autograd.grad(o, (q, k, v), do.transpose(1, 2))


def train_flash_timed(errs: Errors, rng, dev, name, B, Sq, Skv, Hq, Hkv, D,
                      causal, flush) -> dict:
    """One training attention shape at full width: the Function held in
    float32 and bf16, then (bf16) K5 with and without the log-sum-exp, the
    backward, and scaled_dot_product_attention's forward and backward,
    timed in turns."""
    flash_grads_case(errs, rng, B, Sq, Skv, Hq, Hkv, D, causal, None, dev,
                     f"full width {name}")
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, do = (torch.randn((B, s, h, D), generator=g, device=dev).to(
        torch.bfloat16) for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv),
                                     (Sq, Hq)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = kops.FlashAttentionFn.apply(q, k, v, causal, None)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    turns = {"lse": [], "no_lse": [], "bwd": [], "sdpa": []}
    for _ in range(2):
        turns["lse"].append(cuda_ms(lambda: fa.flash_attention(
            qd, kd, vd, causal=causal, return_lse=True), 10, flush))
        turns["no_lse"].append(cuda_ms(lambda: fa.flash_attention(
            qd, kd, vd, causal=causal), 10, flush))
        turns["bwd"].append(cuda_ms(lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True), 5, flush))
        turns["sdpa"].append(cuda_ms(lambda: sdpa_fwd_bwd(q, k, v, do,
                                                          causal), 5, flush))
    ms = {k_: statistics.median(t) for k_, t in turns.items()}
    ms["plain"] = cuda_ms(lambda: fa.flash_attention_plain(
        qd, kd, vd, causal=causal, return_lse=True), 3, flush)
    bound, by = flash_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, None, 2)
    shape = (f"q ({B}, {Sq}, {Hq}, {D}), k/v ({B}, {Skv}, {Hkv}, {D}) bf16, "
             + ("causal" if causal else "non-causal"))
    say("train", f"K5 {name}: {shape}: with lse {ms['lse']:.4f} ms, without "
                 f"{ms['no_lse']:.4f} ms, backward {ms['bwd']:.4f} ms, "
                 f"scaled_dot_product_attention forward+backward "
                 f"{ms['sdpa']:.4f} ms, plain (with lse) {ms['plain']:.4f} ms, "
                 f"forward bound {bound:.4f} ms by {by}")
    return dict(ms_with_lse=ms["lse"], ms=ms["no_lse"], backward_ms=ms["bwd"],
                library_fwd_bwd_ms=ms["sdpa"], plain_ms=ms["plain"],
                bound_ms=bound, bound_by=by, shape=shape)


def phase_train_kernels(errs: Errors, dev) -> dict:
    """The two autograd Functions on CUDA tensors against autograd through
    the plain versions: the sweeps, then the training path's full-width
    shapes (held in float32 and bf16, then timed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(24)
    n5, n6 = errs.cases[K5B], errs.cases[K6B]
    for B, Sq, Skv, Hq, Hkv, D, causal, window in TRAIN_FLASH_SWEEP:
        flash_grads_case(errs, rng, B, Sq, Skv, Hq, Hkv, D, causal, window,
                         dev, f"grads B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} "
                              f"D{D} causal {causal} window {window}")
    for b, L, H, P, N, chunk in SSD_SWEEP:
        for h0 in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                ssd_grads_case(errs, rng, b, L, H, P, N, chunk, dev, h0=h0,
                               one_group=False, dtype=dtype,
                               what=f"grads b{b} L{L} H{H} P{P} N{N} h0 {h0}")
    for dtype in (torch.float32, torch.bfloat16):
        ssd_grads_case(errs, rng, 2, 128, 6, 16, 32, 64, dev, h0=True,
                       one_group=True, dtype=dtype,
                       what="grads one group's stride-0 B/C")
    say("train", f"Function grads hold: {errs.cases[K5B] - n5} attention "
                 f"(max abs err {errs.abs[K5B]:.3g}) and "
                 f"{errs.cases[K6B] - n6} SSD grad comparisons (max abs err "
                 f"{errs.abs[K6B]:.3g}); attention float32 rtol=atol="
                 f"{TRAIN_ATTN_GRAD}, bf16 {TRAIN_ATTN_BF16} scaled; SSD "
                 f"{TRAIN_SSD_GRAD} scaled")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flash = {name: train_flash_timed(errs, rng, dev, name, *shape,
                                     flush=flush)
             for name, *shape in TRAIN_FLASH_FULL}
    f = TRAIN_SSD_FULL
    for dtype in (torch.float32, torch.bfloat16):
        ssd_grads_case(errs, rng, f["b"], f["L"], f["H"], f["P"], f["N"],
                       f["chunk"], dev, h0=False, one_group=True,
                       dtype=dtype, what="full width mamba2-2.7b")
    x, dt, a, Bm, Cm, _ = ssd_case(rng, f["b"], f["L"], f["H"], f["P"],
                                   f["N"], dev, dtype=torch.bfloat16,
                                   one_group=True)
    ins = [t.detach().clone().requires_grad_()
           for t in (x, dt, a, Bm[:, :, :1], Cm[:, :, :1])]
    Bv, Cv = (t.expand(-1, -1, f["H"], -1) for t in ins[3:])
    y, h = kops.SsdChunkedFn.apply(ins[0], ins[1], ins[2], Bv, Cv, None,
                                   f["chunk"])
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    fwd_ms = cuda_ms(lambda: ssd.ssd_chunked(x, dt, a, Bm, Cm,
                                             chunk=f["chunk"]), 10, flush)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad((y, h), ins, (dy, dh),
                                                 retain_graph=True), 3, flush)
    bound, by = ssd_bound_ms(f["b"], f["L"], f["H"], f["P"], f["N"],
                             f["chunk"], 2, 1)
    say("train", f"K6 mamba2-2.7b training scan x ({f['b']}, {f['L']}, "
                 f"{f['H']}, {f['P']}), N {f['N']}, chunk {f['chunk']}, "
                 f"bf16: forward {fwd_ms:.4f} ms, backward (the oracle "
                 f"recomputed and differentiated) {bwd_ms:.4f} ms, forward "
                 f"bound {bound:.4f} ms by {by}")
    del flush
    return {"flash": flash, "ssd": dict(ms=fwd_ms, backward_ms=bwd_ms,
                                        bound_ms=bound, bound_by=by)}


def capture_grads(opt: Optimizer, store: list) -> Optimizer:
    """``opt`` whose update first keeps a copy of the (clipped) grads it is
    given."""
    def update(grads, state, params, lr):
        store.append(tree_map(lambda t: t.detach().clone(), grads))
        return opt.update(grads, state, params, lr)
    return Optimizer(opt.init, update, opt.state_axes)


def reduced_step(cfg, params, batch, device) -> tuple:
    """One ``build_train_step`` step of ``cfg`` from ``params`` on
    ``device``: (metrics as floats, the clipped grads)."""
    bundle = build_model(cfg)
    grads: list = []
    opt = capture_grads(make_optimizer(cfg), grads)
    step = build_train_step(bundle, None, opt,
                            lr_fn=lambda s: torch.full((), 1e-3))
    state = init_train_state(bundle, opt, tree_map(
        lambda t: t.detach().clone().to(device), params))
    state, m = step(state, {k: torch.from_numpy(v).to(device)
                            for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}, grads[0]


def phase_train_reduced(dev) -> dict:
    """Every arch reduced (float32): one training step on the card against
    the same port model on the CPU (the plain versions), loss at rtol 1e-5
    and every leaf's grad at rtol 1e-3 / atol 1e-5; MoE archs' aux
    non-zero; K5 and K6 launches equal attention or Mamba layers times
    microbatches, and no plain call on the card."""
    from repro_torch.configs import ARCH_IDS
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = build_model(cfg).init(0, "cpu")
        batch = synth_batch(DataConfig(2, 32, cfg.vocab_size), 0, cfg)
        reset_kernel_counts()            # just before the card's step
        m_dev, g_dev = reduced_step(cfg, params, batch, dev)
        torch.cuda.synchronize()
        launches = {K5: fa.launch_counts[K5], K6: ssd.launch_counts[K6],
                    "bwd5": fa.backward_counts["flash_attention_bwd"],
                    "bwd6": ssd.backward_counts["ssd_chunked_bwd"],
                    "plain": sum(fa.plain_counts.values())
                    + sum(ssd.plain_counts.values())}
        m_cpu, g_cpu = reduced_step(cfg, params, batch, "cpu")
        mb = max(1, cfg.microbatches)
        want5, want6 = k5_per_prefill(cfg) * mb, mamba_count(cfg) * mb
        check(launches[K5] == want5 and launches[K6] == want6,
              f"train-reduced {arch}: K5/K6 launches {launches[K5]}/"
              f"{launches[K6]}, want {want5}/{want6}")
        check(launches["bwd5"] == want5 and launches["bwd6"] == want6,
              f"train-reduced {arch}: backward calls {launches['bwd5']}/"
              f"{launches['bwd6']}, want {want5}/{want6}")
        check(launches["plain"] == 0,
              f"train-reduced {arch}: {launches['plain']} plain calls on "
              "the card")
        check(abs(m_dev["loss"] - m_cpu["loss"]) <= 1e-5 * abs(m_cpu["loss"]),
              f"train-reduced {arch}: loss {m_dev['loss']} vs CPU "
              f"{m_cpu['loss']}")
        if cfg.moe is not None:
            check(m_dev["aux"] > 0, f"train-reduced {arch}: MoE aux "
                                    f"{m_dev['aux']} is not positive")
        worst = 0.0
        for gd, gc_ in zip(tree_leaves(g_dev), tree_leaves(g_cpu)):
            gd = gd.cpu()
            worst = max(worst, float((gd - gc_).abs().max()))
            check(bool(torch.allclose(gd, gc_, rtol=1e-3, atol=1e-5)),
                  f"train-reduced {arch}: a grad leaf differs from the "
                  f"CPU's by {float((gd - gc_).abs().max()):.3g}")
        say("train", f"reduced {arch}: loss {m_dev['loss']:.6f} (CPU "
                     f"{m_cpu['loss']:.6f}), aux {m_dev['aux']:.4g}, grad "
                     f"norm {m_dev['grad_norm']:.4f}; every grad leaf within "
                     f"rtol 1e-3 / atol 1e-5 (max abs diff {worst:.3g}); K5 "
                     f"{launches[K5]}, K6 {launches[K6]} launches, backward "
                     f"{launches['bwd5']} / {launches['bwd6']}")
        out[arch] = dict(loss=m_dev["loss"], loss_cpu=m_cpu["loss"],
                         aux=m_dev["aux"], grad_max_abs_diff=worst,
                         launches={K5: launches[K5], K6: launches[K6]})
    return out


def train_run(arch: str, seq: int, reckoned_gb: float, dev) -> dict:
    """``launch.train.main`` at full width and depth: --batch 8, 6 steps,
    step 3 profiled; counts reset just before and read just after."""
    cfg = get_config(arch)
    argv = ["--arch", arch, "--seq", str(seq)] + TRAIN_ARGV
    gc.collect()
    torch.cuda.empty_cache()
    reset_kernel_counts()                # just before the path
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    launches = {K5: fa.launch_counts[K5], K6: ssd.launch_counts[K6]}
    variants = {K5: dict(fa.variant_counts), K6: dict(ssd.variant_counts)}
    bwd = {K5: fa.backward_counts["flash_attention_bwd"],
           K6: ssd.backward_counts["ssd_chunked_bwd"]}
    plain = sum(fa.plain_counts.values()) + sum(ssd.plain_counts.values())
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        say("train", f"{arch}: {line[:400]}")
    check(rc == 0, f"train {arch}: launch.train exited {rc}")
    res = json.loads(lines[-1])["train"]
    remat = 2 if cfg.remat == "full" else 1
    want = {K5: k5_per_prefill(cfg) * remat * TRAIN_STEPS,
            K6: mamba_count(cfg) * remat * TRAIN_STEPS}
    check(launches == want, f"train {arch}: launches {launches}, want {want}")
    check(bwd == {K5: k5_per_prefill(cfg) * TRAIN_STEPS,
                  K6: mamba_count(cfg) * TRAIN_STEPS},
          f"train {arch}: backward calls {bwd}")
    check(all(v["f32_simt"] == 0 for v in variants.values()),
          f"train {arch}: variants {variants}, want bf16_mma only")
    check(plain == 0, f"train {arch}: {plain} plain calls")
    check(res["final_step"] == TRAIN_STEPS and res["steps"] == TRAIN_STEPS,
          f"train {arch}: step counter {res['final_step']}")
    check(all(np.isfinite(res["losses"])), f"train {arch}: a loss is not "
                                           "finite")
    tokens = TRAIN_BATCH * seq
    mfu = (6 * res["params"] * tokens / (res["median_step_ms"] / 1e3)
           / PEAK_BF16_FLOPS)
    prof = res["profile"] or {}
    say("train", f"{arch} full width (batch {TRAIN_BATCH} x {seq}): median "
                 f"step {res['median_step_ms']:.1f} ms (CUDA events, step 1 "
                 f"left out), {res['tokens_per_s']:.0f} tokens/s, model "
                 f"FLOPs share {mfu:.4f} (6 N tokens over the step, N "
                 f"{res['params']:,}, against the bf16 dense peak "
                 f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; remat's recompute "
                 f"not counted), peak memory {res['peak_mem_gb']} GB "
                 f"(reckoned params+grads+m+v {reckoned_gb} GB), device idle "
                 f"share {prof.get('device_idle_share')} in profiled step "
                 f"{TRAIN_PROFILED} ({prof.get('window_ms')} ms), feed wait "
                 f"{res['feed_wait_ms']:.2f} ms over {TRAIN_STEPS} steps; "
                 f"launches {launches}, backward calls {bwd}")
    return dict(res, launches=launches, variants=variants, backward=bwd,
                mfu=mfu, reckoned_gb=reckoned_gb)


def fd_check(dev) -> dict:
    """internlm2-1.8b at full width in float32 (K5's f32_simt): the loss's
    derivative along the unit gradient by central differences against the
    gradient's norm."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b"),
                              compute_dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(0, dev)
    tree_map(lambda t: t.requires_grad_(), params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(FD_BATCH, FD_SEQ, cfg.vocab_size), 0).items()}
    fa.reset_counts()
    loss, _ = bundle.loss_fn(params, batch)
    grads = list(torch.autograd.grad(loss, tree_leaves(params)))
    loss = loss.detach()
    check(fa.variant_counts["f32_simt"] > 0
          and fa.variant_counts["bf16_mma"] == 0,
          f"fd: variants {fa.variant_counts}, want f32_simt")
    gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    ghat = [g / gnorm for g in grads]
    del grads

    @torch.no_grad()
    def loss_at(eps):
        it = iter(ghat)
        shifted = tree_map(lambda p: p.detach() + eps * next(it), params)
        return float(bundle.loss_fn(shifted, batch)[0])

    ratios = {}
    for eps in (FD_EPS / 10, FD_EPS, FD_EPS * 10):
        ratios[eps] = (loss_at(eps) - loss_at(-eps)) / (2 * eps) / gnorm
    say("train", f"finite differences, internlm2-1.8b float32 (batch "
                 f"{FD_BATCH} x {FD_SEQ}): loss {float(loss):.6f}, |g| "
                 f"{gnorm:.6f}; (L(t+e g^) - L(t-e g^)) / 2e / |g| at e = "
                 + ", ".join(f"{e:g}: {r:.6f}" for e, r in ratios.items()))
    check(abs(ratios[FD_EPS] - 1) <= FD_TOL,
          f"fd: ratio {ratios[FD_EPS]:.6f} at eps {FD_EPS} outside "
          f"{FD_TOL}")
    return dict(loss=float(loss), grad_norm=gnorm, eps=FD_EPS,
                ratios={str(k): v for k, v in ratios.items()})


def microbatch_check(dev) -> dict:
    """internlm2-1.8b at full width: one step with 2 tenant microbatches
    against one with 1 on the same batch from the same parameters and a
    constant learning rate; loss within 2e-3, parameters within 5e-3 (the
    two grad norms printed beside)."""
    cfg1 = get_config("internlm2-1.8b")
    cfg2 = dataclasses.replace(cfg1, microbatches=2)
    params = build_model(cfg1).init(0, dev)
    p0 = tree_map(lambda t: t.detach().clone(), params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(TRAIN_BATCH, 512, cfg1.vocab_size), 0).items()}
    lr = lambda s: torch.full((), cfg1.learning_rate, device=dev)
    res, after = {}, None
    for cfg in (cfg1, cfg2):
        if after is not None:
            with torch.no_grad():
                tree_map2(lambda p, q: p.copy_(q), params, p0)
        bundle = build_model(cfg)
        opt = make_optimizer(cfg)
        state = init_train_state(bundle, opt, params)
        _, m = build_train_step(bundle, None, opt, lr_fn=lr)(state,
                                                             batch)
        res[cfg.microbatches] = (float(m["loss"]), float(m["grad_norm"]))
        del state, opt, m
        if after is None:
            after = tree_map(lambda t: t.detach().clone(), params)
    (l1, n1), (l2, n2) = res[1], res[2]
    worst = max(float((a - b.detach()).abs().max()) for a, b in zip(
        tree_leaves(after), tree_leaves(params)))
    ok = all(bool(torch.allclose(a, b.detach(), rtol=MB_PARAM_TOL,
                                 atol=MB_PARAM_TOL))
             for a, b in zip(tree_leaves(after), tree_leaves(params)))
    say("train", f"microbatches 2 vs 1, internlm2-1.8b full width (batch "
                 f"{TRAIN_BATCH} x 512, lr {cfg1.learning_rate}): loss "
                 f"{l2:.6f} vs {l1:.6f}, params max abs diff {worst:.3g}, "
                 f"grad norm {n2:.6f} vs {n1:.6f}")
    check(abs(l1 - l2) < MB_LOSS_TOL, f"microbatches: loss {l2} vs {l1}")
    check(ok, f"microbatches: params differ by {worst:.3g}")
    return dict(loss_1=l1, loss_2=l2, params_max_abs_diff=worst,
                grad_norm_1=n1, grad_norm_2=n2)


def phase_train_recovery(dev) -> dict:
    """``run_with_recovery`` on reduced h2o-danube (sliding window) on the
    card: 6 steps, a checkpoint every 2, a failure injected at step 4; the
    final parameters equal an uninterrupted run's at atol 1e-6."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    bundle = build_model(cfg)
    opt = make_optimizer(cfg)
    step = build_train_step(bundle, None, opt)
    dc = DataConfig(4, 16, cfg.vocab_size)

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in synth_batch(dc, i).items()}

    def fresh():
        return init_train_state(bundle, opt, bundle.init(0, dev))

    ref = fresh()
    for i in range(6):
        ref = step(ref, batch(i))[0]
    crashed = [False]

    def step_fn(state, i):
        if i == 4 and not crashed[0]:
            crashed[0] = True
            raise RuntimeError("injected device loss")
        return step(state, batch(i))[0]

    with tempfile.TemporaryDirectory() as d:
        rep = run_with_recovery(step_fn, fresh(), 6, d, save_every=2,
                                max_failures=2, device=dev)
        final = ckpt.restore(d, 6, ref, device=dev)
    check((rep.steps_done, rep.failures, rep.restarts) == (6, 1, [4]),
          f"recovery: report {rep}")
    diffs = []                       # leaf by leaf, by key
    tree_map2(lambda a, b: diffs.append(float((a.detach() - b).abs().max())),
              ref["params"], final["params"])
    worst = max(diffs)
    check(worst <= RECOVERY_ATOL, f"recovery: params differ by {worst:.3g}")
    say("train", f"recovery (reduced h2o-danube, window {cfg.sliding_window}):"
                 f" {rep}; final params against the uninterrupted run's: max "
                 f"abs diff {worst:.3g} (atol {RECOVERY_ATOL})")
    return dict(steps_done=rep.steps_done, failures=rep.failures,
                restarts=rep.restarts, max_abs_diff=worst)


def phase_train_lm(dev) -> dict:
    """``examples/torch_train_lm.py`` for 300 steps on the card: the loss is
    finite and falls, the mean of the last 10 steps at least 1.0 below the
    mean of the first 10."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf):
        out = mod.main(TRAIN_LM_ARGV + ["--ckpt-dir", d])
    for line in buf.getvalue().strip().splitlines()[:-1]:
        say("train", f"train-lm: {line[:300]}")
    losses = out["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(len(losses) == TRAIN_LM_STEPS and bool(np.isfinite(losses).all()),
          f"train-lm: {len(losses)} losses, finite "
          f"{bool(np.isfinite(losses).all())}")
    check(last <= first - TRAIN_LM_DROP,
          f"train-lm: mean loss {first:.3f} -> {last:.3f}, not "
          f"{TRAIN_LM_DROP} lower")
    say("train", f"train-lm: {TRAIN_LM_STEPS} steps in {out['wall_s']:.1f} s;"
                 f" loss {losses[0]:.3f} -> {losses[-1]:.3f}, mean of the "
                 f"first 10 {first:.3f} -> of the last 10 {last:.3f} (the "
                 "example's docstring: ~10.4 to well under 7)")
    return dict(first10=first, last10=last, loss_first=losses[0],
                loss_last=losses[-1], wall_s=out["wall_s"])


def phase_train(errs: Errors, dev, laps) -> dict:
    """The training phases in order; ``laps(name)`` closes each one's
    seconds."""
    out = {"kernels": phase_train_kernels(errs, dev)}
    laps("train-kernels")
    out["reduced"] = phase_train_reduced(dev)
    laps("train-reduced")
    out["runs"] = {arch: train_run(arch, seq, gb, dev)
                   for arch, seq, gb in TRAIN_RUNS}
    laps("train")
    for name, fn in (("fd", fd_check), ("microbatches", microbatch_check)):
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = fn(dev)
    laps("train checks")
    out["recovery"] = phase_train_recovery(dev)
    laps("train-recovery")
    out["train_lm"] = phase_train_lm(dev)
    laps("train-lm")
    return out


# ---------------------------------------------------------------------------
# the training mesh (slice 6b): internlm2-1.8b at full width on meshes of
# the card repeated against no mesh, olmoe-1b-7b expert-parallel, and the
# int8-compressed all-reduce
# ---------------------------------------------------------------------------
# (mesh or None, fsdp forced on): internlm2's config keeps fsdp off; the
# last run forces it, so the data axis splits the parameters too
TRAIN_MESHES = ((None, False), ("1x1", False), ("1x2", False),
                ("2x1", False), ("2x2", False), ("2x2", True))
TRAIN_MESH_STEPS, TRAIN_MESH_SEQ = 3, 512
TRAIN_MESH_CKPT = "1x2"            # checkpointed, restored with no mesh
# olmoe-1b-7b at its published width, cut to 4 of its 16 layers
EP_ARCH, EP_LAYERS = "olmoe-1b-7b", 4
EP_MESHES = ("1x2", "2x2", "1x8")
EP_STEP_MESHES = ("1x2", "2x2")
EP_STEPS = 3
EP_AMPLE_CF = 8.0                  # E / k: the scatter path drops nothing
# the first MoE layer alone, float32, on the card against the CPU port:
# 8 rows of 64 tokens
EP_LAYER_TOKENS = (8, 64)
EP_LAYER_RTOL = 1e-4               # float32 GEMMs of other shapes
EP_AUX_RTOL = 1e-5
PSUM_MESH = "2x2x2"
PSUM_BLOCK = 256


def placed_equal(want: torch.Tensor, got) -> bool:
    """Every distinct shard of ``got`` equal to its slices of ``want``."""
    if not isinstance(got, ShardedTensor):
        return torch.equal(want, got)
    return all(torch.equal(want[sl], t) for _, t, sl in got.unique())


def mesh_of(spec, dev):
    if spec is None:
        return None
    n = int(np.prod([int(e) for e in spec.split("x")]))
    return parse_mesh(spec, [dev] * n)


def train_mesh_run(cfg, spec, fsdp: bool, batches, dev) -> tuple:
    """``make_state_and_step`` on ``spec``'s mesh of the card (or none) and
    TRAIN_MESH_STEPS steps: (state, result); counts and the peak reset just
    before."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_counts()                # just before the path
    run_cfg = dataclasses.replace(cfg, fsdp=True) if fsdp else cfg
    _, state, step, sh = train_cli.make_state_and_step(
        run_cfg, dev, 0, mesh_of(spec, dev))
    losses, norms, ms = [], [], []
    for batch in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    res = dict(losses=losses, grad_norms=norms, step_ms=ms,
               median_step_ms=statistics.median(ms[1:]),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               launches=fa.launch_counts[K5], variants=dict(fa.variant_counts),
               specs=sorted({str(t.spec) for t in tree_leaves(state["params"])
                             if isinstance(t, ShardedTensor)}))
    return state, res


def phase_train_mesh(dev) -> dict:
    """internlm2-1.8b at published width and depth, batch 8 x 512, remat
    full, AdamW, bf16 compute, seed 0: TRAIN_MESH_STEPS steps with no mesh,
    then on each of TRAIN_MESHES; loss, grad norm and every parameter after
    the steps bit for bit the no-mesh run's; K5 launches = 24 x 2 x steps;
    then the 1x2 state's parameters checkpointed and restored with no mesh,
    bit for bit."""
    cfg = get_config("internlm2-1.8b")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(TRAIN_BATCH, TRAIN_MESH_SEQ, cfg.vocab_size), i).items()}
        for i in range(TRAIN_MESH_STEPS)]
    want5 = k5_per_prefill(cfg) * 2 * TRAIN_MESH_STEPS
    runs, ref_params, ckpt_res = {}, None, None
    for spec, fsdp in TRAIN_MESHES:
        name = (spec or "none") + (" fsdp" if fsdp else "")
        state, res = train_mesh_run(cfg, spec, fsdp, batches, dev)
        check(res["launches"] == want5 and res["variants"]["f32_simt"] == 0
              and not sum(fa.plain_counts.values()),
              f"train-mesh {name}: K5 launches {res['launches']} "
              f"{res['variants']}, want {want5} bf16_mma")
        check(all(np.isfinite(res["losses"])),
              f"train-mesh {name}: losses {res['losses']}")
        if ref_params is None:
            ref_params = state["params"]
            ref_res = res
        else:
            diff = [i for i, (w, g) in enumerate(zip(
                tree_leaves(ref_params), tree_leaves(state["params"])))
                if not placed_equal(w, g)]
            res["params_bitwise"] = not diff
            check(res["losses"] == ref_res["losses"]
                  and res["grad_norms"] == ref_res["grad_norms"],
                  f"train-mesh {name}: losses {res['losses']} / norms "
                  f"{res['grad_norms']} against no mesh's "
                  f"{ref_res['losses']} / {ref_res['grad_norms']}")
            check(not diff, f"train-mesh {name}: {len(diff)} parameter "
                            "leaves differ from no mesh's")
        say("train-mesh", f"internlm2-1.8b {name}: losses {res['losses']}, "
                          f"grad norms {res['grad_norms']}, step ms "
                          f"{[round(x, 2) for x in res['step_ms']]} (median "
                          f"of steps 2-3 {res['median_step_ms']:.2f}), peak "
                          f"{res['peak_gib']:.2f} GiB, K5 {res['launches']}"
                          + (", bit for bit no mesh's losses, norms and "
                             "every parameter" if spec else ""))
        if spec == TRAIN_MESH_CKPT and not fsdp:
            del state["opt"]
            ckpt_res = train_mesh_checkpoint(state, ref_params, dev)
        runs[name] = res
        del state
    return {"runs": runs, "checkpoint": ckpt_res,
            "launches": {f"internlm2-1.8b train-mesh {k}": {
                K3: 0, K4: 0, K5: r["launches"]} for k, r in runs.items()}}


def train_mesh_checkpoint(state, ref_params, dev) -> dict:
    """The placed parameters and step written (global tensors), restored
    with no mesh onto the card: bit for bit the placed ones."""
    tree = {"params": state["params"], "step": state["step"]}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, TRAIN_MESH_STEPS, tree)
        t1 = time.perf_counter()
        back = ckpt.restore(d, TRAIN_MESH_STEPS,
                            {"params": ref_params, "step": state["step"]},
                            device=dev)
        t2 = time.perf_counter()
    pairs = []
    tree_map2(lambda g, b: pairs.append((g, b)), tree["params"],
              back["params"])
    ok = all(placed_equal(b, g) for g, b in pairs)
    ok = ok and int(back["step"]) == int(state["step"])
    check(ok, "train-mesh checkpoint: a restored leaf differs")
    nbytes = sum(int(b.numel()) * b.element_size() for _, b in pairs)
    say("train-mesh", f"checkpoint of the {TRAIN_MESH_CKPT} state's "
                      f"parameters ({nbytes / 1e9:.2f} GB as global "
                      f"tensors) written in {t1 - t0:.1f} s, restored with "
                      f"no mesh in {t2 - t1:.1f} s, bit for bit")
    return dict(bytes=nbytes, save_s=t1 - t0, restore_s=t2 - t1,
                bitwise=ok)


def ep_config(cf: float, compute="bfloat16"):
    cfg = get_config(EP_ARCH)
    return dataclasses.replace(
        cfg, num_layers=EP_LAYERS, compute_dtype=compute,
        moe=dataclasses.replace(cfg.moe, dispatch="ep", capacity_factor=cf))


@contextlib.contextmanager
def routed_losses(store: list):
    """Every routed layer's {"moe_aux", "moe_z"} appended to ``store``."""
    orig = moe_mod.apply_moe

    def rec(*args, **kw):
        y, losses = orig(*args, **kw)
        store.append({k: v.detach() for k, v in losses.items()})
        return y, losses
    moe_mod.apply_moe = rec
    try:
        yield
    finally:
        moe_mod.apply_moe = orig


def ep_layer_check(dev) -> dict:
    """The first MoE layer of olmoe-1b-7b at full width in float32 at
    capacity factor 8 on EP_LAYER_TOKENS: the card's EP at each of
    EP_MESHES against the CPU port's EP on the same inputs (the CPU tests
    hold that against the reference's apply_moe_ep): output at
    EP_LAYER_RTOL, aux and z at EP_AUX_RTOL, dropped choices equal; the
    gradients at 2x2 too."""
    cfg = ep_config(EP_AMPLE_CF, "float32")
    gen = torch.Generator(device="cpu").manual_seed(0)
    p_cpu = moe_mod.init_moe(gen, cfg, "cpu")
    x_cpu = torch.randn(*EP_LAYER_TOKENS, cfg.d_model, generator=gen)
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    out = {}
    for spec in EP_MESHES:
        res = {}
        grads = spec == "2x2"
        for where, p, x, mesh in (
                ("card", p_dev, x_cpu.to(dev), mesh_of(spec, dev)),
                ("cpu", p_cpu, x_cpu, mesh_of(spec, torch.device("cpu")))):
            q = {k: v.clone().requires_grad_(grads) for k, v in p.items()}
            moe_mod.dropped_log = []
            with torch.set_grad_enabled(grads):
                y, losses = moe_mod.apply_moe(q, x, cfg, Sharder(mesh))
            dropped = int(moe_mod.dropped_log[0])
            moe_mod.dropped_log = None
            g = (torch.autograd.grad(torch.sum(y ** 2) + sum(
                losses.values()), list(q.values())) if grads else ())
            res[where] = (y.detach().cpu(), {k: float(v.detach()) for k, v
                                             in losses.items()}, dropped,
                          [t.cpu() for t in g])
        (yd, ld, nd, gd), (yc, lc, nc, gc_) = res["card"], res["cpu"]
        err = float((yd - yc).abs().max() / yc.abs().max())
        check(err <= EP_LAYER_RTOL, f"train-ep layer {spec}: output differs "
                                    f"by {err:.3g} of its largest")
        for k in lc:
            check(abs(ld[k] - lc[k]) <= EP_AUX_RTOL * abs(lc[k]),
                  f"train-ep layer {spec}: {k} {ld[k]} vs CPU {lc[k]}")
        check(nd == nc, f"train-ep layer {spec}: dropped {nd} vs CPU {nc}")
        gerr = max((float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(gd, gc_)), default=None)
        if gerr is not None:
            check(gerr <= EP_LAYER_RTOL, f"train-ep layer {spec}: grads "
                                         f"differ by {gerr:.3g}")
        out[spec] = dict(max_rel_err=err, aux=ld, dropped=nd,
                         choices=int(np.prod(EP_LAYER_TOKENS)) * cfg.moe.top_k,
                         grad_max_rel_err=gerr)
        say("train-ep", f"first MoE layer float32, {EP_LAYER_TOKENS} tokens, "
                        f"capacity factor {EP_AMPLE_CF}, EP {spec} on the "
                        f"card against the CPU port: output within {err:.3g}"
                        f" of its largest, aux/z {ld} (CPU {lc}), dropped "
                        f"choices {nd} of {out[spec]['choices']} on both"
                        + (f", grads within {gerr:.3g}" if gerr else ""))
    return out


def ep_forward_backward(cfg, params, batch, sh) -> dict:
    """Loss, per-layer aux and z, dropped choices, the final logits and
    every gradient of one forward and backward (the training forward under
    remat, then a forward for the logits)."""
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    store: list = []
    moe_mod.dropped_log = []
    reset_kernel_counts()
    bundle = build_model(cfg)
    with routed_losses(store):
        loss, metrics = bundle.loss_fn(params, batch, sh)
    dropped = [int(t) for t in moe_mod.dropped_log]
    moe_mod.dropped_log = None
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        x = model_mod._embed(params, batch, cfg)
        h, _, _ = transformer.lm_backbone(params, x, cfg, sh)
        logits = apply_unembed(params["embed"], h, cfg)[
            ..., :cfg.vocab_size]      # not the padded columns' -1e30
    for t in leaves:
        t.requires_grad_(False)
    torch.cuda.synchronize()
    want5 = k5_per_prefill(cfg) * 3          # remat's two and the logits'
    check(fa.launch_counts[K5] == want5 and not sum(fa.plain_counts.values()),
          f"train-ep: K5 launches {fa.launch_counts[K5]}, plain "
          f"{fa.plain_counts}, want {want5}")
    return dict(loss=float(loss.detach()),
                losses=[{k: float(v) for k, v in d.items()} for d in store],
                dropped=dropped, logits=logits, grads=grads,
                launches=fa.launch_counts[K5])


def ep_model_check(dev) -> dict:
    """The 4-layer model at full width, bf16, capacity factor 8, batch 8 x
    512: the scatter path with no mesh, then EP at each of EP_MESHES;
    loss, final logits (per row, against its largest), per-layer aux and z
    and every gradient (against the leaf's largest) measured against
    scatter's; the first layer's aux and z held at EP_AUX_RTOL (its input
    is the same).  Not held beyond: the reference's EP counts empty
    exchange slots into local expert 0's capacity, so it drops choices
    where scatter drops none (the layer check holds EP itself)."""
    cfg = ep_config(EP_AMPLE_CF)
    params = build_model(cfg).init(0, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(TRAIN_BATCH, TRAIN_MESH_SEQ, cfg.vocab_size), 0).items()}
    base = ep_forward_backward(cfg, params, batch, Sharder(None))
    check(sum(base["dropped"]) == 0,
          f"train-ep: scatter dropped {base['dropped']} at factor "
          f"{EP_AMPLE_CF}")
    out = {"scatter": dict(loss=base["loss"], losses=base["losses"],
                           launches=base["launches"])}
    for spec in EP_MESHES:
        gc.collect()
        torch.cuda.empty_cache()
        r = ep_forward_backward(cfg, params, batch, Sharder(
            mesh_of(spec, dev), fsdp=cfg.fsdp))
        rows = ((r["logits"] - base["logits"]).abs().amax(-1)
                / base["logits"].abs().amax(-1))
        logit_err = float(rows.max())
        grad_err = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(r["grads"], base["grads"]))
        aux_err = [{k: abs(e[k] - w[k]) / abs(w[k]) for k in w}
                   for e, w in zip(r["losses"], base["losses"])]
        first = aux_err[0]
        check(all(v <= EP_AUX_RTOL for v in first.values()),
              f"train-ep {spec}: first layer aux/z off by {first}")
        n_choice = TRAIN_BATCH * TRAIN_MESH_SEQ * cfg.moe.top_k
        check(np.isfinite(r["loss"]), f"train-ep {spec}: loss {r['loss']}")
        out[spec] = dict(loss=r["loss"], loss_scatter=base["loss"],
                         logit_max_rel=logit_err,
                         logit_rows_over_bound=int((rows > LOGIT_BF16_TOL)
                                                   .sum()),
                         grad_max_rel=grad_err, aux_rel_err=aux_err,
                         dropped=r["dropped"], choices_a_layer=n_choice,
                         launches=r["launches"])
        say("train-ep", f"olmoe {EP_LAYERS} layers, factor {EP_AMPLE_CF}, EP "
                        f"{spec} against scatter with no mesh: loss "
                        f"{r['loss']:.6f} vs {base['loss']:.6f}; logits "
                        f"within {logit_err:.3g} of a row's largest "
                        f"({out[spec]['logit_rows_over_bound']} of "
                        f"{rows.numel()} rows over {LOGIT_BF16_TOL}); grads "
                        f"within {grad_err:.3g} of a leaf's largest; aux/z "
                        f"relative errors by layer {aux_err}; EP dropped "
                        f"{r['dropped']} of {n_choice} choices a layer "
                        f"(two forwards: the loss's, the logits')")
        del r
    del params, base
    return out


def ep_step_runs(dev) -> dict:
    """At the published capacity factor 1.25: EP_STEPS AdamW steps through
    ``make_state_and_step`` at each of EP_STEP_MESHES and with no mesh
    (scatter); losses finite, dropped choices a step, step ms."""
    cfg = ep_config(get_config(EP_ARCH).moe.capacity_factor)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(TRAIN_BATCH, TRAIN_MESH_SEQ, cfg.vocab_size), i).items()}
        for i in range(EP_STEPS)]
    out = {}
    for spec in (None,) + EP_STEP_MESHES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_kernel_counts()
        _, state, step, sh = train_cli.make_state_and_step(
            cfg, dev, 0, mesh_of(spec, dev))
        losses, ms, dropped = [], [], []
        for batch in batches:
            moe_mod.dropped_log = []
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = step(state, batch)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            losses.append(float(m["loss"]))
            # remat full: each routed layer runs twice a step
            dropped.append(sum(int(t) for t in moe_mod.dropped_log) // 2)
            moe_mod.dropped_log = None
        name = spec or "none (scatter)"
        check(all(np.isfinite(losses)), f"train-ep steps {name}: {losses}")
        want5 = k5_per_prefill(cfg) * 2 * EP_STEPS
        check(fa.launch_counts[K5] == want5
              and not sum(fa.plain_counts.values()),
              f"train-ep steps {name}: K5 launches {fa.launch_counts[K5]}, "
              f"want {want5}")
        check(sh.mesh is None or moe_mod.ep_applies(
            (TRAIN_BATCH, TRAIN_MESH_SEQ), cfg, sh),
            f"train-ep steps {name}: EP not taken")
        out[name] = dict(losses=losses, step_ms=ms,
                         median_step_ms=statistics.median(ms[1:]),
                         dropped_a_step=dropped,
                         choices_a_step=TRAIN_BATCH * TRAIN_MESH_SEQ
                         * cfg.moe.top_k * EP_LAYERS,
                         peak_gib=torch.cuda.max_memory_allocated(dev)
                         / 2**30, launches=fa.launch_counts[K5])
        say("train-ep", f"olmoe {EP_LAYERS} layers, factor "
                        f"{cfg.moe.capacity_factor}, {name}: losses "
                        f"{losses}, step ms {[round(x, 1) for x in ms]}, "
                        f"dropped choices a step {dropped} of "
                        f"{out[name]['choices_a_step']}, peak "
                        f"{out[name]['peak_gib']:.2f} GiB")
        del state, step
    return out


def phase_train_ep(dev) -> dict:
    out = {"layer": ep_layer_check(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["model"] = ep_model_check(dev)
    out["steps"] = ep_step_runs(dev)
    launches = {f"{EP_ARCH} train-ep {part} {k}": {K3: 0, K4: 0,
                                                   K5: r["launches"]}
                for part in ("model", "steps")
                for k, r in out[part].items()}
    return dict(out, launches=launches)


def phase_compressed_psum(dev) -> dict:
    """A float32 tensor of internlm2-1.8b's token-embedding shape on each
    position of a 2x2x2 ("pod", "data", "model") mesh of the card, reduced
    over "pod" by ``compressed_psum``: every position's result against the
    CPU port's on the same inputs, bit for bit (or the ulps by which they
    differ); its ms; the payload a position would send."""
    cfg = get_config("internlm2-1.8b")
    shape = (cfg.vocab_size, cfg.d_model)
    mesh = mesh_of(PSUM_MESH, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    locs = [torch.randn(shape, generator=gen, device=dev) * (p + 1)
            for p in range(mesh.size)]
    st = ShardedTensor.from_locals(mesh, (None, None), locs)
    got = gcomp.compressed_psum(st, "pod", PSUM_BLOCK)
    torch.cuda.synchronize()
    cpu_mesh = Mesh([torch.device("cpu")] * mesh.size,
                    tuple(mesh.shape.values()), mesh.axis_names)
    want = gcomp.compressed_psum(ShardedTensor.from_locals(
        cpu_mesh, (None, None), [t.cpu() for t in locs]), "pod", PSUM_BLOCK)
    ulps = 0
    for a, b in zip(got.locals, want.locals):
        a = a.cpu()
        if not torch.equal(a, b):
            ulps = max(ulps, int((a.view(torch.int32).long()
                                  - b.view(torch.int32).long()).abs().max()))
    check(ulps == 0, f"compressed-psum: card differs from the CPU by up to "
                     f"{ulps} ulps")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: gcomp.compressed_psum(st, "pod", PSUM_BLOCK), 5,
                 flush)
    n = int(np.prod(shape))
    payload = n + 4 * -(-n // PSUM_BLOCK)
    say("compressed-psum", f"{shape} float32 on {PSUM_MESH} over 'pod': "
                           f"every position bit for bit the CPU port's; "
                           f"{ms:.3f} ms for all 8 positions (4 groups of "
                           f"2); a position would send {payload:,} B "
                           f"({payload / (4 * n):.4f} of its float32 "
                           "bytes)")
    del locs, st, got, flush
    torch.cuda.empty_cache()
    return dict(shape=shape, bitwise=True, ms=ms, payload_bytes=payload,
                float32_bytes=4 * n)



# ---------------------------------------------------------------------------
# slice 7: the slot schedules under --mesh, the dry-run, olmoe at full depth
# ---------------------------------------------------------------------------
SLOT_MESH_ARCH, SLOT_MESH_PROMPT = "internlm2-1.8b", 128
SLOT_MESHES = (None, "1x1", "1x2", "1x8")
# at 1x2 overlapped beside no mesh: whisper's cross K/V split too, mamba2's
# SSM states whole (its prefills through K6)
SLOT_MESH_ALSO = ((WHISPER, WHISPER_PROMPT), ("mamba2-2.7b", 384))
SLOT_MESH_STEPS = 4                # decode steps of the logits check
OLMOE_ARCH = "olmoe-1b-7b"
OLMOE_TRAIN_STEPS = 3
DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_RISK = "risk_1m_t8"


def slot_mesh_logits(dev) -> dict:
    """internlm2-1.8b at full width from one parameter tree: a (4, 128)
    prefill and SLOT_MESH_STEPS decode steps fed the no-mesh run's greedy
    tokens, on engines with no mesh and on each of SLOT_MESHES: the logits
    of every step bit for bit at 1x1, their largest difference at 1x2 and
    1x8; then three dispatches of one key on the 1x8 engine, the third (a
    replay) under ``set_sync_debug_mode("error")``."""
    cfg = get_config(SLOT_MESH_ARCH)
    params = build_model(cfg).init(0, dev)
    prompts = np.random.default_rng(7).integers(
        1, cfg.vocab_size, (4, SLOT_MESH_PROMPT)).astype(np.int32)
    ref, toks, out = None, [], {}
    for spec in SLOT_MESHES:
        sh = serving_sharder(mesh_of(spec, dev)) if spec else None
        eng = ServingEngine(cfg, params, device=dev, sh=sh)
        with torch.no_grad():
            logits, caches, idx = eng.prefill(eng._make_batch(prompts, None))
            got = [logits]
            for i in range(SLOT_MESH_STEPS):
                if ref is None:
                    toks.append(torch.argmax(logits, dim=-1)[:, None])
                logits, caches = eng.bundle.decode_fn(
                    eng.params, toks[i], caches, idx + i, eng.sh)
                got.append(logits)
        if spec is not None:
            split = [t for t in tree_leaves(caches)
                     if isinstance(t, ShardedTensor)]
            check(len(split) == 2 and all(
                len(t.distinct()) == int(spec.split("x")[1]) for t in split),
                f"slot mesh {spec}: {len(split)} split cache leaves")
        if ref is None:
            ref = got
        else:
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(ref, got))
            out[spec] = {"logits_max_abs_diff": diff,
                         "bitwise": all(torch.equal(a, b)
                                        for a, b in zip(ref, got))}
            if spec == "1x1":
                check(out[spec]["bitwise"], f"slot mesh 1x1: logits differ "
                                            f"from no mesh's by {diff}")
        if spec == SLOT_MESHES[-1]:
            handles = [eng.dispatch(prompts, 8) for _ in range(2)]
            torch.cuda.synchronize(dev)
            torch.cuda.set_sync_debug_mode("error")
            try:
                handles.append(eng.dispatch(prompts, 8))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            res = [eng.await_result(h).tokens for h in handles]
            check(all(np.array_equal(res[0], r) for r in res[1:])
                  and sum(c.replays for c in
                          eng.decode_program.loops.values()) == 2,
                  f"slot mesh {spec}: dispatches under sync debug")
            out[spec]["dispatch_tokens"] = res[0][:, :4].tolist()
        del eng, caches, logits, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_serve_slots_mesh(dev) -> dict:
    """The slot schedules on a mesh of the one card (``launch.serve
    --mesh``): internlm2-1.8b at full width, overlapped and blocking, with
    no mesh and on 1x1, 1x2 and 1x8, 12 requests of 3 tenants, 4 a slot;
    every run's tokens equal the no-mesh overlapped run's, each run's
    decode ms a slot by CUDA events and its peak; SLOT_MESH_ALSO at 1x2
    overlapped against no mesh; then the logits
    (:func:`slot_mesh_logits`).  No gain is claimed: every shard's work
    queues on the one card."""
    runs = {}
    for mode in ("overlapped", "blocking"):
        for spec in SLOT_MESHES:
            runs[f"{SLOT_MESH_ARCH} {mode} {spec or 'none'}"] = \
                serve_slots_once(SLOT_MESH_ARCH, SLOT_MESH_PROMPT, mode, dev,
                                 mesh=spec)
    for arch, prompt_len in SLOT_MESH_ALSO:
        for spec in (None, "1x2"):
            runs[f"{arch} overlapped {spec or 'none'}"] = serve_slots_once(
                arch, prompt_len, "overlapped", dev, mesh=spec)
    for arch in (SLOT_MESH_ARCH,) + tuple(a for a, _ in SLOT_MESH_ALSO):
        base = runs[f"{arch} overlapped none"]["tokens"]
        for name, r in runs.items():
            if name.startswith(arch):
                check(set(r["tokens"]) == set(base) and all(
                    np.array_equal(r["tokens"][k], base[k]) for k in base),
                    f"serve-slots-mesh {name}: tokens differ from the "
                    "no-mesh overlapped run's")
    logits = slot_mesh_logits(dev)
    for r in runs.values():
        r.pop("tokens")
    say("serve-slots-mesh", "tokens equal across meshes and modes; logits "
        + ", ".join(f"{k}: {v['logits_max_abs_diff']:.4g}"
                    + (" (bit for bit)" if v["bitwise"] else "")
                    for k, v in logits.items()))
    return {"runs": runs, "logits": logits,
            "launches": {f"{n} slots mesh": {K3: 0, K4: 0,
                                             K5: r["launches"].get(K5, 0)}
                         for n, r in runs.items()
                         if r["launches"].get(K5)},
            "k6_launches": {f"{n} slots mesh": r["launches"][K6]
                            for n, r in runs.items()
                            if r["launches"].get(K6)}}


def olmoe_train_reckoning(cfg) -> dict:
    """Bytes of olmoe's training state with the given optimizer, leaf by
    leaf from the meta tree: float32 parameters and gradients, the
    optimizer's state, the largest whole-leaf float32 temporary."""
    params = build_model(cfg).init(0, "meta")
    opt = make_optimizer(cfg)
    st = opt.init(params)
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_leaves(tree))
    leaves = tree_leaves(params)
    largest = max(t.numel() * 4 for t in leaves)
    out = {"params": nbytes(params), "grads": nbytes(params),
           "momentum": nbytes(st.get("m", {})),
           "second_moment": nbytes(st["v"]), "largest_leaf": largest,
           "largest_stage_slice": max(t[0].numel() * 4 for t in leaves
                                      if t.dim() >= 3)}
    out["state"] = (out["params"] + out["grads"] + out["momentum"]
                    + out["second_moment"])
    # the gradients are allocated before the forward and filled a stage at
    # a time; the norm and the update walk a stacked leaf a stage slice at
    # a time: beside the state, the activations (not reckoned here) and a
    # few stage slices
    out["reckoned_peak"] = out["state"] + 2 * out["largest_stage_slice"]
    return out


def phase_train_olmoe(dev) -> dict:
    """olmoe-1b-7b at published width and depth with the reference's
    Adafactor (``optimizer="adafactor"``: AdamW's 110.7 GB of state does
    not fit), ``launch.train``'s state and step, batch 8 x 512, remat full,
    bf16 compute, seed 0, OLMOE_TRAIN_STEPS steps: losses finite, step ms
    by CUDA events, the peak beside the reckoning, K5 = 16 x 2 a step;
    the live state's bytes for the dry-run's check."""
    cfg = dataclasses.replace(get_config(OLMOE_ARCH), optimizer="adafactor")
    reck = olmoe_train_reckoning(cfg)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(TRAIN_BATCH, TRAIN_MESH_SEQ, cfg.vocab_size), i).items()}
        for i in range(OLMOE_TRAIN_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_counts()                # just before the path
    _, state, step, _ = train_cli.make_state_and_step(cfg, dev, 0)
    live = sum(t.numel() * t.element_size() for t in tree_leaves(state)) \
        + sum(t.numel() * t.element_size() for t in batches[0].values())
    init_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    losses, ms, per_step = [], [], []
    for batch in batches:
        n0 = fa.launch_counts[K5]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        per_step.append(fa.launch_counts[K5] - n0)
    peak = torch.cuda.max_memory_allocated(dev)
    want = k5_per_prefill(cfg) * 2
    check(all(np.isfinite(losses)), f"train-olmoe: losses {losses}")
    check(per_step == [want] * OLMOE_TRAIN_STEPS
          and fa.variant_counts["f32_simt"] == 0
          and not sum(fa.plain_counts.values()),
          f"train-olmoe: K5 a step {per_step} (want {want}), variants "
          f"{dict(fa.variant_counts)}")
    res = dict(optimizer=cfg.optimizer, batch=TRAIN_BATCH,
               seq=TRAIN_MESH_SEQ, losses=losses, step_ms=ms,
               median_step_ms=statistics.median(ms[1:]),
               peak_gib=peak / 2**30, peak_bytes=peak, init_peak_gib=init_gib,
               reckoning_gib={k: v / 2**30 for k, v in reck.items()},
               live_state_bytes=live, k5_per_step=per_step,
               launches={f"{OLMOE_ARCH} train full depth": {
                   K3: 0, K4: 0, K5: sum(per_step)}})
    say("train-olmoe", f"{OLMOE_ARCH} 16 layers, Adafactor, batch "
        f"{TRAIN_BATCH} x {TRAIN_MESH_SEQ}: losses {losses}, step ms "
        f"{[round(x, 2) for x in ms]}, peak {res['peak_gib']:.2f} GiB "
        f"against the reckoned {res['reckoning_gib']['reckoned_peak']:.2f} "
        f"(state {res['reckoning_gib']['state']:.2f}), K5 {per_step}")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_dryrun(olmoe: dict, dev) -> dict:
    """``launch/dryrun.py`` on the meta device from this host: one pod cell
    of each kind for internlm2-1.8b (no aux reckonings) and the risk cell
    DRYRUN_RISK, each record ``ok`` with the reference's memory, cost and
    collective keys; the reckoned parameter, optimizer-state, step and
    batch bytes of the train-olmoe phase's own configuration on a 1x1 meta
    mesh equal that phase's live state on the card, byte for byte; no
    CUDA memory allocated meanwhile."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    alloc0 = torch.cuda.memory_allocated(dev)
    recs = {}
    for shape in DRYRUN_SHAPES:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(DRYRUN_ARCH, shape, False, exact_costs=False)
        check(rec["status"] == "ok" and rec["memory"]["argument_bytes"] > 0
              and rec["cost"]["flops"] > 0,
              f"dryrun {DRYRUN_ARCH} {shape}: {rec.get('status')}")
        rec["wall_s"] = time.perf_counter() - t0
        recs[shape] = rec
    recs[DRYRUN_RISK] = dryrun.lower_risk_cell(DRYRUN_RISK, False)
    cfg = dataclasses.replace(get_config(OLMOE_ARCH), optimizer="adafactor")
    one = Sharder(Mesh([torch.device("meta")], (1, 1), ("data", "model")),
                  fsdp=cfg.fsdp, seq_shard=cfg.fsdp)
    cell = ShapeCell("train_olmoe", TRAIN_MESH_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    olmoe_rec = dryrun.reckon(cfg, cell, one)
    olmoe_rec["wall_s"] = time.perf_counter() - t0
    args = olmoe_rec["memory"]["argument_bytes"]
    check(args == olmoe["live_state_bytes"],
          f"dryrun: reckoned train-olmoe arguments {args} B against "
          f"{olmoe['live_state_bytes']} B live on the card")
    check(torch.cuda.memory_allocated(dev) == alloc0,
          "dryrun: CUDA memory allocated")
    recs["olmoe train 1x1"] = olmoe_rec
    say("dryrun", "; ".join(
        f"{k}: args {r['memory']['argument_bytes']:,} B, temp "
        f"{r['memory']['temp_bytes']:,} B, flops {r['cost']['flops']:.4g}"
        for k, r in recs.items()) + f"; train-olmoe's live state {args:,} B"
        " equal")
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    laps, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    try:
        card = phase_device()
        phase_build()
        lap("device, build")
        errs = Errors()
        phase_kernels_small(errs, dev)
        phase_paged_small(errs, dev)
        phase_ssd_small(errs, dev)
        phase_flash_small(errs, dev)
        lap("kernel sweeps")
        cfg = RiskAppConfig()
        tables = phase_tables(cfg)
        trials = tables.num_trials
        cfg = dataclasses.replace(cfg, num_trials=trials)
        lap("tables")
        kern = phase_kernels_full(errs, tables, dev)
        main_path = phase_main_gather(cfg, tables, dev)
        lap("risk kernels, main path")
        loop = risk_loop(cfg, tables, dev, card)
        lap("power, fit, pairs")
        mesh_risk = phase_mesh_risk(cfg, tables, dev)
        lap("mesh risk")
        del tables                       # 4 GB of pinned host memory
        onehot = phase_main_onehot(errs, cfg, dev)
        phase_cli()
        lap("onehot, cli")
        reduced = phase_serve_reduced(dev)
        lap("serve reduced")
        serving = phase_serve_full(errs, dev)
        serve_obs = phase_serve_obs(dev, serving.pop("plane_off"))
        kern.update(phase_paged_full(errs, dev, serving["max_blocks"]))
        kern[K3]["chat_round"] = phase_paged_chat(errs, dev)
        lap("serve internlm2, serve-obs, paged full")
        mamba = phase_serve_mamba2(dev)
        kern.update(phase_ssd_full(errs, dev))
        lap("serve mamba2, ssd full")
        olmoe = phase_serve_olmoe(dev)
        kern[K3]["olmoe_group1"] = phase_paged_olmoe(
            errs, dev, olmoe["run"]["max_blocks"])
        kern.update(phase_flash_full(errs, dev))
        lap("serve olmoe, paged olmoe, flash full")
        slots = phase_serve_slots(dev)
        lap("serve-slots")
        archs = phase_serve_archs(errs, dev)
        kern[K3]["layouts"] = archs["runs"].pop("paged_layouts")
        kern[K6]["jamba"] = archs["runs"].pop("ssd_jamba")
        lap("serve-archs")
        whisper = phase_serve_whisper(errs, dev)
        wk = whisper.pop("kernels")
        kern[K3][WHISPER] = wk["paged"][K3]
        kern[K4][WHISPER] = {k.split()[-1]: v for k, v in wk["paged"].items()
                             if k.startswith(K4)}
        kern[K5][WHISPER] = wk["flash"]
        lap("serve-whisper")
        overload = phase_serve_overload(
            dev, main_path["runs"]["1x1"]["h2d_gbps"])
        lap("serve-overload")
        crash = phase_serve_crash(dev)
        lap("serve-crash")
        mesh = phase_mesh(errs, dev)
        kern[K3]["mesh"] = mesh["kernels"]
        lap("mesh")
        train = phase_train(errs, dev, lap)
        train_mesh = phase_train_mesh(dev)
        lap("train-mesh")
        train_ep = phase_train_ep(dev)
        lap("train-ep")
        psum = phase_compressed_psum(dev)
        lap("compressed-psum")
        slots_mesh = phase_serve_slots_mesh(dev)
        lap("serve-slots-mesh")
        train_olmoe = phase_train_olmoe(dev)
        lap("train-olmoe")
        dry = phase_dryrun(train_olmoe, dev)
        lap("dryrun")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    say("kernels", f"held against plain versions: gather {errs.cases[G]} cases "
                   f"(max abs err {errs.abs[G]:.3g}, max rel err "
                   f"{errs.rel[G]:.3g}), its row pass {errs.cases[R]} cases "
                   f"bit for bit, onehot {errs.cases[O]} cases (max abs "
                   f"err {errs.abs[O]:.3g}, max rel err {errs.rel[O]:.3g}); "
                   f"tolerance rtol={RTOL} atol={ATOL} (summation order); "
                   f"paged decode {errs.cases[K3]} cases (max abs err "
                   f"{errs.abs[K3]:.3g}, max rel err {errs.rel[K3]:.3g}; "
                   f"rtol={PAGED_RTOL} atol={PAGED_ATOL}), paged scatter and "
                   f"admission {errs.cases[K4]} cases bit-exact, SSD scan "
                   f"{errs.cases[K6]} cases (max abs err {errs.abs[K6]:.3g}; "
                   f"float32 rtol=atol={SSD_RTOL}, bfloat16 y {SSD_BF16_Y} "
                   f"and state {SSD_BF16_STATE}), flash attention "
                   f"{errs.cases[K5]} cases (max abs err {errs.abs[K5]:.3g}; "
                   f"float32 rtol=atol={FLASH_RTOL}, bfloat16 "
                   f"rtol={FLASH_BF16_RTOL} atol={FLASH_BF16_ATOL})")
    agg_src = "src/repro_torch/kernels/csrc/aggregate_loss.cu"
    paged_src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    ssd_src = "src/repro_torch/kernels/csrc/ssd_scan.cu"
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    # launches on the serving paths, each read just after its own run
    arch_paths = {**archs["launches"], **whisper["launches"],
                  **overload["launches"]}
    paths = {"internlm2-1.8b": serving["launches"],
             "olmoe-1b-7b": olmoe["launches"],
             **{f"{a} slots": {K3: 0, K4: 0, **n}
                for a, n in slots["launches"].items() if n[K5]},
             **{a: {K3: n.get(K3, 0), K4: n.get(K4, 0), K5: n[K5]}
                for a, n in arch_paths.items() if n.get(K5)}}
    k6_paths = {"mamba2-2.7b": mamba["launches"],
                "mamba2-2.7b slots": slots["launches"]["mamba2-2.7b"][K6],
                **{a: n[K6] for a, n in arch_paths.items() if n.get(K6)}}
    # the training path: launch.train at full width, forward and remat
    train_paths = {f"{a} train": r["launches"]
                   for a, r in train["runs"].items()}
    paths.update({a: {K3: 0, K4: 0, K5: n[K5]}
                  for a, n in train_paths.items() if n[K5]})
    # the mesh paths: K3 and K4 once a shard, K5 replicated
    paths.update(mesh["launches"])
    # the training mesh and expert parallelism: K5 in every attention
    # layer's forward, twice a step under remat
    paths.update(train_mesh["launches"])
    paths.update(train_ep["launches"])
    # slice 7: the slot prefills on a mesh (replicated) and olmoe's 16
    # layers, twice a step
    paths.update(slots_mesh["launches"])
    paths.update(train_olmoe["launches"])
    k6_paths.update(slots_mesh["k6_launches"])
    k6_paths.update({a: n[K6] for a, n in train_paths.items() if n[K6]})
    on_paths = {k: sum(p[k] for p in paths.values()) for k in (K3, K4, K5)}
    by_path = {k: {a: p[k] for a, p in paths.items()} for k in (K3, K4, K5)}
    # the gather on the risk paths, each read just after its own run
    risk_paths = {"main": main_path["launches"],
                  **{p: loop[p]["launches"] for p in ("power", "fit", "pairs")},
                  f"mesh {MESH_RISK}": mesh_risk["launches"]}
    row_paths = {"main": main_path["row_launches"],
                 **{p: loop[p]["row_launches"]
                    for p in ("power", "fit", "pairs")},
                 f"mesh {MESH_RISK}": mesh_risk["row_launches"]}
    rows = []
    for name, src, replaces, numbers in (
            (G, agg_src, "src/repro/kernels/aggregate_loss.py:69",
             {"launches": sum(risk_paths.values()),
              "launches_by_path": risk_paths, **kern[G]}),
            (R, agg_src, "src/repro/kernels/aggregate_loss.py:69",
             {"launches": sum(row_paths.values()),
              "launches_by_path": row_paths, **kern[R]}),
            (O, agg_src, "src/repro/kernels/aggregate_loss.py:92",
             {**onehot["chunk"], **{k: v for k, v in onehot.items()
                                    if k != "chunk"},
              "library_call": "embedding_bag(ids, f[:, None], mode='sum') "
                              "on the row losses: the trial sums only",
              **kern[O]}),
            (K3, paged_src, "src/repro/kernels/paged_attention.py:60",
             {"launches": on_paths[K3], "launches_by_path": by_path[K3],
              **kern[K3]}),
            (K4, paged_src, "src/repro/kernels/paged_attention.py:158",
             {"launches": on_paths[K4], "launches_by_path": by_path[K4],
              **kern[K4]}),
            (K6, ssd_src, "src/repro/kernels/ssd_scan.py:29",
             {"launches": sum(k6_paths.values()),
              "launches_by_path": k6_paths, **kern[K6],
              "train": {**train["kernels"]["ssd"],
                        "grad_max_abs_err": errs.abs[K6B],
                        "grad_cases": errs.cases[K6B]}}),
            (K5, flash_src, "src/repro/kernels/flash_attention.py:32",
             {"launches": on_paths[K5], "launches_by_path": by_path[K5],
              # every other path's held to bf16_mma alone by its phase
              "variant_launches_by_path": {
                  "internlm2-1.8b": serving["variants"],
                  "olmoe-1b-7b": olmoe["variants"],
                  **{a: {"bf16_mma": n[K5], "f32_simt": 0}
                     for a, n in arch_paths.items() if n.get(K5)},
                  **{f"{a} train": r["variants"][K5]
                     for a, r in train["runs"].items()
                     if r["launches"][K5]}},
              **kern[K5], "train": {"shapes": train["kernels"]["flash"],
                                    "grad_max_abs_err": errs.abs[K5B],
                                    "grad_cases": errs.cases[K5B]}})):
        keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": numbers["launches"],
                     "max_abs_err": errs.abs[name], "ms": numbers["ms"],
                     "plain_ms": numbers["plain_ms"],
                     "bound_ms": numbers["bound_ms"],
                     "bound_by": numbers["bound_by"],
                     "library_ms": numbers["library_ms"],
                     "max_rel_err": errs.rel[name], "cases": errs.cases[name],
                     **{k: v for k, v in numbers.items() if k not in keys}})
    say("done", f"{time.perf_counter() - t_start:.1f} s in all; seconds by "
                f"phase {laps}")
    print(json.dumps({"main_path": main_path["runs"], "trials": trials}))
    print(json.dumps({"risk_loop": loop, "serve_obs": serve_obs}))
    print(json.dumps({"serving": {str(k): v for k, v in
                                  serving["runs"].items()},
                      "serving_mamba2": mamba["run"],
                      "serving_olmoe": olmoe["run"],
                      "serving_reduced": reduced,
                      "serving_rounds": serving["rounds"]}))
    print(json.dumps({"serve_slots": slots["runs"]}))
    print(json.dumps({"serve_archs": archs["runs"],
                      "serve_whisper": whisper["runs"],
                      "phase_seconds": laps}))
    print(json.dumps({"serve_overload": overload["runs"],
                      "serve_crash": crash}))
    print(json.dumps({"train": {k: v for k, v in train.items()
                                if k != "kernels"}}))
    print(json.dumps({"mesh": {"serve": mesh["runs"], "risk": mesh_risk}},
                     default=str))
    print(json.dumps({"train_mesh": {k: v for k, v in train_mesh.items()
                                     if k != "launches"},
                      "train_ep": {k: v for k, v in train_ep.items()
                                   if k != "launches"},
                      "compressed_psum": psum}, default=str))
    print(json.dumps({"serve_slots_mesh": {k: v for k, v in
                                           slots_mesh.items()
                                           if k != "launches"},
                      "train_olmoe": {k: v for k, v in train_olmoe.items()
                                      if k != "launches"},
                      "dryrun": dry}, default=str))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-crash-child"]:
        sys.exit(crash_child_main(*sys.argv[2:6]))
    sys.exit(main())
