#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — Aggregate Risk Analysis under a multi-tenancy
plan — at the published width (K = 1000 events per trial, M = 15 ELTs, a
2,000,000-event catalog, T = 1,000,000 trials unless host memory forces fewer)
through the entry points a user calls, builds every CUDA kernel from the
sources in this checkout, holds each against its plain PyTorch version on the
card, and shows by the launch counters that the main path went through the
kernels.  Any failed phase ends the run with a non-zero exit code; without a
CUDA device nothing runs.  The last line of a good run is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Phases: device, build, kernels (sweep), tables, kernels (full width), main
path (gather, full width), main path (onehot, catalog cut), cli.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.core.pipeline import timeline_overlaps
from repro_torch.core.tenancy import TenancyConfig
from repro_torch.kernels import aggregate_loss as agg
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.launch import risk as risk_cli
from repro_torch.risk import metrics
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import (GENERATE_PEAK_BYTES_PER_EVENT, RiskTables,
                                     generate)

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores (both kernels do their arithmetic in plain float32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version: the JAX package's own tolerance for kernel vs
# oracle; the two sum the same terms in different orders
RTOL, ATOL = 1e-5, 1e-3
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
ONEHOT_TIMED = [(256, 128, 15, 4096, 128, 512),      # largest of the sweep
                (1024, 128, 15, 65536, 128, 512)]    # a larger catalog
ONEHOT_MAIN_CATALOG = 4096   # catalog of the main-path run of the onehot variant
ONEHOT_MAIN_TRIALS = 4096


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


def phase_build() -> None:
    t0 = time.perf_counter()
    lines = build.compile_library("aggregate_loss").splitlines()
    dt = time.perf_counter() - t0
    # ptxas names an entry, then reports what it uses
    used, spills, entry = [], [], "?"
    for l in lines:
        if "Compiling entry function" in l:
            m = re.search(r"gather_kernelILi\d|onehot_kernel", l)
            entry = m.group(0).replace("ILi", "<NV=") + ">" * ("ILi" in m.group(0)) \
                if m else l.split("'")[1]
        elif "Used" in l:
            used.append(f"{entry} {l.split('Used', 1)[1].split(',')[0].strip()}")
        elif "spill" in l and "0 bytes spill stores, 0 bytes spill loads" not in l:
            spills.append(f"{entry}: {l.strip()}")
    check(len(used) >= 2, "ptxas reported fewer than two kernels")
    say("build", f"aggregate_loss.cu -> "
                 f"{build.library_path('aggregate_loss').name} ({len(used)} "
                 f"kernel instances: {'; '.join(used)}; spills: "
                 f"{'; '.join(spills) or 'none'})")
    build.load_library("aggregate_loss")
    say("build", f"nvcc sm_90a: {dt:.1f} s")


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


class Errors:
    """Largest disagreement seen per kernel, over every comparison."""

    def __init__(self):
        self.abs = {"aggregate_loss_gather": 0.0, "aggregate_loss_onehot": 0.0}
        self.rel = dict(self.abs)
        self.cases = dict.fromkeys(self.abs, 0)

    def hold(self, name: str, got: torch.Tensor, want: torch.Tensor,
             what: str) -> None:
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == torch.float32,
              f"{name} {what}: shape/dtype {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        diff = (got - want).abs()
        a = float(diff.max()) if diff.numel() else 0.0
        r = float((diff / want.abs().clamp_min(1e-30))[want != 0].max()) \
            if bool((want != 0).any()) else 0.0
        self.abs[name] = max(self.abs[name], a)
        self.rel[name] = max(self.rel[name], r)
        self.cases[name] += 1
        check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)),
              f"{name} {what}: max abs err {a:.3g}, max rel err {r:.3g} "
              f"outside rtol={RTOL} atol={ATOL}")


def cuda_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median time of ``fn`` by CUDA events, the L2 cache flushed before each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def gather_traffic_ms(T, K):
    """Not the bound: what the gather algorithm pulls if no row is reused,
    an id and one 64 B row per event, at the memory rate."""
    return (T * K * (4 + 64) + T * 4) / PEAK_BYTES_PER_S * 1e3


def onehot_fma_ms(T, K, M, rows):
    """Not the bound: the one-hot product's own multiply-adds at the float32
    rate, the cost of that algorithm."""
    return 2 * T * K * rows * M / PEAK_F32_FLOPS * 1e3


G, O = "aggregate_loss_gather", "aggregate_loss_onehot"


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
        errs.hold(O, agg.aggregate_loss_onehot(*args, chunk=chunk,
                                               rows_tile=rt),
                  agg.aggregate_loss_onehot_plain(*args, chunk=chunk,
                                                  rows_tile=rt), what)
        errs.hold(O, agg.aggregate_loss_onehot(*padded, chunk=chunk,
                                               rows_tile=rt), want,
                  what + " vs gather plain")

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

    say("kernels", f"sweep and edge cases hold: gather {errs.cases[G]}, "
                   f"onehot {errs.cases[O]} comparisons")


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
    say("kernels", f"gather {g_shape}: {g_ms:.3f} ms, plain "
                   f"{g_plain:.1f} ms (first call {plain_wall * 1e3:.0f} ms), "
                   f"bound {g_bound:.3f} ms by {g_by}; id + 64 B row per event "
                   f"would take {gather_traffic_ms(T, K):.3f} ms at the "
                   f"memory rate")
    del ids, got, want

    # onehot at the sweep's largest shape and at a larger catalog
    o_rows = []
    for T, K, M, cat, chunk, rt in ONEHOT_TIMED:
        args = make_case(rng, T, K, M, cat, dev)
        errs.hold(O, agg.aggregate_loss_onehot(*args, chunk=chunk, rows_tile=rt),
                  agg.aggregate_loss_onehot_plain(*args, chunk=chunk,
                                                  rows_tile=rt),
                  f"T{T} K{K} M{M} cat{cat}")
        ms = cuda_ms(lambda: agg.aggregate_loss_onehot(
            *args, chunk=chunk, rows_tile=rt), 5, flush)
        plain = cuda_ms(lambda: agg.aggregate_loss_onehot_plain(
            *args, chunk=chunk, rows_tile=rt), 2, flush)
        bound, by = bound_ms(T, K, M, cat + 1)
        padded = (args[0], agg.pad_elt_columns(args[1]), *args[2:])
        gather_ms = cuda_ms(lambda: agg.aggregate_loss_gather(
            *padded, chunk=chunk), 5, flush)
        o_rows.append({"shape": f"T{T} K{K} M{M} cat{cat} rows_tile{rt}",
                       "ms": ms, "plain_ms": plain, "bound_ms": bound,
                       "bound_by": by, "gather_ms_same_shape": gather_ms})
        say("kernels", f"onehot {o_rows[-1]['shape']}: {ms:.3f} ms, plain "
                       f"{plain:.2f} ms, bound {bound:.4f} ms by {by}; the "
                       f"one-hot product alone is "
                       f"{onehot_fma_ms(T, K, M, cat + 1):.4f} ms of FMAs; "
                       f"gather kernel on the same inputs {gather_ms:.3f} ms")

    return {G: {"shape": g_shape, "ms": g_ms, "plain_ms": g_plain,
                "bound_ms": g_bound, "bound_by": g_by},
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
    check(launches == expected and launches > 0,
          f"gather launches {launches}, expected {expected}")
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
    return {"launches": launches, "runs": runs}


def phase_main_onehot(errs: Errors, cfg: RiskAppConfig, dev) -> dict:
    """The same entry points with the onehot variant.  Its work grows with
    T*K*rows*M, so the catalog (and T) are cut here; K and M stay.  Then the
    kernel at the shape this run gave it, against its plain version."""
    small = dataclasses.replace(cfg, num_trials=ONEHOT_MAIN_TRIALS,
                                event_catalog=ONEHOT_MAIN_CATALOG)
    tables = generate(small, seed=1)
    ara = AggregateRiskAnalysis(small, TenancyConfig(1, 2, "sequential"))
    want = ara.run_tenant_chunked(tables).ylt          # gather variant
    prev = kops.aggregate_variant()
    kops.use_aggregate_variant("onehot")
    try:
        agg.reset_counts()                 # just before the main path
        rep = ara.run_tenant_chunked(tables)
        launches = agg.launch_counts[O]    # just after
    finally:
        kops.use_aggregate_variant(prev)
    check(launches == 2, f"onehot launches {launches} for 2 tenants")
    check(agg.launch_counts["aggregate_loss_gather"] == 0
          and not any(agg.plain_counts.values()),
          "the onehot main path took another route")
    check(bool(np.isfinite(rep.ylt).all())
          and np.allclose(rep.ylt, want, rtol=RTOL, atol=ATOL),
          "onehot YLT disagrees with the gather YLT")
    k = sum(tl.device_ms["compute_end"] - tl.device_ms["compute_start"]
            for tl in rep.timeline)
    say("main", f"onehot variant, T={small.num_trials} K={small.events_per_trial}"
                f" M={small.num_elts} catalog={small.event_catalog} (cut), 1x2 "
                f"sequential: {launches} launches, kernels {k:.2f} ms, wall "
                f"{rep.wall_s * 1e3:.1f} ms, YLT agrees with the gather variant")
    T, K = small.num_trials // 2, small.events_per_trial
    rows, M = tables.elt_losses.shape
    args = (torch.from_numpy(tables.yet[:T]).to(dev),
            agg.pad_elt_columns(torch.from_numpy(tables.elt_losses).to(dev)),
            torch.from_numpy(tables.occ_ret).to(dev),
            torch.from_numpy(tables.occ_lim).to(dev),
            tables.agg_ret, tables.agg_lim)
    rt = agg.ONEHOT_DEFAULT_ROWS_TILE
    shape = f"T{T} K{K} M{M} rows{rows} rows_tile{rt}"
    errs.hold(O, agg.aggregate_loss_onehot(*args, chunk=small.chunk_events),
              agg.aggregate_loss_onehot_plain(*args, chunk=small.chunk_events),
              "main-path shape " + shape)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    ms = cuda_ms(lambda: agg.aggregate_loss_onehot(
        *args, chunk=small.chunk_events), 5, flush)
    plain = cuda_ms(lambda: agg.aggregate_loss_onehot_plain(
        *args, chunk=small.chunk_events), 1, flush)
    bound, by = bound_ms(T, K, M, rows)
    say("kernels", f"onehot {shape}: {ms:.3f} ms, plain {plain:.1f} ms, bound "
                   f"{bound:.4f} ms by {by}; the one-hot product alone is "
                   f"{onehot_fma_ms(T, K, M, rows):.3f} ms of FMAs")
    agg.reset_counts()
    return {"launches": launches, "shape": shape, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by}


def phase_cli() -> None:
    rc = risk_cli.main(["--reduced", "--tenants", "2", "--mode", "sequential"])
    check(rc == 0, f"cli returned {rc}")
    check(agg.launch_counts["aggregate_loss_gather"] == 2
          and not any(agg.plain_counts.values()),
          "the cli did not go through the gather kernel")


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    try:
        card = phase_device()
        phase_build()
        errs = Errors()
        phase_kernels_small(errs, dev)
        cfg = RiskAppConfig()
        tables = phase_tables(cfg)
        cfg = dataclasses.replace(cfg, num_trials=tables.num_trials)
        kern = phase_kernels_full(errs, tables, dev)
        main_path = phase_main_gather(cfg, tables, dev)
        onehot = phase_main_onehot(errs, cfg, dev)
        phase_cli()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    say("kernels", f"held against plain versions: gather {errs.cases[G]} cases "
                   f"(max abs err {errs.abs[G]:.3g}, max rel err "
                   f"{errs.rel[G]:.3g}), onehot {errs.cases[O]} cases (max abs "
                   f"err {errs.abs[O]:.3g}, max rel err {errs.rel[O]:.3g}); "
                   f"tolerance rtol={RTOL} atol={ATOL} (summation order)")
    src = "src/repro_torch/kernels/csrc/aggregate_loss.cu"
    rows = []
    for name, replaces, numbers in (
            (G, "src/repro/kernels/aggregate_loss.py:69",
             {"launches": main_path["launches"], **kern[G]}),
            (O, "src/repro/kernels/aggregate_loss.py:92",
             {**onehot, **kern[O]})):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": numbers["launches"],
                     "max_abs_err": errs.abs[name], "ms": numbers["ms"],
                     "plain_ms": numbers["plain_ms"],
                     "bound_ms": numbers["bound_ms"],
                     "bound_by": numbers["bound_by"], "library_ms": None,
                     "max_rel_err": errs.rel[name], "cases": errs.cases[name],
                     **{k: v for k, v in numbers.items() if k not in (
                         "launches", "ms", "plain_ms", "bound_ms",
                         "bound_by")}})
    say("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"main_path": main_path["runs"],
                      "trials": tables.num_trials}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
