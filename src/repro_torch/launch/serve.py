"""Multi-tenant serving driver.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --no-reduced --tenants 3 --requests 12 --prompt-len 128 \\
        --new-tokens 32 --max-batch 4 --stage-depth 1

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --no-reduced --mode continuous --tenants 3 --requests 12 \\
        --prompt-len 128 --new-tokens 32 --capacity 8 --shared-prefix-len 64

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --no-reduced --mode continuous --prompt-len 384 --new-tokens 32 \\
        --capacity 8

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --no-reduced --mode continuous --prompt-len 1024 --new-tokens 32 \\
        --capacity 8

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --no-reduced --num-layers 5 \\
        --mode continuous --prompt-len 1024 --new-tokens 32 --capacity 8

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --no-reduced --mode continuous --prompt-len 64 --new-tokens 32 \\
        --capacity 8

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --no-reduced --mode continuous --capacity 8 --priority 3 \\
        --max-backlog 8 --journal-dir /tmp/j --checkpoint-every 4

    PYTHONPATH=src python -m repro_torch.launch.serve --list-archs

Builds the model (weights drawn from ``--seed``, at full width with
``--no-reduced``), spins up the multi-tenant scheduler and drains a
synthetic request mix, printing per-tenant utilisation and the realised
overlap pairs.  ``--mode`` selects the schedule:

* ``overlapped`` (the default) -- tenant-slot batching (``--max-batch``
  requests of one tenant a slot) with up to ``--stage-depth`` batches
  dispatched under the running decode loop (on a CUDA device one captured
  graph per loop key);
* ``blocking`` (also ``--blocking``) -- ``generate`` per slot, the A/B
  baseline;
* ``continuous`` -- continuous batching over a paged KV cache (also prints
  slot occupancy and page-sharing stats).

On a CUDA device it also prints the prefill and decode times by CUDA
events.  Runs on the CUDA device unless ``--device cpu`` is given (and
fails without one).  ``--trace-out`` / ``--metrics-out`` / ``--stats-every
N`` light the telemetry plane before the stack is built and write a Chrome
trace, write Prometheus text, and print an ``obs:`` line every N scheduling
steps.  A pure-SSM arch (mamba2) pages nothing: its rows carry their SSM
state in the slot table, and ``--shared-prefix-len`` only lengthens the
prompts.  A MoE arch (olmoe, llama4, jamba) routes every token top-k over
its experts with capacity per routing group, so its rows are coupled (see
``serving/continuous.py``).  A hybrid arch (jamba) carries attention pages
and SSM rows at once.  A vision arch's requests (llava) carry synthetic
patch embeddings (``synth_extra_inputs``), merged into the leading
positions of the prompt.  An encoder-decoder arch's requests (whisper)
carry synthetic encoder frames, ``encoder_seq_len x d_model`` each (the
conv front end is a stub, as in the reference): every prefill encodes them
and writes the decoder's cross-attention K/V into the request's cross
pages.  ``--list-archs`` prints what each arch's serving
offers (``ContinuousBatchingEngine.supported_modes``) without building a
model, and exits.  ``--num-layers N`` serves a prefix of the published block
schedule, ``N`` layers at the published widths: the depth cut the
reference applies in its dry-run (``launch/dryrun.py``), so that a model
too large for one card still runs at full width.

Overload (``--mode continuous``): ``--priority K`` marks every K-th request
tier 0 -- held back until the tier-1 work has filled the slot table, then
landed at once -- ``--swap`` (the default) lets a blocked tier-0 arrival
preempt a tier-1 row through the host swap tier (restored token-exactly),
and ``--max-backlog N`` sheds the lowest-priority queued work past N with a
``rejected`` outcome.  Crash safety (``--mode continuous`` only):
``--journal-dir DIR`` writes the request journal to ``DIR/journal.jsonl``
(fsync'd ahead of every mutation) and engine checkpoints to
``DIR/checkpoints`` every ``--checkpoint-every K`` collected rounds;
``--crash-at-round N`` SIGKILLs the process at its N-th dispatched round;
``--recover`` rebuilds from the journal and the latest checkpoint instead
of submitting requests, replays the rounds past it and drains.

The flags are the JAX package's ``repro.launch.serve``.  Deliberate
differences: ``--reduced`` is a boolean pair (``--no-reduced`` runs the
published width; the reference's ``store_true`` with ``default=True`` never
can); there is no ``--kernel-backend`` -- the device decides (the
hand-written kernels for a CUDA device, their plain versions on the CPU);
``--num-layers`` is the port's (the reference's serve launcher has none).
Since ``main`` also runs inside other programs, the plane it lights starts
empty and is turned off again when it returns (the reference's process
simply exits).

``--mesh AxB`` splits the KV caches along KV heads over the "model" axis
of a mesh, in every mode.  Continuous: the paged KV pools -- self- and
cross-attention -- and the paged decode; page tables, the free list, the
trie and refcounts stay host-global, so admission, prefix sharing,
copy-on-write and preemption behave as without a mesh.  Overlapped and
blocking: each slot's prefill runs once, on the mesh's first device, and
its dense caches are laid out by the reference's cache axes
(``bundle.cache_axes()``: K/V and whisper's cross K/V on KV heads, the
positions and SSM states whole), and every decode step runs each shard's
query heads against its KV heads and joins them before ``wo``.  ``1x1`` is
bit-identical with no mesh; wider meshes are greedy token-exact.  The mesh's
positions go to the visible CUDA devices (``--device cpu``: the one CPU
device) in turn, a device taking several when there are fewer than ``A*B``
-- as the reference's forced host device count makes many devices of one
-- so one card serves ``1x8``: every shard a tensor of its own there and
every per-shard call a launch of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.pipeline import timeline_overlaps
from repro_torch.core.tenancy import TenancyConfig, resolve_devices
from repro_torch.distributed.fault import FaultPlane
from repro_torch.distributed.sharding import parse_mesh, serving_sharder
from repro_torch.models.model import build_model, param_count
from repro_torch.models.transformer import VIS_WIDTH, init_footprint
from repro_torch.obs import TELEMETRY
from repro_torch.obs.export import stats_line, write_chrome_trace, write_metrics
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import (MODES, MultiTenantScheduler,
                                             Request)

# flag -> the slice of the port that brings it
LATER: dict = {}


def list_archs() -> int:
    """Print the per-arch serving capability table (no model is built: the
    probe reads the arch config alone)."""
    hdr = (f"{'arch':<28} {'modes':<32} {'state kinds':<16} "
           f"{'preempt':<8} {'share':<14} {'exactness'}")
    print(hdr)
    print("-" * len(hdr))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        modes = ContinuousBatchingEngine.supported_modes(cfg)
        cont = modes["continuous"]
        share = ("window-phase" if cont["window_phase_keys"]
                 else ("yes" if cont["prefix_sharing"] else "no"))
        print(f"{arch:<28} "
              f"{'/'.join(m for m in MODES if modes[m]['supported']):<32} "
              f"{'+'.join(cont['state_kinds']):<16} "
              f"{'yes' if cont['preemptable'] else 'no':<8} "
              f"{share:<14} {cont['exactness']}")
    return 0


def synth_extra_inputs(cfg, rng: np.random.Generator) -> dict:
    """Deterministic synthetic non-token prefill inputs for one request:
    encoder frames for enc-dec archs, patch embeddings for vision archs
    (distinct per call -- distinct extras never share pages)."""
    extra = {}
    if cfg.enc_dec:
        extra["frames"] = rng.normal(
            size=(cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        extra["patch_embeds"] = rng.normal(
            size=(cfg.num_patches, VIS_WIDTH)).astype(np.float32)
    return extra


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="tiny same-family config (default); --no-reduced "
                         "serves the published width")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--num-layers", type=int, default=None, metavar="N",
                    help="serve the first N layers of the block schedule "
                         "at the published widths (the dry-run's depth "
                         "cut; default: every layer)")
    ap.add_argument("--list-archs", action="store_true",
                    help="print the per-arch serving capability table "
                         "(modes, state kinds, preemptable, prefix "
                         "sharing, exactness class) and exit")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="slot modes: requests of one tenant a batch")
    ap.add_argument("--mode", choices=MODES, default=None,
                    help="serving schedule (default: overlapped)")
    ap.add_argument("--blocking", action="store_true",
                    help="legacy alias for --mode blocking")
    ap.add_argument("--stage-depth", type=int, default=1,
                    help="overlapped mode: batches staged ahead of the "
                         "one being awaited")
    ap.add_argument("--capacity", type=int, default=4,
                    help="continuous mode: slot-table rows")
    ap.add_argument("--page-size", type=int, default=16,
                    help="continuous mode: KV-cache page size (tokens)")
    ap.add_argument("--inner-steps", type=int, default=4,
                    help="continuous mode: decode steps per micro-round")
    ap.add_argument("--prefix-sharing", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="refcounted prefix sharing + copy-on-write over "
                         "the paged pool")
    ap.add_argument("--batch-admission",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="batch same-bucket admissions into one prefill")
    ap.add_argument("--preserve-pristine", choices=("never", "reuse",
                                                    "always"),
                    default="reuse",
                    help="pristine-preserve policy for shared chains")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend a common system-prompt prefix of this "
                         "many tokens to every request")
    ap.add_argument("--priority", type=int, default=0, metavar="K",
                    help="continuous mode: mark every K-th request tier 0 "
                         "(admitted first, shed last, preempts tier-1 rows "
                         "with --swap).  0 = single tier")
    ap.add_argument("--swap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="continuous mode: preemption via KV tiering -- a "
                         "blocked higher-priority arrival swaps a lower-"
                         "priority row out to pinned host memory, restored "
                         "token-exactly when capacity frees (--no-swap: "
                         "admission waits).  Every state kind swaps")
    ap.add_argument("--max-backlog", type=int, default=None, metavar="N",
                    help="continuous mode: past N queued requests the "
                         "lowest-priority (then latest-deadline) queued "
                         "work is shed with a rejected outcome")
    ap.add_argument("--mesh", default=None, metavar="AxB",
                    help="device mesh spec, e.g. '1x8': split the KV "
                         "caches (continuous: the paged pools; slot modes: "
                         "each prefill's dense caches) and the decode along "
                         "KV heads over the 'model' axis; page tables, free "
                         "list, prefix trie and refcounts stay "
                         "host-global.  '1x1' is bit-identical with no "
                         "mesh, wider meshes greedy token-exact.  Positions "
                         "go to the visible devices in turn (several to a "
                         "device when there are fewer).  Default: no mesh")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="continuous mode: write the request journal to "
                         "DIR/journal.jsonl (fsync'd ahead of every "
                         "mutation) and engine checkpoints to "
                         "DIR/checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="continuous mode: checkpoint the serving state "
                         "every K collected rounds (needs --journal-dir; "
                         "0 = journal only)")
    ap.add_argument("--crash-at-round", type=int, default=0, metavar="N",
                    help="continuous mode: SIGKILL this process at its N-th "
                         "dispatched round (fault injection; 0 = never)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run's "
                         "telemetry spans to PATH (enables the telemetry "
                         "plane)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write Prometheus text-format metrics to PATH "
                         "(enables the telemetry plane)")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print a one-line telemetry summary every N "
                         "scheduling steps (enables the telemetry plane; "
                         "0 = never)")
    ap.add_argument("--recover", action="store_true",
                    help="recover from --journal-dir instead of submitting "
                         "requests: rebuild from the latest checkpoint, "
                         "re-queue unfinished work, replay the rounds past "
                         "it and drain")
    return ap


def mesh_devices(spec: str, dev: torch.device) -> list:
    """The devices of a ``spec`` mesh's positions, row-major: the visible
    CUDA devices (the one CPU device when ``dev`` is the CPU) in turn, a
    device taking several positions when there are fewer than the mesh
    needs."""
    n = math.prod(int(e) for e in str(spec).lower().split("x"))
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    return [visible[i % len(visible)] for i in range(n)]


def main(argv=None, observe: Optional[Callable[[Any], None]] = None) -> int:
    """Run the driver; ``observe(scheduler)`` (optional) is called once
    after the scheduler is built and then after every scheduling step."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_archs:
        return list_archs()
    mode = args.mode or ("blocking" if args.blocking else "overlapped")
    if args.journal_dir and mode != "continuous":
        # only the continuous collect loop journals round commits and
        # retirements
        ap.error("--journal-dir requires --mode continuous")
    if not args.journal_dir and (args.recover or args.checkpoint_every):
        ap.error("--recover/--checkpoint-every need --journal-dir")
    for name, slice_ in LATER.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} comes with {slice_} of the port "
                "(ROADMAP.md)")
    dev = resolve_devices(1, args.device)[0]           # raises: no card
    obs_on = bool(args.trace_out or args.metrics_out or args.stats_every)
    if not obs_on:
        return _serve(args, dev, observe)
    # light the global plane before the stack is built so every layer
    # (engine, scheduler, pool, staging) records
    TELEMETRY.reset().enable()
    try:
        return _serve(args, dev, observe)
    finally:
        TELEMETRY.disable()


def _serve(args, dev: torch.device,
           observe: Optional[Callable[[Any], None]]) -> int:
    sh = None
    if args.mesh:
        sh = serving_sharder(parse_mesh(args.mesh,
                                        mesh_devices(args.mesh, dev)))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    weight_bytes, init_peak = init_footprint(cfg)
    params = build_model(cfg).init(args.seed, dev)
    n_params = param_count(params)
    if dev.type == "cuda":
        print(f"init: weights {weight_bytes / 1e9:.2f} GB, peak reckoned "
              f"{init_peak / 1e9:.2f} GB, measured "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    engine = ServingEngine(cfg, params, device=dev, sh=sh)
    del params                       # the engine keeps its compute copy
    preserve = {"never": False, "reuse": True,
                "always": "always"}[args.preserve_pristine]
    mode = args.mode or ("blocking" if args.blocking else "overlapped")
    crash_kw = {}
    if args.journal_dir:
        crash_kw = dict(
            journal=os.path.join(args.journal_dir, "journal.jsonl"),
            checkpoint_dir=os.path.join(args.journal_dir, "checkpoints"),
            checkpoint_every=args.checkpoint_every)
    if args.crash_at_round:
        crash_kw["fault_plane"] = FaultPlane(
            crash_at_round=args.crash_at_round)
    sched = MultiTenantScheduler(
        engine, max_batch=args.max_batch,
        tenancy=TenancyConfig(1, args.tenants), mode=mode,
        stage_depth=args.stage_depth,
        preemption=args.swap, max_backlog=args.max_backlog,
        continuous=dict(capacity=args.capacity, page_size=args.page_size,
                        inner_steps=args.inner_steps,
                        prefix_sharing=args.prefix_sharing,
                        batch_admission=args.batch_admission,
                        preserve_pristine=preserve,
                        max_prompt_len=max(64, 2 * args.prompt_len
                                           + args.shared_prefix_len)),
        **crash_kw)
    if observe is not None:
        observe(sched)
    if args.recover:
        t0 = time.perf_counter()
        s = sched.recover()
        print(f"recovered in {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"from checkpoint step={s.checkpoint_step}: "
              f"live={s.restored_live} swapped={s.restored_swapped} "
              f"requeued={s.requeued} "
              f"already_complete={len(s.already_complete)} "
              f"rounds_replayed={s.rounds_replayed} "
              f"tokens preserved={s.tokens_preserved} "
              f"replayed={s.tokens_replayed}")

    rng = np.random.default_rng(0)
    shared_prefix = rng.integers(1, cfg.vocab_size,
                                 args.shared_prefix_len).astype(np.int32)
    late = []               # tier-0 arrivals held back to land mid-flight
    for i in range(0 if args.recover else args.requests):
        tenant = f"tenant-{i % args.tenants}"
        prompt = rng.integers(1, cfg.vocab_size,
                              args.prompt_len).astype(np.int32)
        if args.shared_prefix_len:
            prompt = np.concatenate([shared_prefix, prompt])
        tier0 = args.priority > 0 and i % args.priority == args.priority - 1
        if tier0:
            tenant += "-hi"          # its own lane: queues are FIFO
        req = Request(tenant, prompt,
                      max(4, args.new_tokens // 4) if tier0
                      else args.new_tokens,
                      priority=0 if tier0 else 1,
                      extra_inputs=synth_extra_inputs(cfg, rng) or None)
        # continuous: tier-0 requests arrive once the tier-1 work has
        # filled the slot table, so they meet it full
        if tier0 and mode == "continuous":
            late.append(req)
        else:
            sched.submit(req)
    if not sched.pending():          # all tier 0: nothing to hold them for
        for req in late:
            sched.submit(req)
        late = []

    responses = []
    steps = 0
    with torch.no_grad():
        while sched.pending() or late:
            r = sched.step()
            if r:
                responses.extend(r)
            steps += 1
            for req in late:         # the tier-0 burst meets full slots
                sched.submit(req)
            late = []
            if observe is not None:
                observe(sched)
            if args.stats_every and steps % args.stats_every == 0:
                print(stats_line(
                    TELEMETRY,
                    keys=("heartbeat.beats", "kv.pages_allocated",
                          "kv.free_pages", "swap.preemptions",
                          "swap.restores", "heartbeat.suspects"),
                    step=steps, pending=sched.pending()))
    sched.drain()                    # nothing left: audits the pool
    n_done = sum(r.outcome == "completed" for r in responses)
    print(f"arch={cfg.name} params={n_params / 1e9:.3f}B device={dev} "
          f"compute={cfg.compute_dtype}")
    print(f"served {len(responses)} requests (completed={n_done} "
          f"rejected={sum(r.outcome == 'rejected' for r in responses)})"
          f"{' failed=%d' % sum(r.outcome == 'failed' for r in responses)}")
    for t, rep in sorted(sched.utilization_report().items()):
        print(f"  {t}: requests={rep['requests']:.0f} "
              f"tokens={rep['tokens']:.0f} busy={rep['busy_s']*1e3:.1f}ms "
              f"share={rep['busy_share']*100:.1f}%")
    lat = [r.latency_s for r in responses if r.outcome == "completed"]
    if lat:
        print(f"latency p50={np.percentile(lat, 50)*1e3:.1f}ms "
              f"p99={np.percentile(lat, 99)*1e3:.1f}ms")
    ov = timeline_overlaps(sched.timeline)
    if mode != "continuous":
        print(f"schedule={mode} overlap_pairs={sum(ov)}/{len(ov)} "
              f"(staging of slot k+1 inside slot k's decode window)")
        prog = engine.decode_program
        if prog is not None:
            print(f"decode loops: {len(prog.loops)} keys captured as CUDA "
                  f"graphs (capture ms "
                  f"{[round(c.capture_ms, 1) for c in prog.loops.values()]}"
                  f"), {sum(c.replays for c in prog.loops.values())} "
                  f"replays; peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    else:
        _report_continuous(sched, dev, ov)
    if args.trace_out:
        write_chrome_trace(TELEMETRY, args.trace_out)
        print(f"trace: {len(TELEMETRY.spans())} spans "
              f"({TELEMETRY.spans_opened} opened, "
              f"{TELEMETRY.spans_dropped} dropped) -> {args.trace_out}")
    if args.metrics_out:
        write_metrics(TELEMETRY, args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    return 0


def _report_continuous(sched, dev: torch.device, ov) -> None:
    print(f"schedule=continuous overlap_pairs={sum(ov)}/{len(ov)} "
          f"(admission + dispatch of round k+1 inside round k's window)")
    eng = sched.continuous_engine
    print(f"micro-rounds={eng.rounds} x {eng.inner_steps} steps, "
          f"slot occupancy={eng.occupancy()*100:.1f}%, "
          f"pages reused={eng.kv.pages_reused}/{eng.kv.pages_allocated}, "
          f"nonfinite logit rows={eng.nonfinite_rows}")
    print(f"prefix sharing={'on' if eng.prefix_sharing else 'off'}: "
          f"pages allocated={eng.kv.pages_allocated} "
          f"shared={eng.kv.pages_shared} cow_forks={eng.kv.cow_forks} "
          f"pristine_forks={eng.kv.pristine_forks}; "
          f"prefill calls={eng.prefill_calls} skipped={eng.prefill_skips}")
    shed = sum(int(s["shed"]) for s in sched.stats.values())
    print(f"overload: preemption={'on' if sched.preemption else 'off'} "
          f"preemptions={eng.preemptions} restores={eng.restores} "
          f"shed={shed} faults_survived={sched.faults_survived} "
          f"heartbeat_suspects={sched.heartbeat_suspects}")
    if dev.type == "cuda":
        pre = eng.prefill_ms()
        rnd = eng.round_ms
        live = eng.row_steps
        print(f"device: prefill {len(pre)} calls, {sum(pre):.2f} ms "
              f"(mean {np.mean(pre) if pre else 0:.2f}); rounds "
              f"{len(rnd)}, {sum(rnd):.2f} ms (mean "
              f"{np.mean(rnd) if rnd else 0:.2f}); decode "
              f"{live / max(sum(rnd) * 1e-3, 1e-9):.1f} tokens/s over "
              f"round time; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


if __name__ == "__main__":
    sys.exit(main())
