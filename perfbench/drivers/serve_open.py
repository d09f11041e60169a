"""``serve_open``: multi-tenant LLM serving under open-loop Poisson arrivals.

The program under test is the port's ``MultiTenantScheduler`` in
``mode="continuous"`` over a ``ContinuousBatchingEngine`` (paged KV,
prefix sharing, decode rounds as CUDA graphs) on one ``ServingEngine``.
Requests arrive on the schedule of :mod:`arrivals`, whether or not the
server keeps up; each is timed from when it was due.  After the window no
request is sent, and the scheduler runs until every request due in the
window has its answer (at most ``DRAIN_S`` more), so a late answer counts
its whole wait.  A request's first and last tokens are stamped here, on
the benchmark's clock, as the engine's ``collect`` hands a round's tokens
to the host: the first round in which its row emitted, and the round that
finished it.  No time the program stamps enters a metric.

Weights are drawn on the card from the seed in a few large calls, in
bfloat16 (the type they are served in), at the configuration's widths:
embedding N(0, 1); the q, k, v, gate and up matrices N(0, 1/d); the
output and down matrices N(0, 1/fan-in); norm scales 1 + N(0, 0.01); the
unembedding N(0, 4/d) (logits of about unit scale times two).  The
reference gets the same tensors in float32.

Correctness: a sample of the requests completed from the window, drawn
from the seed: greedy ones with the one that served the most tokens in it,
and top-k sampled ones with the longest of those.  The plain reference
(``reference/lm.py``) runs once over each prompt, as the program padded it,
and its served tokens.  The numbers compared: ``logit_gap``, the widest gap
by which a greedy token's logit lies below the reference's best, and
``topk_gap``, the widest by which a sampled token's lies below the
reference's k-th best (nought inside the reference's top k).
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import arrivals
import devtrace
from reference import lm as ref

DRAIN_S = 60.0
MAX_SPANS = 1 << 21
# the port's stacked leaves by the reference's names
ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")


def draw_weights(cfg: Dict[str, Any], gen: torch.Generator, dev
                 ) -> Dict[str, torch.Tensor]:
    L, d, V = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    H, Hkv, D, F = (cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"],
                    cfg["d_ff"])
    Vp = -(-V // 256) * 256
    bf = torch.bfloat16

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, device=dev, dtype=bf)
        return t.mul_(std)

    return {
        "embedding": normal((Vp, d), 1.0),
        "unembed": normal((d, Vp), 2.0 / d ** 0.5),
        "final_norm": normal((d,), 0.1).add_(1.0),
        "norm1": normal((L, d), 0.1).add_(1.0),
        "norm2": normal((L, d), 0.1).add_(1.0),
        "wq": normal((L, d, H * D), d ** -0.5),
        "wk": normal((L, d, Hkv * D), d ** -0.5),
        "wv": normal((L, d, Hkv * D), d ** -0.5),
        "wo": normal((L, H * D, d), (H * D) ** -0.5),
        "w_gate": normal((L, d, F), d ** -0.5),
        "w_up": normal((L, d, F), d ** -0.5),
        "w_down": normal((L, F, d), F ** -0.5),
    }


def port_config(cfg: Dict[str, Any]):
    from repro_torch.configs import ArchConfig
    return ArchConfig(
        name=cfg["name"], family="dense", num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], num_heads=cfg["num_heads"],
        num_kv_heads=cfg["num_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], param_dtype=cfg["dtype"],
        compute_dtype=cfg["dtype"])


def port_tree(W: Dict[str, torch.Tensor], pcfg) -> Dict[str, Any]:
    """The weights laid out as the port's parameter tree (checked against
    the tree the port's initialiser builds on the meta device)."""
    from repro_torch.models.transformer import init_lm, tree_map
    tree = {"embed": {"embedding": W["embedding"], "unembed": W["unembed"]},
            "stages": {"sub0": {
                "norm1": {"scale": W["norm1"]},
                "attn": {k: W[k] for k in ATTN},
                "norm2": {"scale": W["norm2"]},
                "mlp": {k: W[k] for k in MLP}}},
            "final_norm": {"scale": W["final_norm"]}}
    want = init_lm(pcfg, 0, "meta")
    shapes = []
    tree_map(lambda t: shapes.append(tuple(t.shape)), tree)
    wanted = []
    tree_map(lambda t: wanted.append(tuple(t.shape)), want)
    if shapes != wanted:
        raise RuntimeError(f"parameter tree: {shapes} != the port's {wanted}")
    return tree


class Cell:
    """The program set up for one cell: weights, engines, warm shapes."""

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 seconds: float, dev, trace: bool):
        from repro_torch.obs.telemetry import Telemetry
        from repro_torch.serving.continuous import ContinuousBatchingEngine
        from repro_torch.serving.engine import ServingEngine

        self.cfg, self.mix, self.dev = cfg, mix, dev
        self.cuda = dev.type == "cuda"
        t = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.W = draw_weights(cfg, gen, dev)
        if self.cuda:
            torch.cuda.synchronize()
        self.phases = {"inputs_s": time.perf_counter() - t}
        t = time.perf_counter()
        pcfg = port_config(cfg)
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.tel = Telemetry(enabled=trace, max_spans=MAX_SPANS)
        self.engine = ServingEngine(pcfg, port_tree(self.W, pcfg),
                                    temperature=0.0, device=dev,
                                    telemetry=self.tel)
        eng = mix["engine"]
        self.ceng = ContinuousBatchingEngine(
            self.engine, capacity=eng["capacity"],
            page_size=eng["page_size"], inner_steps=eng["inner_steps"],
            max_prompt_len=eng["max_prompt_len"], telemetry=self.tel)
        self.phases["program_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.warm(seed, seconds)
        self.phases["warm_s"] = time.perf_counter() - t

    def scheduler(self):
        from repro_torch.serving.multitenant import MultiTenantScheduler
        return MultiTenantScheduler(self.engine, mode="continuous",
                                    continuous_engine=self.ceng,
                                    telemetry=self.tel)

    def warm(self, seed: int, seconds: float) -> None:
        """Every prompt bucket of the mix prefilled once at width 1 (a
        bucket's first prefill costs up to 20 ms more than its second on
        the card: cuBLAS's first call at a shape), then both round keys,
        each captured as a CUDA graph at its first dispatch: all rows
        greedy, and greedy rows beside top-k sampled ones.  Then
        ``warm_seconds`` of the mix itself at its rate, on another seed and
        with answers of at most 8 tokens so that it drains at once: the
        admission path, batched prefill widths and the page pool as the
        window meets them.  Last, the set-up's objects are collected and
        frozen, so that no collection in the window walks them."""
        from repro_torch.serving.engine import to_device
        from repro_torch.serving.multitenant import Request
        rng = np.random.default_rng(seed + 1)
        V = self.cfg["vocab_size"]
        lens = arrivals.shape_set(self.mix, seconds)["prompt"]
        buckets = sorted({self.ceng.bucket_len(int(n)) for n in lens})
        eng = self.engine
        with torch.no_grad():
            for b in buckets:
                toks = rng.integers(1, V, size=(1, b), dtype=np.int32)
                eng.bundle.prefill_fn(eng.params,
                                      {"tokens": to_device(toks, self.dev)})
        samp = self.mix["sampling"]
        short = buckets[0]
        greedy = [Request("warm", rng.integers(1, V, size=short,
                                               dtype=np.int32),
                          max_new_tokens=8, temperature=0.0)
                  for _ in range(2)]
        mixed = [Request("warm", rng.integers(1, V, size=short,
                                              dtype=np.int32),
                         max_new_tokens=8,
                         temperature=samp["temperature"] if i % 2 else 0.0,
                         top_k=samp["top_k"] if i % 2 else 0, seed=i)
                 for i in range(2)]
        for batch in (greedy, mixed):
            sched = self.scheduler()
            for r in batch:
                sched.submit(r)
            sched.drain()
        if self.mix.get("warm_seconds"):
            short_answers = dict(self.mix["output"], median=8, min=4, max=8)
            self.window(self.mix["warm_seconds"], seed + 3,
                        devtrace.Tracer(False), 0.0, 0.0,
                        mix=dict(self.mix, output=short_answers))
        if self.cuda:
            torch.cuda.synchronize()
        gc.collect()
        gc.freeze()

    def window(self, seconds: float, seed: int, tracer: devtrace.Tracer,
               trace_at: float, trace_len: float, drain_s: float = DRAIN_S,
               mix: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        from repro_torch.serving.multitenant import Request
        ceng = self.ceng
        V = self.cfg["vocab_size"]
        arr = arrivals.schedule(mix or self.mix, seconds, seed, V)
        sched = self.scheduler()
        owner: Dict[int, int] = {}
        collect = ceng.collect

        def collect_and_note(handle):
            res = collect(handle)
            stamp = time.perf_counter() - t0
            for c, req in enumerate(res.slot_reqs):
                i = index.get(id(req), -1)
                if i >= 0 and res.active_steps[c] > 0:
                    rows[i].setdefault("first", stamp)
            for req, toks, _ in res.finished:
                i = index.get(id(req), -1)
                owner[id(toks)] = i
                if i >= 0:
                    rows[i]["last"] = stamp
            kv = ceng.kv
            held = kv.num_pages - kv.RESERVED - kv.free_pages()
            live = held - kv.cached_pages()
            pages[0], pages[1] = max(pages[0], live), max(pages[1], held)
            return res

        ceng.collect = collect_and_note
        index: Dict[int, int] = {}
        rows: List[Dict[str, Any]] = [
            {"due": a.due_s, "n": 0, "outcome": "missing",
             "prompt": int(a.prompt.size),
             "bucket": ceng.bucket_len(int(a.prompt.size)),
             "greedy": a.temperature <= 0, "top_k": a.top_k} for a in arr]
        # peak pages that live rows hold, and with the prefix cache's idle ones
        pages = [0, 0]
        c0 = self.counters()
        n_pf0 = len(ceng.prefill_ms()) if self.cuda else 0
        n_rd0 = len(ceng.round_ms)
        t0 = time.perf_counter()
        served: Dict[int, np.ndarray] = {}
        slice_c: Dict[str, Any] = {}

        def take(out):
            for r in out or ():
                i = owner.pop(id(r.tokens), -1)
                if i < 0:
                    continue
                row = rows[i]
                row["outcome"] = r.outcome
                if r.outcome == "completed":
                    if "first" not in row or "last" not in row:
                        # answered without its rounds passing collect: no
                        # token time on the benchmark's clock, so it counts
                        # as missing
                        row["outcome"] = "unstamped"
                        continue
                    row["n"] = int(r.tokens.size)
                    served[i] = r.tokens

        def submit_due(now):
            nonlocal i_next
            while i_next < len(arr) and arr[i_next].due_s <= now:
                a = arr[i_next]
                req = Request(a.tenant, a.prompt,
                              max_new_tokens=a.max_new_tokens,
                              temperature=a.temperature, top_k=a.top_k,
                              seed=a.seed, arrival_s=t0 + a.due_s)
                index[id(req)] = i_next
                with tracer.span("bench.submit"):
                    sched.submit(req)
                i_next += 1

        i_next = 0
        traced = None
        queue: List[List[float]] = []
        pool: List[List[float]] = []
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            submit_due(now)
            if not queue or now - queue[-1][0] >= 0.25:
                queue.append([now, sum(len(q) for q in sched.queues.values())])
            if tracer.enabled and traced is None and now >= trace_at:
                tracer.start()
                traced = time.perf_counter()
                slice_c["start"] = (traced - t0, self.counters())
            elif traced is not None and "stop" not in slice_c and \
                    time.perf_counter() - traced >= trace_len:
                tracer.stop(self.program_spans())
                slice_c["stop"] = (time.perf_counter() - t0, self.counters())
            if sched.pending():
                with tracer.span("bench.step"):
                    out = sched.step()
                take(out)
                if tracer.enabled:
                    pool.append(self.pool_sample(time.perf_counter() - t0))
            else:
                nxt = arr[i_next].due_s if i_next < len(arr) else seconds
                time.sleep(max(0.0, min(nxt, seconds) - now))
        submit_due(seconds)       # every request due in the window
        window_s = time.perf_counter() - t0
        c_end = self.counters()
        if traced is not None and "stop" not in slice_c:
            tracer.stop(self.program_spans())
            slice_c["stop"] = (time.perf_counter() - t0, self.counters())
        while sched.pending() and time.perf_counter() - t0 < seconds + drain_s:
            out = sched.step()
            take(out)
        # past the drain's limit, what is still queued or live stays
        # unanswered (counted as missing) and the engine is dropped
        drain_s = time.perf_counter() - t0 - window_s
        sched.close()
        if self.cuda:
            torch.cuda.synchronize()
        ceng.collect = collect
        pf_ms = ceng.prefill_ms()[n_pf0:] if self.cuda else []
        pf_spans = [s for s in self.tel.spans("admit.prefill")
                    if s.t_start + self.tel.t0 >= t0]
        prefills = [{"t": s.t_start + self.tel.t0 - t0,
                     "bucket": s.attrs["bucket"], "width": s.attrs["width"],
                     "ms": pf_ms[j] if j < len(pf_ms) else None}
                    for j, s in enumerate(pf_spans)]
        return {"requests": rows, "served": served, "window_s": window_s,
                "counters": {"start": c0, "end": c_end},
                "slice": slice_c, "prefills": prefills,
                "round_ms": list(ceng.round_ms[n_rd0:]),
                "inner_steps": ceng.inner_steps, "queue": queue,
                "pool": pool, "kv_pages": {"pool": ceng.kv.num_pages,
                                           "live_peak": pages[0],
                                           "held_peak": pages[1]},
                "phases": dict(self.phases, window_s=window_s,
                               drain_s=drain_s),
                "attempted": len(arr),
                "failed": sum(r["outcome"] != "completed" for r in rows)}

    def counters(self) -> Dict[str, int]:
        kv, ceng = self.ceng.kv, self.ceng
        return {"pages_shared": kv.pages_shared,
                "pages_allocated": kv.pages_allocated,
                "row_steps": ceng.row_steps}

    def pool_sample(self, t: float) -> List[float]:
        """``[t, row_steps, live rows, pages their page rows name]``: what
        the next decode steps read, from the page pool's own rows."""
        kv, ceng = self.ceng.kv, self.ceng
        pages = [len(kv.owned_pages(c)) for c in range(ceng.capacity)]
        return [t, ceng.row_steps, sum(p > 0 for p in pages), sum(pages)]

    def program_spans(self):
        t0 = self.tel.t0
        return [(s.name, s.t_start + t0, s.t_end + t0)
                for s in self.tel.spans() if s.name != "round.device"]

    def free(self) -> None:
        del self.ceng, self.engine
        gc.unfreeze()
        gc.collect()
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def check(W, cfg, rows, served, arr_prompts, sample, control=False):
    """``{"logit_gap", "topk_gap"}`` over the sampled requests: the widest
    gap of a greedy request's served token below the reference's best
    logit, and of a top-k request's below the reference's k-th best.  With
    ``control``, the same two of the tokens the control's float8 weights put
    first (greedy) or in their top k (sampled), read in their place."""
    gap = {"logit_gap": 0.0, "topk_gap": 0.0}
    ctl = dict(gap)
    for i in sample:
        b, k = rows[i]["bucket"], rows[i]["top_k"]
        name = "topk_gap" if k > 0 else "logit_gap"
        toks = served[i]
        padded = np.zeros(b, np.int64)
        padded[b - arr_prompts[i].size:] = arr_prompts[i]
        seq = torch.from_numpy(np.concatenate([padded, toks[:-1]]))
        want = ref.logits(W, cfg, seq, b - 1, b)
        g = float(ref.token_gaps(want, torch.from_numpy(toks)[:, None],
                                 max(k, 1)).max())
        gap[name] = g if not np.isfinite(g) else max(gap[name], g)
        if control:
            low = ref.logits(W, cfg, seq, b - 1, b, weight=ref.fp8_weight)
            pick = low.topk(max(k, 1), dim=-1).indices
            ctl[name] = max(ctl[name], float(
                ref.token_gaps(want, pick, max(k, 1)).max()))
        if not np.isfinite(g):
            break
    return gap, ctl


def draw_sample(rows, mix, seed: int) -> List[int]:
    """The requests checked: ``check_requests`` greedy and
    ``check_sampled`` top-k ones completed, drawn from the seed, each group
    with its longest (most tokens served) in it."""
    rng = np.random.default_rng(seed + 2)
    sample: List[int] = []
    for greedy, count in ((True, mix["check_requests"]),
                          (False, mix.get("check_sampled", 0))):
        done = [i for i, r in enumerate(rows)
                if r["outcome"] == "completed" and r["greedy"] == greedy]
        if not done or count <= 0:
            continue
        longest = max(done, key=lambda i: (rows[i]["n"], rows[i]["prompt"]))
        rest = [i for i in done if i != longest]
        k = min(len(rest), count - 1)
        sample += [longest] + [int(i) for i in rng.choice(rest, size=k,
                                                          replace=False)]
    return sample


def memory(cfg, mix, kv_pages, W) -> Dict[str, int]:
    """What the card holds for the cell: the weights, the KV page pool the
    engine reserves, and the peak bytes of the pages live rows held (and
    with the prefix cache's idle pages) in the window."""
    page = (cfg["num_layers"] * 2 * mix["engine"]["page_size"]
            * cfg["num_kv_heads"] * cfg["head_dim"] * 2)
    return {"weights_bytes": sum(t.numel() * t.element_size()
                                 for t in W.values()),
            "kv_pool_bytes": kv_pages["pool"] * page,
            "kv_live_peak_bytes": kv_pages["live_peak"] * page,
            "kv_held_peak_bytes": kv_pages["held_peak"] * page}


def run(ctx) -> Dict[str, Any]:
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    cell = Cell(cfg, mix, ctx.seed, ctx.seconds, dev, ctx.trace)
    ctx.setup_done()
    tracer = devtrace.Tracer(ctx.trace)
    rec = cell.window(ctx.seconds, ctx.seed, tracer,
                      mix["trace_at"] * ctx.seconds, mix["trace_seconds"])
    peak = torch.cuda.max_memory_allocated(dev) if cell.cuda else 0
    cell.free()
    arr = arrivals.schedule(mix, ctx.seconds, ctx.seed, cfg["vocab_size"])
    rows, served = rec["requests"], rec.pop("served")
    fault = ctx.faults.get("tokens")
    if fault is not None:
        served = {i: fault(i, t.copy()) for i, t in served.items()}
    sample = draw_sample(rows, mix, ctx.seed)
    t_check = time.perf_counter()
    gap, ctl = check(cell.W, cfg, rows, served, [a.prompt for a in arr],
                     sample, control=mix.get("control", False))
    rec["phases"]["check_s"] = time.perf_counter() - t_check
    # a kind of request with none in the sample is no proof: it fails
    held = {"logit_gap": any(rows[i]["greedy"] for i in sample),
            "topk_gap": any(not rows[i]["greedy"] for i in sample)}
    checks = {name: {"value": gap[name] if held[name] else float("inf"),
                     "limit": limit}
              for name, limit in mix["limits"].items()}
    rec.update({
        "platform": "gpu" if cell.cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cell.cuda else "cpu",
        "memory_peak_bytes": peak, "checks": checks,
        "checked_requests": len(sample),
        "checked_tokens": int(sum(rows[i]["n"] for i in sample)),
        "model": {k: cfg[k] for k in ("num_layers", "d_model", "num_heads",
                                      "num_kv_heads", "head_dim", "d_ff",
                                      "vocab_size")},
        "page_size": mix["engine"]["page_size"],
        "memory": memory(cfg, mix, rec.pop("kv_pages"), cell.W)})
    if mix.get("control"):
        rec["control"] = {name: ctl[name] for name in checks}
    summary = tracer.summary()
    if summary is not None:
        rec["trace"] = summary
    return rec
