"""Where internlm2-1.8b's continuous serving path and ``generate`` part, at
full width on one CUDA device (open item F1 in ROADMAP.md).

    python3 diagnostics/f1_internlm2.py [--dtypes bfloat16 float32]
                                        [--replay 1 10] [--out f1.json]

(``--reduced --device cpu`` runs the reduced config on the host, as a
rehearsal.)

The 12 prompts of ``launch.serve``'s prefix-0 run (``default_rng(0)``, 128
tokens each) are served by a continuous engine (capacity 8, page 16, 4
steps a round) and by ``ServingEngine.generate`` (one batch of 12), 32 new
greedy tokens each, with each step's logits kept.  For every request, at
every step where the two token histories are still equal, the script takes
the largest logit difference between the two paths and both top-2 margins.

What rounding alone predicts, and what a fault would show: if the paths
part because their GEMMs round differently, the difference at a request's
first divergent token is of the size seen at the steps where they agree,
and there both margins are below it.  A fault that shifts the logits at
the step where they part shows a difference there above every agreeing
step's.

Then, layer by layer: both paths run again (the same engines, the same
tokens) with the port's ``apply_rmsnorm`` patched where the decode loops
call it (``mock.patch``), which records its input -- the residual stream
before each layer's attention and MLP and before the final norm -- for
every request that parts at a decode step, at that step and at each
agreeing decode step before it; after each of those steps the K and V the
paths hold for the request are read: the engine's pages through its page
table and position pool, ``generate``'s dense ring cache by its
positions.  For every layer the script reports the largest absolute
difference of the residual after attention and after the layer, and of
the held K and V, at the parting step and the largest over the agreeing
steps, and names the first layer whose parting difference exceeds twice
its agreeing largest (``PERF.md`` states the rule that reads it).

``--replay I ...`` (bfloat16): requests that part too early to be judged
-- with fewer than ``MIN_AGREEING`` agreeing decode steps -- are served
again in other company until they have enough: as the first of a batch
of 12 whose other 11 prompts are new (``generate``'s batch and the
engine's admissions then hold other rows), then behind a shared prompt of
``REPLAY_PREFIXES`` tokens (every row of the batch carries it, the
request's own prompt after it).  The first replay in which the request
parts after enough agreeing steps is compared layer by layer, as above.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.layers import POS_EMPTY
from repro_torch.models.model import build_model
from repro_torch.serving import continuous
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import POS_SENTINEL
from repro_torch.serving.multitenant import Request

ARCH, REQUESTS, PROMPT_LEN, NEW_TOKENS = "internlm2-1.8b", 12, 128, 32
MIN_AGREEING = 3           # agreeing decode steps a judged request needs
REPLAY_PREFIXES = (0, 64, 128, 256, 512)   # shared prompt before a replay


class RecordingEngine(ContinuousBatchingEngine):
    """A continuous engine that keeps, before each decode step, every
    slot's request, step, liveness and the logits the step samples from.
    Its rounds run op by op (``round_graphs=False``): the records are host
    reads between steps, which a captured round cannot make (its tokens
    are the graph rounds', ``chip_smoke.compare_rounds``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, round_graphs=False, **kwargs)
        self.kept = []
        self.request_of = {}

    def _decode_step(self, *args):
        st, V = self.state, self.cfg.vocab_size
        self.kept.append((
            [None if sl is None else self.request_of[id(sl.req)]
             for sl in self._slots],
            st["lstep"].cpu().numpy().copy(),
            (st["remaining"] > 0).cpu().numpy(),
            st["logits"][:, :V].clone()))
        return super()._decode_step(*args)


class ResidualRecorder:
    """``apply_rmsnorm`` for the decode loops of both paths: while ``on``,
    keeps each call's input (the residual stream: before a layer's
    attention, before its MLP, and before the final norm)."""

    def __init__(self):
        self.on, self.calls = False, []
        self.real = transformer.apply_rmsnorm

    def __call__(self, p, x, *args, **kwargs):
        if self.on:
            self.calls.append(x.detach().float().clone())
        return self.real(p, x, *args, **kwargs)

    def patches(self):
        """Both call sites: the continuous decode step and the model's
        backbone (``generate``'s decode)."""
        return (mock.patch.object(continuous, "apply_rmsnorm", self),
                mock.patch.object(transformer, "apply_rmsnorm", self))

    def run(self, fn, *args):
        """``fn(*args)`` with recording on; returns its result and the
        inputs recorded."""
        self.calls, self.on = [], True
        try:
            return fn(*args), self.calls
        finally:
            self.on = False


def held_kv_paged(eng: ContinuousBatchingEngine, c: int):
    """The K and V slot ``c`` holds, read through its page table and the
    position pool: positions (n,) and per attention sublayer K, V (S, n,
    Hkv, D), in position order, on the host."""
    st = eng.state
    pt = st["page_table"][c].long()
    pos = st["pos_pool"][pt].reshape(-1)
    keep = pos < POS_SENTINEL
    order = torch.argsort(pos[keep])
    out = {"pos": pos[keep][order].cpu()}
    for name in eng.kv.attn_subs:
        for kind in ("k", "v"):
            pool = st["caches"][name][kind][:, pt]       # (S, NB, P, Hkv, D)
            flat = pool.reshape(pool.shape[0], -1, *pool.shape[3:])
            out[(name, kind)] = flat[:, keep][:, order].cpu()
    return out


def held_kv_dense(caches, i: int):
    """The same for row ``i`` of ``generate``'s dense ring caches."""
    name0 = next(iter(caches))
    pos = caches[name0]["pos"][0, i]
    keep = pos < POS_EMPTY
    order = torch.argsort(pos[keep])
    out = {"pos": pos[keep][order].cpu()}
    for name, sub in caches.items():
        for kind in ("k", "v"):
            out[(name, kind)] = sub[kind][:, i][:, keep][:, order].cpu()
    return out


class LayerRecordingEngine(RecordingEngine):
    """The recording engine, also keeping per (request, step) the residual
    rows of the forward that gave that step's logits and the K/V held
    after it, for the requests and steps in ``targets`` (request -> its
    parting step)."""

    def __init__(self, *args, recorder: ResidualRecorder, targets, **kwargs):
        super().__init__(*args, **kwargs)
        self.recorder, self.targets = recorder, targets
        self.residuals, self.held = {}, {}

    def _decode_step(self, *args):
        slots = [None if sl is None else self.request_of[id(sl.req)]
                 for sl in self._slots]
        lstep = self.state["lstep"].cpu().numpy().copy()
        live = (self.state["remaining"] > 0).cpu().numpy()
        _, calls = self.recorder.run(super()._decode_step, *args)
        for c, i in enumerate(slots):
            step = int(lstep[c]) + 1            # the logits this forward gave
            if i in self.targets and live[c] and step <= self.targets[i]:
                self.residuals[(i, step)] = torch.stack(
                    [x[c, 0] for x in calls]).cpu()
                self.held[(i, step)] = held_kv_paged(self, c)


def prompts_of_serve(vocab: int) -> np.ndarray:
    """The prompts ``launch.serve`` submits with no shared prefix."""
    rng = np.random.default_rng(0)
    rng.integers(1, vocab, 0)
    return np.stack([rng.integers(1, vocab, PROMPT_LEN).astype(np.int32)
                     for _ in range(REQUESTS)])


def generate_keeping_logits(eng: ServingEngine, prompts: np.ndarray,
                            after_decode=None):
    """``eng.generate`` with the logits of its prefill and of each decode
    call kept (through its model bundle): tokens (B, n), logits (n, B, V).
    ``after_decode(n, caches, calls)``, if given, runs after decode call
    ``n`` (the forward giving step ``n + 1``'s logits) with the residual
    inputs a :class:`ResidualRecorder` recorded in it."""
    bundle, kept = eng.bundle, []
    recorder = ResidualRecorder()

    def prefill_fn(params, batch):
        logits, caches, idx = bundle.prefill_fn(params, batch)
        kept.append(logits.float().clone())
        return logits, caches, idx

    def decode_fn(params, tok, caches, idx, sh=None):
        n = len(kept) - 1
        (logits, caches), calls = recorder.run(bundle.decode_fn, params, tok,
                                               caches, idx, sh)
        kept.append(logits.float().clone())
        if after_decode is not None:
            after_decode(n, caches, calls)
        return logits, caches

    eng.bundle = dataclasses.replace(bundle, prefill_fn=prefill_fn,
                                     decode_fn=decode_fn)
    try:
        with recorder.patches()[1]:
            tokens = eng.generate(prompts, max_new_tokens=NEW_TOKENS).tokens
    finally:
        eng.bundle = bundle
    return tokens, torch.stack(kept[:NEW_TOKENS])


def compare_layers(eng: ServingEngine, cfg, prompts: np.ndarray, dev,
                   targets, cont_tokens: np.ndarray, gen_tokens: np.ndarray
                   ) -> list:
    """Both paths again, recording; per target request (request -> its
    first divergent step, a decode step) the per-layer differences at that
    step and at the agreeing decode steps before it."""
    recorder = ResidualRecorder()
    ceng = LayerRecordingEngine(eng, capacity=8, page_size=16, inner_steps=4,
                                max_prompt_len=2 * prompts.shape[1],
                                device=dev, recorder=recorder,
                                targets=targets)
    reqs = [Request(f"f1-{i}", p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    ceng.request_of = {id(r): i for i, r in enumerate(reqs)}
    with recorder.patches()[0]:
        done = {ceng.request_of[id(r)]: t for r, t in ceng.run_all(reqs)}
    again = np.stack([done[i] for i in range(len(prompts))])
    if not np.array_equal(again, cont_tokens):
        raise RuntimeError("the continuous engine gave other tokens when "
                           "run again")
    diffs = {}                                  # (request, step) -> arrays

    def after_decode(n, caches, calls):
        for i, d in targets.items():
            if n + 1 > d:
                continue
            xc = ceng.residuals.pop((i, n + 1))
            xg = torch.stack([x[i, 0] for x in calls]).cpu()
            hc, hg = ceng.held.pop((i, n + 1)), held_kv_dense(caches, i)
            if not torch.equal(hc["pos"], hg["pos"]):
                raise RuntimeError(f"request {i} step {n + 1}: the two "
                                   "paths hold other positions")
            kv = {kind: np.concatenate([
                (hc[(name, kind)].float() - hg[(name, kind)].float()).abs()
                .flatten(1).max(dim=1).values.numpy()
                for name in ceng.kv.attn_subs]) for kind in ("k", "v")}
            diffs[(i, n + 1)] = dict(
                resid=(xc - xg).abs().max(dim=1).values.numpy(), **kv)

    gen, _ = generate_keeping_logits(eng, prompts, after_decode)
    if not np.array_equal(gen, gen_tokens):
        raise RuntimeError("generate gave other tokens when run again")
    n_layers = cfg.num_layers
    out = []
    for i, d in sorted(targets.items()):
        part = diffs[(i, d)]
        agree = [diffs[(i, t)] for t in range(1, d)]
        layers, first_past = [], None
        for l in range(n_layers):
            row = {"layer": l}
            # residual before layer l's MLP, and after layer l (before the
            # next layer's attention, or before the final norm)
            for key, idx in (("after_attention", 2 * l + 1),
                             ("after_layer", 2 * l + 2)):
                row[key] = float(part["resid"][idx])
                row[key + "_agreeing_max"] = (
                    max(float(a["resid"][idx]) for a in agree)
                    if agree else None)
            for kind in ("k", "v"):
                row[f"held_{kind}"] = float(part[kind][l])
                row[f"held_{kind}_agreeing_max"] = (
                    max(float(a[kind][l]) for a in agree) if agree else None)
            past = [key for key in ("after_attention", "after_layer",
                                    "held_k", "held_v")
                    if agree and row[key] > 2 * row[key + "_agreeing_max"]]
            row["past_twice_the_agreeing_max"] = past
            if past and first_past is None:
                first_past = l
            layers.append(row)
        out.append(dict(request=i, step=d, agreeing_steps=d - 1,
                        first_layer_past_twice=first_past, layers=layers))
    return out


def top2_margin(v: torch.Tensor) -> float:
    top = torch.topk(v, 2).values
    return float(top[0] - top[1])


def serve_both(eng: ServingEngine, prompts: np.ndarray, dev):
    """The prompts through a continuous engine (capacity 8, page 16, 4
    steps a round) and through ``generate`` (one batch), 32 greedy tokens
    each: (continuous tokens, generate tokens, the continuous logits by
    (request, step), generate's logits (n, B, V))."""
    V = eng.cfg.vocab_size
    ceng = RecordingEngine(eng, capacity=8, page_size=16, inner_steps=4,
                           max_prompt_len=2 * prompts.shape[1], device=dev)
    reqs = [Request(f"f1-{i}", p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    ceng.request_of = {id(r): i for i, r in enumerate(reqs)}
    done = {ceng.request_of[id(r)]: t for r, t in ceng.run_all(reqs)}
    if len(done) != len(prompts):
        raise RuntimeError(f"{len(done)} of {len(prompts)} requests served")
    cont = np.stack([done[i] for i in range(len(prompts))])
    gen, gen_logits = generate_keeping_logits(eng, prompts)
    cont_logits = {}                           # (request, step) -> logits
    for slots, lstep, live, logits in ceng.kept:
        for c, i in enumerate(slots):
            if i is not None and live[c]:
                cont_logits.setdefault((i, int(lstep[c])), logits[c])
    del ceng
    return cont, gen, cont_logits, gen_logits[:, :, :V]


def parting_step(cont: np.ndarray, gen: np.ndarray, i: int) -> int:
    """The first step where request ``i``'s two token rows differ
    (``NEW_TOKENS`` if none)."""
    same = cont[i] == gen[i]
    return NEW_TOKENS if same.all() else int(np.argmin(same))


@torch.no_grad()
def measure(compute_dtype: str, dev, reduced: bool = False,
            replay=()) -> dict:
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              compute_dtype=compute_dtype)
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    prompts = prompts_of_serve(cfg.vocab_size)
    cont, gen, cont_logits, gen_logits = serve_both(eng, prompts, dev)
    agree, parts, targets = [], [], {}
    for i in range(REQUESTS):
        last = parting_step(cont, gen, i)
        for d in range(min(last + 1, NEW_TOKENS)):
            cl, gl = cont_logits[(i, d)], gen_logits[d, i]
            if int(torch.argmax(cl)) != int(cont[i, d]) or \
                    int(torch.argmax(gl)) != int(gen[i, d]):
                raise RuntimeError(f"request {i}: the kept logits do not "
                                   f"give the tokens at step {d}")
            row = dict(request=i, step=d, margin_continuous=top2_margin(cl),
                       margin_generate=top2_margin(gl),
                       max_logit_diff=float((cl - gl).abs().max()))
            (agree if d < last else parts).append(row)
        if last < NEW_TOKENS and last > 0:
            targets[i] = last                   # parts at a decode step
    diffs = np.array([r["max_logit_diff"] for r in agree])
    worst = float(diffs.max())
    out = dict(
        compute_dtype=compute_dtype,
        token_agreement=float((cont == gen).mean()),
        requests_identical=int((cont == gen).all(axis=1).sum()),
        divergent=len(parts), agreeing_steps=len(agree),
        agreeing_diff_median=float(np.median(diffs)),
        agreeing_diff_p90=float(np.percentile(diffs, 90)),
        agreeing_diff_max=worst,
        agreeing_steps_with_a_margin_below_the_diff=sum(
            min(r["margin_continuous"], r["margin_generate"])
            < r["max_logit_diff"] for r in agree),
        divergences_within_the_agreeing_max=sum(
            r["max_logit_diff"] <= worst for r in parts),
        at_divergence=parts)
    del cont_logits, gen_logits
    gc.collect()
    out["layer_by_layer"] = compare_layers(eng, cfg, prompts, dev, targets,
                                           cont, gen)
    out["replays"] = [replay_request(eng, cfg, prompts, i, dev)
                      for i in replay]
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def replay_request(eng: ServingEngine, cfg, prompts: np.ndarray, i: int,
                   dev) -> dict:
    """Request ``i`` served again as the first of a batch of 12 with new
    neighbours, behind each shared prompt of ``REPLAY_PREFIXES`` in turn,
    until it parts after at least ``MIN_AGREEING`` agreeing decode steps;
    that replay is compared layer by layer.  Returns every replay's parting
    step (``NEW_TOKENS``: none) and the comparison (None if no replay
    parted late enough)."""
    tried = []
    for prefix_len in REPLAY_PREFIXES:
        rng = np.random.default_rng(1000 + prefix_len)
        prefix = rng.integers(1, cfg.vocab_size, prefix_len)
        rows = [prompts[i]] + [rng.integers(1, cfg.vocab_size, PROMPT_LEN)
                               for _ in range(REQUESTS - 1)]
        batch = np.stack([np.concatenate([prefix, r]) for r in rows]
                         ).astype(np.int32)
        cont, gen, _, _ = serve_both(eng, batch, dev)
        d = parting_step(cont, gen, 0)
        tried.append(dict(prefix=prefix_len, parts_at=d))
        if MIN_AGREEING < d < NEW_TOKENS:
            layers = compare_layers(eng, cfg, batch, dev, {0: d}, cont, gen)
            return dict(request=i, tried=tried, judged=layers[0])
    return dict(request=i, tried=tried, judged=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay", nargs="*", type=int, default=[],
                    help="bfloat16: serve these requests again in other "
                         "company until they part after enough agreeing "
                         "steps")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    result = {dt: measure(dt, dev, args.reduced,
                          args.replay if dt == "bfloat16" else ())
              for dt in args.dtypes}
    for r in result.values():
        print(f"[f1] {ARCH} {r['compute_dtype']}: agreement "
              f"{r['token_agreement']:.4f}, {r['requests_identical']} of "
              f"{REQUESTS} identical; agreeing steps {r['agreeing_steps']}: "
              f"largest logit difference median {r['agreeing_diff_median']:.3g}"
              f", p90 {r['agreeing_diff_p90']:.3g}, max "
              f"{r['agreeing_diff_max']:.3g}, "
              f"{r['agreeing_steps_with_a_margin_below_the_diff']} with a "
              f"margin below it; divergences {r['divergent']}, "
              f"{r['divergences_within_the_agreeing_max']} with a difference "
              f"within the agreeing max: " + str([
                  (p["request"], p["step"], round(p["margin_continuous"], 7),
                   round(p["margin_generate"], 7),
                   round(p["max_logit_diff"], 7))
                  for p in r["at_divergence"]]))
        for t in r["layer_by_layer"]:
            worst = max(t["layers"], key=lambda row: max(
                (row[k] / row[k + "_agreeing_max"] for k in
                 ("after_attention", "after_layer", "held_k", "held_v")
                 if row[k + "_agreeing_max"]), default=0.0)
            ) if t["agreeing_steps"] else None
            print(f"[f1] {r['compute_dtype']} request {t['request']} parts at "
                  f"step {t['step']} ({t['agreeing_steps']} agreeing decode "
                  f"steps): first layer past twice the agreeing max: "
                  f"{t['first_layer_past_twice']}; largest ratio at layer "
                  + ("n/a" if worst is None else str(worst["layer"]) + ": " +
                     str({k: (round(worst[k], 8),
                              round(worst[k + "_agreeing_max"], 8))
                          for k in ("after_attention", "after_layer",
                                    "held_k", "held_v")})))
        for rp in r["replays"]:
            j = rp["judged"]
            print(f"[f1] {r['compute_dtype']} request {rp['request']} "
                  "replayed, (shared prompt, parting step): "
                  f"{[(t['prefix'], t['parts_at']) for t in rp['tried']]}; "
                  + ("not judged (no replay parted after enough agreeing "
                     "steps)" if j is None else
                     f"judged at step {j['step']} ({j['agreeing_steps']} "
                     f"agreeing): first layer past twice the agreeing max: "
                     f"{j['first_layer_past_twice']}"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if kk not in ("at_divergence", "layer_by_layer",
                                        "replays")}
                      for k, v in result.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
