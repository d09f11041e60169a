"""Where internlm2-1.8b's continuous serving path and ``generate`` part, at
full width on one CUDA device (open item F1 in ROADMAP.md).

    python3 diagnostics/f1_internlm2.py [--dtypes bfloat16 float32]
                                        [--out f1.json]

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
step's.  The script reports both and decides nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import Request

ARCH, REQUESTS, PROMPT_LEN, NEW_TOKENS = "internlm2-1.8b", 12, 128, 32


class RecordingEngine(ContinuousBatchingEngine):
    """A continuous engine that keeps, before each decode step, every
    slot's request, step, liveness and the logits the step samples from."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
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


def prompts_of_serve(vocab: int) -> np.ndarray:
    """The prompts ``launch.serve`` submits with no shared prefix."""
    rng = np.random.default_rng(0)
    rng.integers(1, vocab, 0)
    return np.stack([rng.integers(1, vocab, PROMPT_LEN).astype(np.int32)
                     for _ in range(REQUESTS)])


def generate_keeping_logits(eng: ServingEngine, prompts: np.ndarray):
    """``eng.generate`` with the logits of its prefill and of each decode
    call kept (through its model bundle): tokens (B, n), logits (n, B, V)."""
    bundle, kept = eng.bundle, []

    def prefill_fn(params, batch):
        logits, caches, idx = bundle.prefill_fn(params, batch)
        kept.append(logits.float().clone())
        return logits, caches, idx

    def decode_fn(params, tok, caches, idx):
        logits, caches = bundle.decode_fn(params, tok, caches, idx)
        kept.append(logits.float().clone())
        return logits, caches

    eng.bundle = dataclasses.replace(bundle, prefill_fn=prefill_fn,
                                     decode_fn=decode_fn)
    try:
        tokens = eng.generate(prompts, max_new_tokens=NEW_TOKENS).tokens
    finally:
        eng.bundle = bundle
    return tokens, torch.stack(kept[:NEW_TOKENS])


def top2_margin(v: torch.Tensor) -> float:
    top = torch.topk(v, 2).values
    return float(top[0] - top[1])


@torch.no_grad()
def measure(compute_dtype: str, dev, reduced: bool = False) -> dict:
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              compute_dtype=compute_dtype)
    V = cfg.vocab_size
    eng = ServingEngine(cfg, build_model(cfg).init(0, dev), device=dev)
    prompts = prompts_of_serve(V)
    ceng = RecordingEngine(eng, capacity=8, page_size=16, inner_steps=4,
                           max_prompt_len=2 * PROMPT_LEN, device=dev)
    reqs = [Request(f"f1-{i}", p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    ceng.request_of = {id(r): i for i, r in enumerate(reqs)}
    done = {ceng.request_of[id(r)]: t for r, t in ceng.run_all(reqs)}
    if len(done) != REQUESTS:
        raise RuntimeError(f"{len(done)} of {REQUESTS} requests served")
    cont = np.stack([done[i] for i in range(REQUESTS)])
    gen, gen_logits = generate_keeping_logits(eng, prompts)
    cont_logits = {}                           # (request, step) -> logits
    for slots, lstep, live, logits in ceng.kept:
        for c, i in enumerate(slots):
            if i is not None and live[c]:
                cont_logits.setdefault((i, int(lstep[c])), logits[c])
    agree, parts = [], []
    for i in range(REQUESTS):
        same = cont[i] == gen[i]
        last = NEW_TOKENS if same.all() else int(np.argmin(same))
        for d in range(min(last + 1, NEW_TOKENS)):
            cl, gl = cont_logits[(i, d)], gen_logits[d, i, :V]
            if int(torch.argmax(cl)) != int(cont[i, d]) or \
                    int(torch.argmax(gl)) != int(gen[i, d]):
                raise RuntimeError(f"request {i}: the kept logits do not "
                                   f"give the tokens at step {d}")
            row = dict(request=i, step=d, margin_continuous=top2_margin(cl),
                       margin_generate=top2_margin(gl),
                       max_logit_diff=float((cl - gl).abs().max()))
            (agree if d < last else parts).append(row)
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
    del ceng, eng, gen_logits, cont_logits
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    result = {dt: measure(dt, dev, args.reduced) for dt in args.dtypes}
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if kk != "at_divergence"}
                      for k, v in result.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
