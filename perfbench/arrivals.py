"""The one generator of serving traffic, driven by a mix's parameters.

Every seed gets the same work in another order: the prompt and output
lengths are the quantiles ``(i + 0.5) / n`` of their clipped lognormal
distributions, the gaps between arrivals those of the exponential at the
mix's rate (Poisson arrivals), the tenants' counts their shares of ``n``
and the greedy requests a fixed count; the seed permutes each list and
draws the tokens.  So two seeds differ in order and content, not in size.

A mix's parameters (``traffic/<name>.json``):

* ``rate``: requests a second; ``n = round(rate * seconds)`` arrive within
  the window;
* ``prompt`` / ``output``: ``{"median", "sigma", "min", "max"}`` in tokens
  (the prompt's length includes its tenant's system prompt);
* ``tenants``: ``{"name": share}``; ``system_prompt``: tokens a tenant's
  requests share at their start;
* ``greedy_share``; ``sampling``: ``{"temperature", "top_k"}`` of the
  others.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass
class Arrival:
    due_s: float              # seconds after the window opens
    tenant: str
    prompt: np.ndarray        # (S,) int32
    max_new_tokens: int
    temperature: float
    top_k: int
    seed: int


def quantile_grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(n: int, dist: Dict[str, Any]) -> np.ndarray:
    """``n`` lengths at the clipped lognormal's quantiles."""
    z = np.array([_NORMAL.inv_cdf(p) for p in quantile_grid(n)])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def request_count(mix: Dict[str, Any], seconds: float) -> int:
    return max(1, int(round(mix["rate"] * seconds)))


def shape_set(mix: Dict[str, Any], seconds: float) -> Dict[str, np.ndarray]:
    """The sizes every seed shares, before the seed orders them."""
    n = request_count(mix, seconds)
    return {"prompt": lengths(n, mix["prompt"]),
            "output": lengths(n, mix["output"])}


def schedule(mix: Dict[str, Any], seconds: float, seed: int,
             vocab: int) -> List[Arrival]:
    """The window's arrivals, in due order."""
    rng = np.random.default_rng(seed)
    n = request_count(mix, seconds)
    sizes = shape_set(mix, seconds)
    prompt_len = rng.permutation(sizes["prompt"])
    out_len = rng.permutation(sizes["output"])
    gaps = -np.log1p(-quantile_grid(n)) / mix["rate"]
    due = np.cumsum(rng.permutation(gaps))
    due -= due[0]
    names = list(mix["tenants"])
    shares = np.array([mix["tenants"][t] for t in names], np.float64)
    exact = shares / shares.sum() * n
    counts = np.floor(exact).astype(np.int64)
    counts[np.argsort(counts - exact)[:n - counts.sum()]] += 1
    tenant = rng.permutation(np.repeat(np.arange(len(names)), counts))
    n_greedy = int(round(mix["greedy_share"] * n))
    greedy = rng.permutation(np.arange(n) < n_greedy)
    sys_len = int(mix["system_prompt"])
    system = rng.integers(1, vocab, size=(len(names), sys_len), dtype=np.int32)
    samp = mix.get("sampling", {"temperature": 0.0, "top_k": 0})
    seeds = rng.integers(0, 2 ** 31 - 1, size=n)
    out: List[Arrival] = []
    for i in range(n):
        own = rng.integers(1, vocab, size=max(0, prompt_len[i] - sys_len),
                           dtype=np.int32)
        prompt = np.concatenate([system[tenant[i]], own])[:prompt_len[i]]
        g = bool(greedy[i])
        out.append(Arrival(
            due_s=float(due[i]), tenant=names[tenant[i]], prompt=prompt,
            max_new_tokens=int(out_len[i]),
            temperature=0.0 if g else float(samp["temperature"]),
            top_k=0 if g else int(samp["top_k"]), seed=int(seeds[i])))
    return out
