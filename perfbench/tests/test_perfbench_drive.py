"""Whole runs on the CPU at small sizes, the chip's look skipped: each
driver runs its window and its check, and comes out not correct with the
timed path broken underneath -- an answer or a token altered where it is
produced, half of the batch left out, a what-if that returns the state
unchanged -- and with the control, the reference one precision below the
configuration's, in the program's place."""
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import arrivals  # noqa: E402
import harness  # noqa: E402

SPEC = harness.Spec.load(ROOT)
RISK = dict(num_trials=2048, events_per_trial=64, num_elts=15,
            event_catalog=3000, chunk_events=16)
LM = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
          head_dim=16, d_ff=128, vocab_size=256)
MIX = dict(rate=6.0, prompt=dict(median=40, sigma=0.5, min=20, max=80),
           output=dict(median=24, sigma=0.4, min=12, max=40),
           engine=dict(capacity=4, page_size=16, inner_steps=4,
                       max_prompt_len=96), system_prompt=8, warm_seconds=0.5)
SEED = 2 ** 31 + 977


def risk_run(cell, faults=None, **over):
    return harness.run_cell(SPEC, cell, SEED, 0.5, False,
                            torch.device("cpu"), time.perf_counter(),
                            guard=False, config_overrides=RISK,
                            overrides=over, faults=faults)


def serve_run(faults=None, **over):
    return harness.run_cell(SPEC, "internlm2-chat", SEED, 1.5, False,
                            torch.device("cpu"), time.perf_counter(),
                            guard=False, config_overrides=LM,
                            overrides=dict(MIX, **over), faults=faults)


def _alter_one(i, ylt):
    out = np.array(ylt, copy=True)
    out[len(out) // 3] *= 1.01
    return out


def _half_left_out(i, ylt):
    out = np.array(ylt, copy=True)
    out[len(out) // 2:] = 0.0
    return out


def _stale_terms(i):
    """The what-if not applied: each analysis is handed the terms of the
    one before it (the first, those of the last warm-up run)."""
    return i - 1 if i else -1


@pytest.mark.parametrize("cell", ["ara-paper-seq4", "ara-whatif-resident"])
def test_risk_cell_runs_correct(cell):
    out = risk_run(cell)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    runs = "ara_runs_per_s" if cell == "ara-paper-seq4" \
        else "whatif_runs_per_s"
    assert out["metrics"][runs]["value"] > 0
    assert out["checks"]["ylt_gap"]["value"] < 1e-6


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", ["ara-paper-seq4", "ara-whatif-resident"])
def test_risk_faults_come_out_not_correct(cell, fault):
    f = {"altered": {"ylt": _alter_one}, "half": {"ylt": _half_left_out},
         "unchanged": {"terms": _stale_terms}}[fault]
    out = risk_run(cell, faults=f)
    assert out["correct"] is False, out["checks"]


def test_risk_control_comes_out_not_correct():
    out = risk_run("ara-paper-seq4", control=True)
    limit = out["checks"]["ylt_gap"]["limit"]
    assert out["checks"]["ylt_gap"]["value"] < limit < \
        out["control"]["ylt_gap"]


def test_serving_cell_runs_correct():
    out = serve_run()
    assert out["correct"] is True
    assert out["attempted"] == 9 and out["failed"] == 0
    assert {"ttft_p95_ms", "tpot_p95_ms", "setup_s"} <= set(out["metrics"])


def test_serving_token_altered_comes_out_not_correct():
    def alter(i, toks):
        toks[len(toks) // 2] = (toks[len(toks) // 2] + 1) % LM["vocab_size"]
        return toks
    out = serve_run(faults={"tokens": alter})
    assert out["correct"] is False, out["checks"]


def test_serving_sampled_tokens_altered_fail_the_top_k_check():
    """Tokens of the top-k sampled requests alone moved half the vocabulary
    away: the greedy check still passes, the top-k one does not."""
    mix = dict(SPEC.traffic("internlm2-chat"), **MIX)
    arr = arrivals.schedule(mix, 1.5, SEED, LM["vocab_size"])

    def alter(i, toks):
        if arr[i].top_k > 0:
            toks = (toks + LM["vocab_size"] // 2) % LM["vocab_size"]
        return toks
    out = serve_run(faults={"tokens": alter})
    checks = out["checks"]
    assert checks["logit_gap"]["value"] <= checks["logit_gap"]["limit"]
    assert checks["topk_gap"]["value"] > checks["topk_gap"]["limit"]
    assert out["correct"] is False


def test_serving_stamps_every_completed_request():
    """First and last tokens on the benchmark's clock, after the request
    was due and in order, for every request answered."""
    driver = harness.load_module(BENCH / "drivers" / "serve_open.py")
    ctx = harness.Context(
        config=dict(SPEC.config("internlm2-1.8b"), **LM),
        traffic=SPEC.traffic("internlm2-chat"), seed=SEED, seconds=1.5,
        trace=False, device=torch.device("cpu"),
        t_start=time.perf_counter(), guard=False, overrides=MIX)
    rec = driver.run(ctx)
    rows = rec["requests"]
    assert rec["failed"] == 0 and rows
    for r in rows:
        assert r["due"] <= r["first"] < r["last"]


@pytest.mark.parametrize("check", ["logit_gap", "topk_gap"])
def test_serving_control_reads_above_the_program(check):
    """At this size the float8 control's gap is not held to the cell's
    limit (set at the published widths); it still reads above the
    program's, and well above nought."""
    out = serve_run(control=True)
    assert out["control"][check] > max(0.05, out["checks"][check]["value"])
