"""The metric arithmetic: tails over every request timed from when it was
due, failed requests missing the tail, rates over the whole window; the
roofline counts on known shapes against the port's recorded bounds; the
trace's interval arithmetic."""
import math
import pathlib
import sys

import numpy as np
import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import devtrace  # noqa: E402
import harness  # noqa: E402
from roofline import k1, k3, k5, lm_step  # noqa: E402
from stats import percentile  # noqa: E402


def metric(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read


def _req(due, first, last, n, outcome="completed"):
    return {"due": due, "first": first, "last": last, "n": n,
            "outcome": outcome}


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_matches_numpy(q):
    v = np.random.default_rng(q).lognormal(size=37)
    assert percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_ttft_is_timed_from_due_over_every_request():
    # 20 requests due at t, each answered 0.1 s after it was due, save one
    # that waited 2 s behind a stall (its send came late: due still counts)
    rows = [_req(t, t + 0.1, t + 1.0, 10) for t in range(19)]
    rows.append(_req(19.0, 21.0, 22.0, 10))
    v = metric("ttft_p95_ms")({"requests": rows})
    assert v == pytest.approx(np.percentile([100.0] * 19 + [2000.0], 95))


def test_failed_requests_miss_the_tail():
    rows = [_req(t, t + 0.1, t + 1.0, 10) for t in range(18)]
    rows += [_req(18.0, 0, 0, 0, "rejected"), _req(19.0, 0, 0, 0, "failed")]
    assert metric("ttft_p95_ms")({"requests": rows}) == math.inf
    ok = metric("tpot_p95_ms")({"requests": rows})
    assert ok == pytest.approx(100.0)      # 0.9 s over 9 gaps


def test_tpot_skips_single_token_answers():
    rows = [_req(0, 0.2, 0.2, 1), _req(0, 0.1, 0.5, 5)]
    assert metric("tpot_p95_ms")({"requests": rows}) == pytest.approx(100.0)


def test_rate_is_over_the_whole_window():
    runs = [{"t_start": i * 0.1, "t_end": i * 0.1 + 0.1, "device": None}
            for i in range(50)]
    rec = {"runs": runs, "window_s": 5.0, "energy_j": 800.0}
    assert metric("ara_runs_per_s")(rec) == pytest.approx(10.0)
    assert metric("ara_j_per_run")(rec) == pytest.approx(16.0)
    assert metric("ara.mean_w")(rec) == pytest.approx(160.0)


def test_readers_return_nothing_without_their_source():
    for name in ("ara.k1_roofline", "k3_roofline", "k5_roofline",
                 "mfu.chat", "idle.chat", "ara.idle_share",
                 "whatif.k1_roofline", "whatif.idle_share",
                 "prefill_ms_per_ktok", "decode_step_ms", "ara.h2d_gbps"):
        assert metric(name)({"requests": [], "runs": []}) is None


def test_k1_bound_at_the_recorded_shape():
    # PERF.md: the gather at ids (500000, 1000), ELT (2000001, 15): 0.633 ms
    s, by = k1.bound(500000, 1000, 15, 2000001)
    assert by == "bytes" and s * 1e3 == pytest.approx(0.633, abs=5e-4)


def test_k3_bound_at_internlm2s_shape():
    # PERF.md: q (8, 16, 128) bf16, pools (NP, 16, 8, 128), 20 pages a row
    s, by = k3.bound(8, 20, 16, 16, 8, 128)
    assert by == "bytes" and s * 1e3 == pytest.approx(0.0032, abs=5e-5)


def test_k5_bound_at_internlm2s_prefill():
    # PERF.md: q (8, 128, 16, 128), k/v (8, 128, 8, 128) bf16, causal
    s, _ = k5.bound(8, 128, 128, 16, 8, 128)
    assert s * 1e3 == pytest.approx(0.0038, abs=5e-5)
    assert k5.pairs(4, 4, True, None) == 10
    assert k5.pairs(4, 4, True, 2) == 7
    assert k5.pairs(2, 4, True, None) == 7


def test_model_flops_count_every_product():
    m = {"num_layers": 1, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 2, "d_ff": 8, "vocab_size": 10}
    # q 4x4, k and v 4x2 each, o 4x4, gate/up/down 3 x 4x8
    assert lm_step.dense_flops(m) == 2 * (16 + 16 + 16 + 96)
    assert lm_step.decode_flops(m, 3) == 288 + 4 * 2 * 2 * 3 + 2 * 4 * 10


def test_k3_reader_counts_the_pages_rows_name():
    m = {"num_layers": 2, "num_heads": 16, "num_kv_heads": 8,
         "head_dim": 128}
    # 10 row-steps of rows naming 20 pages each, in 1 ms of kernel time
    rec = {"model": m, "page_size": 16,
           "slice": {"start": (0.0, {}), "stop": (1.0, {})},
           "pool": [[0.0, 0, 2, 40], [0.5, 10, 2, 40], [1.0, 10, 0, 0]],
           "trace": {"kernels_s": {"paged_decode_kernel<bf16>": 1e-3}}}
    want = 2 * (10 * (k3.nbytes(1, 20, 16, 16, 8, 128)))
    got = metric("k3_roofline")(rec)
    assert got == pytest.approx(100 * want / 3.35e12 / 1e-3)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert devtrace.union_s(iv) == 4
    assert devtrace.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert devtrace.short_name(
        "void (anonymous namespace)::gather_kernel(int const*, float)") \
        == "gather_kernel"
