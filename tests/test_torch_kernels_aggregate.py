"""Port's aggregate-loss plain versions and oracles vs the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions (the
jnp oracles, and the Pallas kernel in interpret mode in both variants) and
through their PyTorch counterparts on the CPU.  The CUDA kernels themselves
cannot run without a card; ``chip_smoke.py`` holds them against the plain
versions tested here.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.aggregate_loss import aggregate_loss_pallas
from repro.kernels.ref import (aggregate_loss_chunked_ref as jax_chunked_ref,
                               aggregate_loss_ref as jax_ref)
from repro_torch.kernels import aggregate_loss as tagg
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import (aggregate_loss_chunked_ref,
                                     aggregate_loss_ref)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _case(rng, T, K, M, cat):
    ids = rng.integers(0, cat + 1, (T, K)).astype(np.int32)
    elt = np.abs(rng.normal(size=(cat + 1, M))).astype(np.float32)
    elt[0] = 0.0
    occ_r = (np.abs(rng.normal(size=M)) * 0.5).astype(np.float32)
    occ_l = (np.abs(rng.normal(size=M)) + 1.0).astype(np.float32)
    return ids, elt, occ_r, occ_l, float(K * 0.1), float(K * 0.8)


def _j(args):
    ids, elt, r, l, ar, al = args
    return (jnp.asarray(ids), jnp.asarray(elt), jnp.asarray(r),
            jnp.asarray(l), np.float32(ar), np.float32(al))


def _t(args):
    ids, elt, r, l, ar, al = args
    return (torch.from_numpy(ids), torch.from_numpy(elt),
            torch.from_numpy(r), torch.from_numpy(l), ar, al)


# the JAX package's own sweep (tests/test_kernels_aggregate.py)
SWEEP = [
    # T, K, M, cat, chunk, trial_block, rows_tile
    (64, 32, 3, 512, 16, 32, None),
    (128, 64, 5, 1000, 32, 64, 256),
    (32, 16, 1, 100, 8, 8, 64),
    (256, 128, 15, 4096, 128, 256, 512),
    (17, 24, 2, 50, 8, 16, None),      # odd trial count
    (48, 96, 7, 333, 48, 16, 100),     # non-pow2 catalog/tile
]


@pytest.mark.parametrize("T,K,M,cat,chunk,tb,rt", SWEEP)
def test_oracles_match_jax_oracles(rng, T, K, M, cat, chunk, tb, rt):
    args = _case(rng, T, K, M, cat)
    np.testing.assert_allclose(aggregate_loss_ref(*_t(args)).numpy(),
                               np.asarray(jax_ref(*_j(args))), rtol=1e-6)
    np.testing.assert_allclose(
        aggregate_loss_chunked_ref(*_t(args), chunk=chunk).numpy(),
        np.asarray(jax_chunked_ref(*_j(args), chunk=chunk)), rtol=1e-6)


@pytest.mark.parametrize("T,K,M,cat,chunk,tb,rt", SWEEP)
def test_plain_versions_match_jax_oracle(rng, T, K, M, cat, chunk, tb, rt):
    args = _case(rng, T, K, M, cat)
    want = np.asarray(jax_chunked_ref(*_j(args), chunk=chunk))
    got = tagg.aggregate_loss_gather_plain(*_t(args), chunk=chunk,
                                           trial_block=tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    got = tagg.aggregate_loss_onehot_plain(*_t(args), chunk=chunk,
                                           rows_tile=rt, trial_block=tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("variant", ["gather", "onehot"])
@pytest.mark.parametrize("T,K,M,cat,chunk,tb,rt", SWEEP)
def test_wrappers_match_pallas_interpret(rng, T, K, M, cat, chunk, tb, rt,
                                         variant):
    """Kernel-vs-kernel: the port's wrapper (plain version, CPU tensors) and
    the Pallas kernel in interpret mode; tolerance is the reference's own
    for kernel vs oracle (summation order differs)."""
    args = _case(rng, T, K, M, cat)
    want = aggregate_loss_pallas(*_j(args), chunk=chunk, trial_block=tb,
                                 rows_tile=rt, variant=variant)
    got = tops.aggregate_loss(*_t(args), chunk=chunk, variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)


def test_padded_table_view_computes_the_same(rng):
    """pad_elt_columns changes the layout only."""
    args = _t(_case(rng, 40, 24, 15, 300))
    view = tagg.pad_elt_columns(args[1])
    assert view.shape == args[1].shape and view.stride() == (16, 1)
    assert torch.equal(view, args[1])
    a = tagg.aggregate_loss_gather(*args, chunk=8)
    b = tagg.aggregate_loss_gather(args[0], view, *args[2:], chunk=8)
    assert torch.equal(a, b)
    # the layout the gather kernel asks of a table on the card
    tagg._require_padded_rows(view)
    with pytest.raises(ValueError, match="pad_elt_columns"):
        tagg._require_padded_rows(args[1])


def test_variant_selection_via_ops(rng):
    args = _case(rng, 32, 16, 2, 128)
    want = np.asarray(jax_chunked_ref(*_j(args), chunk=8))
    prev = tops.aggregate_variant()
    try:
        for variant, name in (("gather", "aggregate_loss_gather_plain"),
                              ("onehot", "aggregate_loss_onehot_plain")):
            tops.use_aggregate_variant(variant)
            assert tops.aggregate_variant() == variant
            before = tagg.plain_counts[name]
            got = tops.aggregate_loss(*_t(args), chunk=8)
            assert tagg.plain_counts[name] == before + 1
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
        with pytest.raises(ValueError):
            tops.use_aggregate_variant("scatter")
        with pytest.raises(ValueError):
            tops.aggregate_loss(*_t(args), chunk=8, variant="scatter")
    finally:
        tops.use_aggregate_variant(prev)


@pytest.mark.parametrize("value,ok", [("onehot", True), ("bogus", False)])
def test_env_variant_fail_fast(value, ok):
    """REPRO_AGG_VARIANT is checked when kernels.ops is imported."""
    env = dict(os.environ, REPRO_AGG_VARIANT=value, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.kernels import ops; print(ops.aggregate_variant())"],
        capture_output=True, text=True, env=env, timeout=240)
    if ok:
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.strip() == value
    else:
        assert proc.returncode != 0
        assert "REPRO_AGG_VARIANT" in proc.stderr


@pytest.mark.parametrize("variant", ["gather", "onehot"])
def test_pad_event_contributes_zero(variant):
    ids = torch.zeros((8, 16), dtype=torch.int32)        # all pads
    elt = torch.ones((100, 3))
    elt[0] = 0.0
    z = tops.aggregate_loss(ids, elt, torch.zeros(3), torch.full((3,), 1e9),
                            0.0, 1e9, chunk=16, variant=variant)
    np.testing.assert_allclose(z.numpy(), 0.0)


@pytest.mark.parametrize("variant", ["gather", "onehot"])
def test_occurrence_and_aggregate_clipping(variant):
    # one trial, one event of loss 10; occ_ret 2, occ_lim 5 -> event loss 5
    ids = torch.tensor([[1]], dtype=torch.int32)
    elt = torch.zeros((3, 1))
    elt[1, 0] = 10.0
    y = tops.aggregate_loss(ids, elt, torch.tensor([2.0]), torch.tensor([5.0]),
                            1.0, 3.0, chunk=1, variant=variant)
    # aggregate: max(5-1,0)=4, capped at 3
    np.testing.assert_allclose(y.numpy(), [3.0])


@pytest.mark.parametrize("variant", ["gather", "onehot"])
def test_ragged_event_axis_needs_no_padding(rng, variant):
    """K = 1000 is not a multiple of 128: the JAX dispatch pads the ids, the
    port walks a short last chunk; same result."""
    from repro.kernels import ops as jops
    args = _case(rng, 12, 1000, 3, 200)
    want = np.asarray(jops.aggregate_loss(*_j(args), chunk=128))
    got = tops.aggregate_loss(*_t(args), chunk=128, variant=variant)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("variant", ["gather", "onehot"])
def test_int64_ids(rng, variant):
    args = list(_t(_case(rng, 32, 32, 3, 128)))
    got32 = tops.aggregate_loss(*args, chunk=16, variant=variant)
    args[0] = args[0].long()
    got64 = tops.aggregate_loss(*args, chunk=16, variant=variant)
    assert torch.equal(got32, got64)


def test_out_of_range_ids_contribute_zero(rng):
    """As in the Pallas bodies: an id outside [0, rows) adds nothing."""
    ids, elt, r, l, ar, al = _case(rng, 16, 32, 4, 64)
    bad = ids.copy()
    bad[:, ::5] = 65 + 7            # past the table
    bad[:, 1::7] = -3
    clean = bad.copy()
    clean[(bad < 0) | (bad > 64)] = 0
    for variant in ("gather", "onehot"):
        got = tops.aggregate_loss(*_t((bad, elt, r, l, ar, al)), chunk=16,
                                  variant=variant)
        want = tops.aggregate_loss(*_t((clean, elt, r, l, ar, al)), chunk=16,
                                   variant=variant)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
        pallas = aggregate_loss_pallas(*_j((bad, elt, r, l, ar, al)),
                                       chunk=16, variant=variant)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=1e-5, atol=1e-3)


def test_wrapper_rejects_bad_arguments(rng):
    ids, elt, r, l, ar, al = _t(_case(rng, 4, 8, 3, 16))
    with pytest.raises(TypeError):
        tagg.aggregate_loss_gather(ids.float(), elt, r, l, ar, al)
    with pytest.raises(ValueError):
        tagg.aggregate_loss_gather(ids, elt, r[:2], l, ar, al)
    with pytest.raises(ValueError):
        tagg.aggregate_loss_gather(ids[0], elt, r, l, ar, al)
    with pytest.raises(ValueError):
        tagg.aggregate_loss_onehot(ids, elt, r, l, ar, al, rows_tile=0)
    with pytest.raises(ValueError):
        tagg.aggregate_loss_gather(ids, elt, r, l, ar, al, chunk=0)


# ---------------------------------------------------------------------------
# the gather's two passes: row losses f, then a gather of f per event
# ---------------------------------------------------------------------------
def _occurrence4_order(elt, occ_r, occ_l):
    """f[r] summed as a single pass over an event's 64 B row sums it
    (``occurrence4`` of the kernel source), in numpy float32 scalars: four
    columns at a time, each four left to right, the groups of four left to
    right (and groups of 16 one after another)."""
    rows, M = elt.shape
    m4 = 4 * (-(-M // 4))
    o = np.minimum(np.maximum(elt - occ_r, np.float32(0)), occ_l)
    o = np.pad(o.astype(np.float32), ((0, 0), (0, m4 - M)))
    f = np.zeros(rows, np.float32)
    for i in range(rows):
        total = None
        for g0 in range(0, m4 // 4, 4):
            s = np.float32(0)
            for v in range(g0, min(g0 + 4, m4 // 4)):
                q = o[i, 4 * v:4 * v + 4]
                s = np.float32(s + np.float32(np.float32(
                    np.float32(q[0] + q[1]) + q[2]) + q[3]))
            total = s if total is None else np.float32(total + s)
        f[i] = total
    return f


@pytest.mark.parametrize("M", [1, 3, 4, 5, 15, 16, 20, 33])
def test_row_pass_plain_equals_the_occurrence4_order(rng, M):
    """The row pass's plain version equals that per-row order bit for bit,
    on losses from 1 to 10^7 (the published range); the kernel is held
    against the plain version bit for bit on the card."""
    elt = (np.abs(rng.normal(size=(60, M)))
           * rng.choice([1.0, 1e4, 1e7], size=(60, M))).astype(np.float32)
    occ_r = (np.abs(rng.normal(size=M)) * 0.5).astype(np.float32)
    occ_l = (np.abs(rng.normal(size=M)) * 1e6 + 1.0).astype(np.float32)
    tagg.reset_counts()
    f = tagg.aggregate_row_losses(*(torch.from_numpy(v)
                                    for v in (elt, occ_r, occ_l)))
    assert tagg.plain_counts["aggregate_row_losses_plain"] == 1
    assert tagg.launch_counts["aggregate_row_losses"] == 0
    want = _occurrence4_order(elt, occ_r, occ_l)
    assert f.dtype == torch.float32 and f.shape == (60,)
    assert np.array_equal(f.numpy().view(np.int32), want.view(np.int32))


def _two_pass(ids, elt, occ_r, occ_l, agg_ret, agg_lim, chunk):
    """The kernel's function in its two steps: f from the row pass's plain
    version, then per trial the sum of f over its in-range ids, chunk by
    chunk, and the aggregate terms."""
    ids, elt, occ_r, occ_l = (torch.from_numpy(v)
                              for v in (ids, elt, occ_r, occ_l))
    f = tagg.aggregate_row_losses_plain(elt, occ_r, occ_l)
    rows = f.shape[0]
    acc = torch.zeros(ids.shape[0])
    for c0 in range(0, ids.shape[1], chunk):
        part = ids[:, c0:c0 + chunk].long()
        valid = (part >= 0) & (part < rows)
        acc += torch.where(valid, f[part.clamp(0, rows - 1)],
                           torch.zeros(())).sum(-1)
    return torch.clamp(torch.clamp(acc - agg_ret, min=0.0), max=agg_lim)


TWO_PASS = SWEEP + [
    (33, 1000, 15, 2000, 100, 16, None),   # the published K and M
    (24, 70, 20, 150, 32, 8, None),        # M > 16: two column groups
]


@pytest.mark.parametrize("T,K,M,cat,chunk,tb,rt", TWO_PASS)
def test_two_pass_form_matches_pallas_and_oracle(rng, T, K, M, cat, chunk,
                                                 tb, rt):
    """Row losses then a gather of them against the reference's Pallas
    kernel (interpret mode) and its jnp oracle at ``rtol=1e-6``: the pad id
    0 (a zero row), ids past the table and below 0 (they add 0, as in the
    Pallas body), and ``occ_ret`` 0 in some columns."""
    ids, elt, occ_r, occ_l, ar, al = _case(rng, T, K, M, cat)
    occ_r[::3] = 0.0
    ids[:, ::9] = 0
    bad = ids.copy()
    bad[:, 1::11] = cat + 5
    bad[:, 2::13] = -2
    got = _two_pass(bad, elt, occ_r, occ_l, ar, al, chunk).numpy()
    pallas = aggregate_loss_pallas(*_j((bad, elt, occ_r, occ_l, ar, al)),
                                   chunk=chunk, trial_block=tb,
                                   rows_tile=rt, variant="gather")
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6)
    clean = np.where((bad < 0) | (bad > cat), 0, bad).astype(np.int32)
    oracle = jax_ref(*_j((clean, elt, occ_r, occ_l, ar, al)))
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-6)


# ---------------------------------------------------------------------------
# the onehot kernel's arithmetic: per catalog tile, each trial's event
# histogram times the row losses f in float32
# ---------------------------------------------------------------------------
def _histogram_form(ids, elt, occ_r, occ_l, agg_ret, agg_lim, tile):
    """What the onehot kernel computes, in plain torch: f from the row
    pass's plain version, then per catalog tile of ``tile`` rows each
    trial's in-tile event counts times f, the tiles added in order, then
    the aggregate terms."""
    f = tagg.aggregate_row_losses_plain(*(torch.from_numpy(v)
                                          for v in (elt, occ_r, occ_l)))
    ids = torch.from_numpy(ids).long()
    rows = f.shape[0]
    acc = torch.zeros(ids.shape[0])
    for base in range(0, rows, tile):
        rt = min(tile, rows - base)
        local = ids - base
        valid = (local >= 0) & (local < rt)
        counts = torch.zeros(ids.shape[0], rt)
        counts.scatter_add_(1, local.clamp(0, rt - 1), valid.float())
        acc += counts @ f[base:base + rt]
    return torch.clamp(torch.clamp(acc - agg_ret, min=0.0), max=agg_lim)


# T, K, M, catalog, tile: several tiles with a ragged last one, a tile of
# one row, and one tile wider than the catalog
HIST_CASES = [(24, 64, 15, 300, 64), (16, 48, 20, 130, 50),
              (9, 100, 15, 40, 41), (12, 32, 15, 20, 1),
              (10, 80, 20, 200, 512)]


@pytest.mark.parametrize("T,K,M,cat,tile", HIST_CASES)
def test_histogram_form_matches_the_onehot_pallas_kernel(rng, T, K, M, cat,
                                                         tile):
    """The histogram form against the reference's onehot Pallas body
    (interpret mode) at the kernel-vs-plain hold: ids past the table and
    below 0 (they add 0), the pad id 0, and a trial whose events all hit one
    row."""
    ids, elt, occ_r, occ_l, ar, al = _case(rng, T, K, M, cat)
    ids[:, 1::11] = cat + 5
    ids[:, 2::13] = -2
    ids[:, ::9] = 0
    ids[3] = cat // 2 + 1
    got = _histogram_form(ids, elt, occ_r, occ_l, ar, al, tile)
    pallas = aggregate_loss_pallas(*_j((ids, elt, occ_r, occ_l, ar, al)),
                                   chunk=K // 4, trial_block=T,
                                   rows_tile=min(tile, cat + 1),
                                   variant="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-3)
    plain = tagg.aggregate_loss_onehot(*_t((ids, elt, occ_r, occ_l, ar, al)),
                                       chunk=K // 4, rows_tile=tile)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-3)


def test_onehot_raises_past_its_exact_count(rng):
    """A trial's count of one row lives in 16 bits: the wrapper refuses K
    past 65,535 and takes K at the limit."""
    args = list(_t(_case(rng, 1, tagg.ONEHOT_MAX_EVENTS, 3, 20)))
    tagg.aggregate_loss_onehot(*args)
    args[0] = torch.zeros((1, tagg.ONEHOT_MAX_EVENTS + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="65535"):
        tagg.aggregate_loss_onehot(*args)
