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
        capture_output=True, text=True, env=env, timeout=300)
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
