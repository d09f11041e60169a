"""The port's checkpoints (``repro_torch.distributed.checkpoint``) against
the JAX package's: save/restore round trips, atomic commit markers, garbage
collection, shape checks, bfloat16 bit for bit, and checkpoints the
reference wrote read back by the port.  The fault injector
(``FaultPlane``) is held against the reference's on the same event
sequence."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro.distributed import fault as jfault
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import fault


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.tensor(3.5, dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 10, t)
    assert ckpt.latest_step(tmp_path) == 10
    r = ckpt.restore(tmp_path, 10, t)
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_async_save(tmp_path):
    t = _tree()
    th = ckpt.save_async(tmp_path, 5, t)
    th.join()
    assert ckpt.latest_step(tmp_path) == 5


def test_gc_keeps_last(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep_last=2)
    assert ckpt.available_steps(tmp_path) == [4, 5]


def test_partial_checkpoint_ignored(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    # a partial write: a directory without its .done marker
    (tmp_path / "step_2").mkdir()
    (tmp_path / "step_2" / "manifest.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) == 1
    (tmp_path / "engine_3").mkdir()
    (tmp_path / "engine_3" / "engine.json").write_text("{}")
    assert ckpt.latest_engine_step(tmp_path) is None
    assert ckpt.load_engine_checkpoint(tmp_path) == (None, None)


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((5, 8))
    with pytest.raises(AssertionError):
        ckpt.restore(tmp_path, 1, bad)


def test_bf16_round_trips_bit_for_bit(tmp_path):
    """numpy has no bfloat16: a bf16 tensor is stored as its bytes with a
    dtype tag and comes back with the same bits -- NaN payloads, infinities,
    subnormals and negative zero included -- in a tree and in an engine
    checkpoint."""
    bits = torch.from_numpy(np.array(
        [0x7FC1, 0xFF80, 0x7F80, 0x0001, 0x8000, 0x3F80, 0x4049, 0xC2F7],
        np.uint16).view(np.int16))
    raw = bits.view(torch.bfloat16)
    x = (torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16))
    tree = {"raw": raw, "x": x, "scalar": raw[5].clone()}
    ckpt.save(tmp_path / "t", 0, tree)
    back = ckpt.restore(tmp_path / "t", 0, tree)
    for k in tree:
        assert back[k].dtype == torch.bfloat16 and back[k].shape == \
            tree[k].shape
        assert torch.equal(back[k].view(torch.int16),
                           tree[k].view(torch.int16)), k
    ckpt.save_engine_checkpoint(tmp_path / "e", 4, {"k": [1, 2]},
                                {"live/0/kv/sub0/k": x, "raw": raw,
                                 "f": torch.arange(3.0)})
    assert ckpt.engine_checkpoint_steps(tmp_path / "e") == [4]
    meta, arrays = ckpt.load_engine_checkpoint(tmp_path / "e")
    assert meta == {"k": [1, 2]}
    assert torch.equal(arrays["live/0/kv/sub0/k"].view(torch.int16),
                       x.view(torch.int16))
    assert torch.equal(arrays["raw"].view(torch.int16), bits)
    assert torch.equal(arrays["f"], torch.arange(3.0))


def test_engine_checkpoint_gc_and_atomic_marker(tmp_path):
    for s in range(5):
        ckpt.save_engine_checkpoint(tmp_path, s, {"s": s},
                                    {"a": np.full(3, s, np.int32)},
                                    keep_last=2)
    assert ckpt.engine_checkpoint_steps(tmp_path) == [3, 4]
    (tmp_path / "engine_4.done").unlink()        # a save cut before commit
    assert ckpt.latest_engine_step(tmp_path) == 3
    meta, arrays = ckpt.load_engine_checkpoint(tmp_path)
    assert meta == {"s": 3}
    np.testing.assert_array_equal(arrays["a"].numpy(), [3, 3, 3])


def test_reads_checkpoints_the_reference_wrote(tmp_path):
    """A tree and an engine checkpoint (bf16 through ml_dtypes) written by
    the JAX package load in the port with the same values and bits."""
    k = jax.random.PRNGKey(0)
    jtree = {"a": jax.random.normal(k, (4, 8)),
             "nested": {"b": jnp.arange(10, dtype=jnp.int32),
                        "c": jnp.float32(3.5)},
             "step": jnp.int32(7)}
    jckpt.save(tmp_path / "t", 3, jtree)
    back = ckpt.restore(tmp_path / "t", 3, _tree())
    for a, b in zip(jax.tree.leaves(jtree), _leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = np.asarray(jax.random.normal(k, (2, 3, 4)), ml_dtypes.bfloat16)
    jckpt.save_engine_checkpoint(tmp_path / "e", 1, {"m": 1},
                                 {"x": x, "i": np.arange(4, dtype=np.int64)})
    meta, arrays = ckpt.load_engine_checkpoint(tmp_path / "e", 1)
    assert meta == {"m": 1}
    assert arrays["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(arrays["x"].view(torch.int16).numpy(),
                                  x.view(np.int16))
    np.testing.assert_array_equal(arrays["i"].numpy(), np.arange(4))


@pytest.mark.parametrize("knobs", [
    dict(drop_round_every=2), dict(stall_admission_every=3),
    dict(poison_swap_every=1),
    dict(drop_round_every=3, stall_admission_every=2, poison_swap_every=4)])
def test_fault_plane_fires_as_the_reference(knobs):
    """The same event sequence raises at the same events, and the
    injection ledgers agree."""
    mine, ref = fault.FaultPlane(**knobs), jfault.FaultPlane(**knobs)
    seq = ["round", "admission", "swap", "round", "round", "admission",
           "swap", "swap", "round", "admission", "round", "swap"] * 2
    for ev in seq:
        outcomes = []
        for plane, exc in ((mine, fault.InjectedFault),
                           (ref, jfault.InjectedFault)):
            fn = {"round": plane.round_fault,
                  "admission": plane.admission_fault,
                  "swap": plane.swap_read_fault}[ev]
            try:
                fn()
                outcomes.append(False)
            except exc:
                outcomes.append(True)
        assert outcomes[0] == outcomes[1], ev
    assert mine.injected == ref.injected
    assert mine.total_injected() == ref.total_injected() > 0
    mine.swap_put_crash()                  # crash_at_swap=0: never fires
    assert mine.swap_puts == 1
