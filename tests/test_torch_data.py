"""The port's synthetic token pipeline against the JAX package's.

* ``synth_batch`` bit for bit with the reference's, for several seeds and
  steps, with and without a vision arch's patch embeddings and an
  encoder-decoder's frames;
* ``PrefetchFeed`` hands over the batches in order, a feed started at step
  k gives batch k (checkpoint-consistent restart), ``wait_s`` grows, and
  ``close`` stops its producer thread (on the CPU: tensors handed over as
  they are);
* the feed's default device is the CPU; a CUDA device without a card
  raises.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import tokens as jtok
from repro_torch.configs import get_config
from repro_torch.data import tokens as ttok


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
@pytest.mark.parametrize("arch", [None, "llava-next-mistral-7b",
                                  "whisper-base"])
def test_synth_batch_bit_identical(seed, step, arch):
    jcfg = jax_config(arch).reduced() if arch else None
    cfg = get_config(arch).reduced() if arch else None
    vocab = cfg.vocab_size if cfg else 1000
    want = jtok.synth_batch(jtok.DataConfig(4, 33, vocab, seed=seed), step,
                            jcfg)
    got = ttok.synth_batch(ttok.DataConfig(4, 33, vocab, seed=seed), step,
                           cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_order_restart_and_close():
    dc = ttok.DataConfig(2, 16, 300, seed=1)
    feed = ttok.PrefetchFeed(dc, depth=2)
    got = [next(feed)["tokens"] for _ in range(4)]
    feed.close()
    assert not feed._thread.is_alive()
    assert feed.wait_s >= 0.0
    want = [jtok.synth_batch(jtok.DataConfig(2, 16, 300, seed=1), s)["tokens"]
            for s in range(4)]
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    feed2 = ttok.PrefetchFeed(dc, start_step=2)
    g2 = next(feed2)
    feed2.close()
    np.testing.assert_array_equal(g2["tokens"].numpy(), want[2])
    np.testing.assert_array_equal(
        g2["labels"].numpy(), ttok.synth_batch(dc, 2)["labels"])


def test_prefetch_carries_modality_extras():
    cfg = get_config("whisper-base").reduced()
    dc = ttok.DataConfig(2, 8, cfg.vocab_size)
    feed = ttok.PrefetchFeed(dc, cfg)
    b = next(feed)
    feed.close()
    assert b["frames"].shape == (2, cfg.encoder_seq_len, cfg.d_model)
    np.testing.assert_array_equal(b["frames"].numpy(),
                                  ttok.synth_batch(dc, 0, cfg)["frames"])


def test_prefetch_to_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttok.PrefetchFeed(ttok.DataConfig(2, 8, 100), device="cuda")
