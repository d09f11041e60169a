"""The port's ``loss_fn`` and every parameter leaf's gradient against the
reference's, for the reduced archs beyond internlm2 (the tolerances and the
method of tests/test_torch_train.py): h2o-danube (sliding window), mamba2
(the SSD through ``SsdChunkedFn``), olmoe (MoE aux and z losses), llava
(patch embeddings merged into the prompt) and whisper (encoder, decoder
self- and cross-attention; aux 0).  jamba, whose reference gradient alone
takes ~15 s to compile, has tests/test_torch_train_jamba.py."""
import pytest

from test_torch_train import hold_loss_and_grads


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-2.7b",
                                  "olmoe-1b-7b", "llava-next-mistral-7b",
                                  "whisper-base"])
def test_loss_and_grads_match_reference(arch):
    hold_loss_and_grads(arch)
