"""The port's ``loss_fn`` and every parameter leaf's gradient against the
reference's for reduced jamba (Mamba-2 and attention layers in one stage,
MoE sublayers: the SSD, attention and the aux losses in one loss), by the
method and tolerances of tests/test_torch_train.py."""
from test_torch_train import hold_loss_and_grads


def test_loss_and_grads_match_reference():
    hold_loss_and_grads("jamba-1.5-large-398b")
