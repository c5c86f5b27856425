"""The whole training step (``train/trainer.py``): the share of the
device's idle time in the traced steps during which the calling thread is
inside the span ``train.backward`` (``zero_grad``, the backward pass and
the gradients' reduction), in %."""

from portbench import spans as S


def read(run):
    return S.idle_share_within(run, "train.backward")
