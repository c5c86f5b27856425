"""The whole training step (``train/trainer.py``): the share of the
device's idle time in the traced steps during which the calling thread is
inside the span ``train.forward`` (the forward's launches, its block
labels included), in %."""

from portbench import spans as S


def read(run):
    return S.idle_share_within(run, "train.forward")
