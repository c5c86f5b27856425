"""The whole training step (``train/trainer.py``,
``train/optimizer.py``): the share of the device's idle time in the traced
steps during which the calling thread's innermost program span is
``optimizer`` (the update's launches), in %."""

from portbench import spans as S


def read(run):
    return S.idle_share(run, ("optimizer",))
