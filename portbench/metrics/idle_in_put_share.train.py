"""Training loop (``train/trainer.py``): the share of the device's idle
time in the traced steps during which the calling thread's innermost
program span is ``train.put`` (the batch's pageable copy to the device),
in %."""

from portbench import spans as S


def read(run):
    return S.idle_share(run, ("train.put",))
