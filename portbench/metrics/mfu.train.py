"""The whole training step: its forward, data-gradient and weight-gradient
FLOPs times the images stepped in the untraced part of the window, over
its time and the card's 989 TFLOP/s, in %."""

from portbench import readers as R
from portbench.work import deeplabv3p as WD


def read(run):
    rec = run.records
    if not rec.get("seconds") or not rec.get("images"):
        return None
    H, W = run.size
    return R.mfu(WD.train_flops(run.config, H, W), rec["images"],
                 rec["seconds"])
