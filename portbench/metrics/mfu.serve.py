"""The whole served call: the configuration's model FLOPs (and the CRF's
operations, where it runs) times the images served in the untraced part
of the window, over its time and the card's 989 TFLOP/s, in %."""

from portbench import readers as R


def read(run):
    rec = run.records
    if not rec.get("seconds") or not rec.get("images"):
        return None
    return R.mfu(R.serve_flops_per_image(run), rec["images"],
                 rec["seconds"])
