"""Device: 1 - the union of device op intervals over the traced window,
in %, while serving."""

from portbench import readers as R


def read(run):
    return R.idle_share(run)
