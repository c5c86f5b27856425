"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit).  Every roofline bound of the benchmark takes the
larger of two times: its operations at the highest dense rate (bf16
tensor cores, also for work the card does in float32), or each input byte
read once and each output byte written once at the memory rate; so a
bound is never above the true least time."""

PEAK_FLOP_S = 989e12      # bf16 / fp16 tensor cores, dense
HBM_BYTES_S = 3.35e12     # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """Least time of work ``flops`` moving ``nbytes``."""
    return max(flops / PEAK_FLOP_S, nbytes / HBM_BYTES_S)
