"""Compute policies and device resolution (counterpart of deeplab_tpu/core.py).

Three policies, as in the JAX package (``core.resolve_compute_dtype``):

- ``float32``: exact parity.  TF32 is switched off for both cuBLAS matmuls and
  cuDNN convolutions (cuDNN convs default to TF32 on Ampere and later).
- ``"mixed"``: float32 activations; every conv rounds its two operands to
  bfloat16 and runs in float32 (f32 accumulation, f32 output) — the twin of
  XLA's single bf16 MXU pass.  Because bf16 values are exact in TF32 (8 of its
  10 mantissa bits) and a TF32 tensor-core product of two such values is
  exact in f32, cuDNN may run these convs in TF32 without changing a bit of
  the operands; matmuls (the f32 resize) stay full f32.
- ``bfloat16``: bf16 activations, bf16 conv operands and outputs.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    dtype: torch.dtype      # activation dtype
    mxu_bf16: bool = False  # "mixed": bf16 conv operands, f32 activations


_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(compute_dtype) -> Policy:
    """``"mixed"``, ``"float32"``/``torch.float32`` or
    ``"bfloat16"``/``torch.bfloat16`` -> :class:`Policy`."""
    if isinstance(compute_dtype, Policy):
        return compute_dtype
    if compute_dtype == "mixed":
        return Policy(torch.float32, True)
    dt = _NAMES.get(compute_dtype, compute_dtype)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unknown compute policy {compute_dtype!r}")
    return Policy(dt, False)


@contextlib.contextmanager
def precision_flags(policy: Policy):
    """Set the TF32 switches for ``policy`` for the duration of a forward and
    restore the caller's afterwards (see the module docstring)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = policy.mxu_bf16
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises:
    an entry point never carries on on the CPU unless the caller asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
