"""The serving kernels as ``torch.library`` operators, namespace
``deeplab_tpu_torch``.

Each kernel module registers its launches here when it is imported: a
schema, the CUDA implementation (the ctypes launch, which launches the
hand-written kernel or raises), the CPU implementation (the plain version)
and a fake one that computes only the output's shape and dtype.  The
dispatcher then picks the implementation by the device of the tensors, and
``torch.export`` records each launch as one ``deeplab_tpu_torch::<name>``
node of the graph, with a batch that may be symbolic.

An eager call skips the dispatcher: the :class:`Operator` that
:func:`define` returns calls the implementation the dispatcher would pick
(by the first tensor's device) directly, unless a graph is being traced.
The dispatcher's round trip into Python costs about 13 µs a call on a CPU
core; on an H100 host it cost the host-bound model-only forward 7% (15
launches a forward; ``PERF.md`` §6).

This module imports torch only, so a process that loads a saved serving
program (``deeplab_tpu_torch.export``) can register the operators without
the model or CRF code.
"""

from __future__ import annotations

import torch

NAMESPACE = "deeplab_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


class Operator:
    """A registered operator, called with its schema's arguments in order.
    While a graph is traced (the first argument is a fake tensor, or
    ``torch.compile`` is tracing) the call goes through
    ``torch.ops.deeplab_tpu_torch.<name>`` and becomes a node of the graph;
    eagerly it runs the CUDA or CPU implementation for the first
    argument's device."""

    def __init__(self, op, cuda, cpu):
        self.op, self.cuda, self.cpu = op, cuda, cpu

    def __call__(self, x, *args):
        if type(x) is not torch.Tensor or torch.compiler.is_compiling():
            return self.op(x, *args)
        return (self.cuda if x.is_cuda else self.cpu)(x, *args)


def define(schema: str, *, cuda, cpu, fake) -> Operator:
    """Register operator ``schema`` (``name(args) -> returns``) with its
    three implementations."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return Operator(getattr(getattr(torch.ops, NAMESPACE), name), cuda, cpu)


def load_all():
    """Import every kernel module, which registers its operators: what a
    saved program needs before it is deserialized."""
    from deeplab_tpu_torch.kernels import crf_fused, fused_dw, fused_mbconv
    return crf_fused, fused_dw, fused_mbconv
