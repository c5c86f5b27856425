"""Ahead-of-time serving export: the image -> mask pipeline as an artifact
(deeplab_tpu/export.py).

``save_serving`` traces the serving pipeline (model forward -> argmax ->
optional dense-CRF refinement) with ``torch.export`` and packs the program,
together with the weights, into ONE ``.npz`` file; ``load_serving`` runs it
with **no model-building code**: loading needs torch, this module and the
kernel operators (``kernels/ops.py``), not the network definition, the CRF
engine or the h5 importer.  Every hand-written kernel on the path is a
``deeplab_tpu_torch::`` operator, so it is one node of the program, and the
loaded program launches it (or, on the CPU, runs its plain version).

Weights stay *inputs* of the program rather than constants, as in the JAX
module: the arrays are stored once, under the JAX artifact's keys and in its
Keras layouts (``json.dumps([prefix, layer, var])``, ``"p"`` parameters and
``"s"`` BN statistics), and ``ServingArtifact.with_params`` swaps in
same-shaped weights without a re-export.  The tensors the pipeline derives
from its geometry alone (the CRF's cross-cell blur, its spatial
normalization planes, the resize matrices) are constants of the program.

Batch handling: ``batch=None`` exports with a symbolic batch dimension, so
one artifact serves any batch size; a fixed ``batch`` pins it, and the
artifact then pads a smaller batch with copies of its last image and trims
the result, like ``Predictor``.  The CRF's XLA engine (``backend="xla"``)
refines one image at a time in Python and needs a fixed batch.

One device: the program is traced on ``device`` (the card unless the caller
passes ``"cpu"``) and runs there; the tensors it holds are bound to it.
JAX's ``platforms`` (several lowering targets in one artifact) becomes that
single device, recorded as ``meta["platforms"]`` (``["cuda"]`` or
``["cpu"]``); asking for two devices raises.  The precision policy is not
part of a traced graph, so the artifact records it and runs every call
inside its TF32 switches (``core.precision_flags``).
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Optional

import numpy as np
import torch

from deeplab_tpu_torch import core
from deeplab_tpu_torch.kernels import ops as OPS

ARTIFACT_VERSION = 1
_PROGRAM_KEY = "__program__"
_META_KEY = "__meta__"
# Keras layout -> the port's, by variable name (params.py)
_PERMS = {"kernel": (3, 2, 0, 1), "depthwise_kernel": (2, 3, 0, 1)}
_TRACE_BATCH = 2


def build_serving_fn(net, crf=None, compute_dtype="mixed",
                     n_classes: Optional[int] = None):
    """The single-device serving pipeline (the same math as ``Predictor``
    without test-time augmentation): raw 0-255 BGR (B, H, W, 3) float32 on
    the net's device -> (B, H, W) int32 label maps, CRF-refined when
    ``crf`` (a ``CrfConfig``) is given."""
    from deeplab_tpu_torch.crf import dense_crf
    n = n_classes or getattr(net, "n_classes", 21)
    policy = core.resolve_compute_dtype(compute_dtype)

    def pipeline(img):
        preds = net.predict_ids(img, policy)
        if crf is not None:
            preds = dense_crf.mean_field_batched(img, preds, crf, n)
        return preds

    return pipeline


def _weight_slots(net):
    """``[(name, key, var, tensor)]`` over the net's layers: every
    parameter (``"p"``) and BN statistic (``"s"``) with its JAX artifact
    key, in a fixed order."""
    from deeplab_tpu_torch.params import weight_key
    slots = []
    for layer, mod in net.named_children():
        for prefix, items in (("p", mod.named_parameters(recurse=False)),
                              ("s", mod.named_buffers(recurse=False))):
            for var, t in items:
                slots.append((f"{layer}.{var}",
                              weight_key(prefix, layer, var), var, t))
    return slots


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


class _Program(torch.nn.Module):
    """The traced module: ``(images, weights) -> masks``.  The net is held
    outside the module tree, so that its tensors enter the program only as
    the ``weights`` inputs."""

    def __init__(self, net, names, fn):
        super().__init__()
        self._net = (net,)
        self._names = tuple(names)
        self._fn = fn

    def forward(self, images, weights):
        tensors = dict(zip(self._names, weights))
        with torch.nn.utils.stateless._reparametrize_module(self._net[0],
                                                           tensors):
            return self._fn(images)


def _one_device(device) -> torch.device:
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(f"an artifact runs on one device, not "
                             f"{list(device)}: export once per device")
        device = device[0]
    return core.resolve_device(device)


def export_serving(net, crf=None, batch: Optional[int] = None,
                   compute_dtype="mixed", device=None,
                   n_classes: Optional[int] = None):
    """Trace the serving pipeline on ``device``; returns the
    ``torch.export.ExportedProgram``, whose inputs are ``(images,
    weights)``: images (B, H, W, 3) float32, weights the net's tensors in
    :func:`_weight_slots` order.  ``batch=None`` makes B symbolic.  The net
    is moved to ``device`` and put in eval mode, as ``Predictor`` does."""
    from torch.export import Dim
    dev = _one_device(device)
    if batch is None and crf is not None and crf.backend == "xla":
        raise ValueError("the CRF's XLA engine refines one image at a time "
                         "and cannot take a symbolic batch: export with a "
                         "fixed batch (batch=N)")
    net = net.to(dev).eval()
    fn = build_serving_fn(net, crf, compute_dtype, n_classes)
    slots = _weight_slots(net)
    weights = [t.detach() for *_, t in slots]
    h, w = net.sz
    # one eager call first: the pipeline's cached geometry (the CRF plan,
    # its normalization planes, band matrices) is built from real tensors,
    # which the trace then holds as constants
    with torch.inference_mode():
        fn(torch.zeros((1, h, w, 3), dtype=torch.float32, device=dev))
    b = _TRACE_BATCH if batch is None else int(batch)
    img = torch.zeros((b, h, w, 3), dtype=torch.float32, device=dev)
    dims = {0: Dim("batch", min=1)} if batch is None else None
    ep = torch.export.export(
        _Program(net, [s[0] for s in slots], fn), (img, weights),
        dynamic_shapes=(dims, [None] * len(weights)), strict=False)
    # the trace asserts each dtype cast's input metadata again at run time
    # (one node per cast, ~600 a forward): the inputs' dtypes and devices
    # are fixed by the artifact, so the checks only cost host time
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def op_counts(program) -> dict:
    """``{operator name: nodes}`` of the ``deeplab_tpu_torch`` operators in
    an ``ExportedProgram`` or graph module: the kernel launches one call
    of the program makes."""
    graph = getattr(program, "graph_module", program).graph
    counts: dict = {}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target).split(".")
        if name[0] == OPS.NAMESPACE:
            counts[name[1]] = counts.get(name[1], 0) + 1
    return counts


def _policy_name(compute_dtype) -> str:
    p = core.resolve_compute_dtype(compute_dtype)
    if p.mxu_bf16:
        return "mixed"
    return "float32" if p.dtype == torch.float32 else "bfloat16"


def _to_port(arr, perm, channels_last: bool, device) -> torch.Tensor:
    """A Keras-layout array as the program's input: ``perm`` to the port's
    layout, then its memory format."""
    a = np.asarray(arr, np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(perm) if perm
                                              else a))
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return t.to(device)


def save_serving(path, net, crf=None, batch: Optional[int] = None,
                 compute_dtype="mixed", device=None,
                 n_classes: Optional[int] = None):
    """Export and write a self-contained serving artifact (one ``.npz``):
    the serialized program, every weight array under the JAX artifact's
    keys in Keras layouts, and a meta record (the JAX fields, plus the
    program's weight inputs and its operator counts).  Returns the
    ``ExportedProgram``."""
    ep = export_serving(net, crf=crf, batch=batch,
                        compute_dtype=compute_dtype, device=device,
                        n_classes=n_classes)
    from deeplab_tpu_torch.params import to_keras_layout
    dev = _one_device(device)
    payload, inputs = {}, []
    for _, key, var, t in _weight_slots(net):
        payload[key] = to_keras_layout(var, t)
        perm = _PERMS.get(var)
        inputs.append([key, list(perm) if perm else None,
                       _channels_last(t)])
    meta = {
        "version": ARTIFACT_VERSION,
        "image_size": list(net.sz),
        "n_classes": n_classes or getattr(net, "n_classes", 21),
        "batch": batch,
        "compute_dtype": _policy_name(compute_dtype),
        "platforms": [dev.type],
        "crf": None if crf is None else dataclasses.asdict(crf),
        "backbone": getattr(net, "backbone", None),
        "net": getattr(net, "net", None),
        "inputs": inputs,
        "ops": op_counts(ep),
    }
    # the example inputs would store the weights a second time
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    payload[_PROGRAM_KEY] = np.frombuffer(buf.getvalue(), np.uint8)
    payload[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       np.uint8)
    out = io.BytesIO()
    np.savez(out, **payload)
    with open(path, "wb") as f:          # one write of the whole file
        f.write(out.getvalue())
    return ep


class ServingArtifact:
    """A loaded serving artifact: ``artifact(images) -> (B, H, W) int32``
    numpy masks, as ``Predictor.__call__`` gives them (a ragged batch is
    padded and trimmed when the artifact has a fixed batch).  Each call runs
    under ``torch.inference_mode`` inside the recorded policy's TF32
    switches, on the device the program was exported on."""

    def __init__(self, program, arrays, meta):
        self.program = program
        self.meta = meta
        self.sz = tuple(meta["image_size"])
        self.batch = meta.get("batch")
        self.device = torch.device(meta["platforms"][0])
        self.policy = core.resolve_compute_dtype(meta["compute_dtype"])
        self.arrays = arrays
        self.weights = [_to_port(arrays[key], perm, cl, self.device)
                        for key, perm, cl in meta["inputs"]]
        # called through ``forward``: the module's input checks (every
        # weight's shape, each call) are this class's to make, once
        self._fn = program.module(check_guards=False)

    @classmethod
    def load(cls, path):
        OPS.load_all()
        with np.load(path) as npz:
            meta = json.loads(bytes(npz[_META_KEY].tobytes()).decode())
            if meta.get("version", 0) > ARTIFACT_VERSION:
                raise ValueError(
                    f"artifact version {meta['version']} is newer than "
                    f"this loader ({ARTIFACT_VERSION})")
            program = torch.export.load(
                io.BytesIO(npz[_PROGRAM_KEY].tobytes()))
            arrays = {k: npz[k] for k in npz.files if not k.startswith("__")}
        return cls(program, arrays, meta)

    def with_params(self, params, state=None):
        """The same program with new same-shaped weights: ``params`` (and
        optionally ``state``) as ``{layer: {var: array}}`` trees in the
        Keras layouts (``params.trees_from_net``); no re-export."""
        from deeplab_tpu_torch.params import flat_keys
        new = flat_keys(params, "p")
        if state is not None:
            new.update(flat_keys(state, "s"))
        missing = [k for k, *_ in self.meta["inputs"]
                   if json.loads(k)[0] == "p" and k not in new]
        if missing:
            raise KeyError(f"params lack {len(missing)} of the artifact's "
                           f"weights, e.g. {missing[0]}")
        arrays = dict(self.arrays)
        for key in arrays:
            if key in new:
                arr = np.asarray(new[key], np.float32)
                if arr.shape != arrays[key].shape:
                    raise ValueError(f"{key}: shape {arr.shape}, the "
                                     f"artifact's {arrays[key].shape}")
                arrays[key] = arr
        return ServingArtifact(self.program, arrays, self.meta)

    def __call__(self, images) -> np.ndarray:
        img = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        b = img.shape[0]
        if img.dim() != 4 or b < 1 or tuple(img.shape[1:]) != self.sz + (3,):
            raise ValueError(f"images: want (B, {self.sz[0]}, {self.sz[1]}, "
                             f"3) with B >= 1, got {tuple(img.shape)}")
        if self.batch is not None:
            if b > self.batch:
                raise ValueError(f"batch {b} exceeds the artifact's fixed "
                                 f"batch {self.batch}")
            if b < self.batch:
                img = torch.cat([img, img[-1:].expand(
                    (self.batch - b,) + tuple(img.shape[1:]))])
        with torch.inference_mode(), core.precision_flags(self.policy):
            out = self._fn.forward(img, self.weights)
        return out[:b].cpu().numpy()


def load_serving(path) -> ServingArtifact:
    return ServingArtifact.load(path)
