"""Weights into the port's modules (deeplab_tpu/params.py).

Both sources are ``{layer: {var: array}}`` trees keyed by Keras layer and
variable names, which are the port's submodule and attribute names; loading
is a walk over names that converts two layouts on the way:

- ``kernel``: Keras HWIO -> OIHW;
- ``depthwise_kernel``: Keras (kh, kw, C, 1) -> (C, 1, kh, kw).

``moving_mean`` and ``moving_variance`` land in BN buffers, the rest in
parameters.  The Keras Subpixel layer is auto-named (``subpixel_1`` in the
shipped ``weights/mobilenetv2_subpixel.h5``): a file layer named
``subpixel*`` loads onto the ``subpixel`` layer, whose kernel already has
the phase shift's channel order.  Keras 3's legacy-h5 writer stores a
depthwise layer's kernel as ``<layer>/kernel`` (the same file): the h5
loader reads it as that layer's ``depthwise_kernel``.  ``trees_from_net`` is the way back: the
net's parameters and buffers (or its gradients) as Keras-layout trees.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_port_layout(var: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if var == "kernel":
        return t.permute(3, 2, 0, 1)
    if var == "depthwise_kernel":
        return t.permute(2, 3, 0, 1)
    return t


def to_keras_layout(var: str, t: torch.Tensor) -> np.ndarray:
    """The inverse of ``_to_port_layout``: a float32 numpy array in the
    Keras layout."""
    t = t.detach().float().cpu()
    if var == "kernel":
        t = t.permute(2, 3, 1, 0)
    elif var == "depthwise_kernel":
        t = t.permute(2, 3, 0, 1)
    return np.ascontiguousarray(t.numpy())


def trees_from_net(net):
    """``(params, state)`` of ``net`` as ``{layer: {var: ndarray}}`` trees
    in the Keras layouts (the JAX package's trees)."""
    params, state = {}, {}
    for layer, mod in net.named_children():
        for var, p in mod.named_parameters(recurse=False):
            params.setdefault(layer, {})[var] = to_keras_layout(var, p)
        for var, b in mod.named_buffers(recurse=False):
            state.setdefault(layer, {})[var] = to_keras_layout(var, b)
    return params, state


def _assign(net, trees, strict: bool) -> int:
    """Copy every ``(layer, var, array)`` of ``trees`` into ``net``; returns
    the count.  ``strict`` also demands that the trees cover every parameter
    and buffer of ``net``."""
    n = 0
    seen = set()
    with torch.no_grad():
        for tree in trees:
            for layer, vars_ in tree.items():
                mod = getattr(net, layer, None)
                if not isinstance(mod, torch.nn.Module):
                    if strict:
                        raise KeyError(f"layer {layer!r} not in the model")
                    continue
                for var, arr in vars_.items():
                    slot = getattr(mod, var, None)
                    if not isinstance(slot, torch.Tensor):
                        if strict:
                            raise KeyError(f"{layer}/{var} not in the model")
                        continue
                    val = _to_port_layout(var, np.asarray(arr))
                    if tuple(val.shape) != tuple(slot.shape):
                        raise ValueError(
                            f"shape mismatch {layer}/{var}: model "
                            f"{tuple(slot.shape)} vs {tuple(val.shape)}")
                    slot.copy_(val)
                    seen.add(f"{layer}.{var}")
                    n += 1
    if strict:
        missing = ({k for k, _ in net.named_parameters()}
                   | {k for k, _ in net.named_buffers()}) - seen
        if missing:
            raise KeyError(f"not covered by the trees: {sorted(missing)[:5]}")
    return n


def params_from_jax(net, params, state):
    """Load the JAX package's ``(params, state)`` trees (numpy or array-like
    leaves) into ``net``; the trees must cover ``net`` exactly.  Returns
    ``net``."""
    _assign(net, (params, state), strict=True)
    return net


def _attr_list(g, name):
    """A Keras list attribute, including the legacy chunked form
    (``name0``, ``name1``, ... when the list exceeds HDF5's 64 KB limit)."""
    if name in g.attrs:
        vals = g.attrs[name]
    else:
        vals, k = [], 0
        while f"{name}{k}" in g.attrs:
            vals.extend(g.attrs[f"{name}{k}"])
            k += 1
    return [n.decode() if isinstance(n, bytes) else n for n in vals]


def _strip(name: str) -> str:
    name = name.split("/")[-1]
    return name[:-2] if name.endswith(":0") else name


def _canonical_layer(lname: str, net) -> str:
    children = dict(net.named_children())
    if (lname not in children and lname.startswith("subpixel")
            and "subpixel" in children):
        return "subpixel"
    return lname


def _depthwise_names(out: dict, mod) -> dict:
    """A depthwise layer's ``kernel`` in the file is its
    ``depthwise_kernel``."""
    if ("kernel" in out and "depthwise_kernel" not in out
            and isinstance(getattr(mod, "depthwise_kernel", None),
                           torch.Tensor)):
        out = dict(out)
        out["depthwise_kernel"] = out.pop("kernel")
    return out


def load_keras_h5(path: str, net):
    """Load a legacy Keras-2 weights file into ``net`` by layer name, like
    Keras ``load_weights(by_name=True)``: file layers the model lacks are
    skipped.  Returns ``net``.  The Keras-3
    ``.weights.h5`` layout is not ported."""
    import h5py
    tree = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        if "layers" in g and "layer_names" not in g.attrs:
            raise NotImplementedError(f"{path}: Keras-3 layout is not ported")
        for lname in _attr_list(g, "layer_names") or list(g.keys()):
            if lname not in g:
                continue
            grp = g[lname]
            out = {}
            names = _attr_list(grp, "weight_names")
            if names:
                for wn in names:
                    ds = grp[wn] if wn in grp else grp[wn.split("/", 1)[-1]]
                    out[_strip(wn)] = np.asarray(ds)
            else:
                grp.visititems(lambda name, obj: out.__setitem__(
                    _strip(name), np.asarray(obj))
                    if hasattr(obj, "shape") else None)
            if out:
                layer = _canonical_layer(lname, net)
                tree[layer] = _depthwise_names(out, getattr(net, layer, None))
    if _assign(net, (tree,), strict=False) == 0:
        raise ValueError(f"no weights matched the model in {path}")
    return net
