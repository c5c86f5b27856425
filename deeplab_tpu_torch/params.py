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
loader reads it as that layer's ``depthwise_kernel``.  The Keras-3
``.weights.h5`` layout (``layers/.../vars/0..N``, the layer's name an
attribute of ``vars``) is read positionally, as the JAX loader reads it.
``trees_from_net`` is the way back: the net's parameters and buffers (or
its gradients) as Keras-layout trees.

Weights out: ``save_keras_h5`` writes a Keras-2 h5 (needs ``h5py``);
``save_npz``/``load_npz`` a numpy-only ``.npz`` whose keys are those of the
serving artifact (``flat_keys``: the JSON of ``[p|s, layer, var]``) and whose
arrays are in the Keras layouts, which a machine without ``h5py`` can write.
``load_weights`` reads either, by suffix.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

_VAR_ORDER = ("kernel", "depthwise_kernel", "bias", "gamma", "beta",
              "moving_mean", "moving_variance")


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


def _is_keras3_layout(f) -> bool:
    return ("layers" in f and "layer_names" not in f.attrs
            and "model_weights" not in f)


def _keras3_layers(f):
    """``(layer name, [arrays in save order])`` of a Keras-3 file: every
    ``vars`` group that carries a ``name`` attribute (JAX
    ``_iter_keras3_layers``)."""
    import h5py
    out = []

    def walk(group):
        for key in group:
            item = group[key]
            if not isinstance(item, h5py.Group):
                continue
            if key == "vars":
                name = item.attrs.get("name", "")
                if isinstance(name, bytes):
                    name = name.decode()
                arrays = [np.asarray(item[k])
                          for k in sorted(item, key=int)]
                if arrays and name:
                    out.append((name, arrays))
            else:
                walk(item)
    walk(f)
    return out


def _keras3_names(mod):
    """Keras-3 save order of a layer's weights, from the layer's kind: BN
    (gamma, beta, moving_mean, moving_variance), depthwise
    (depthwise_kernel, bias), conv (kernel, bias)."""
    for first, names in (("gamma", ("gamma", "beta", "moving_mean",
                                    "moving_variance")),
                         ("depthwise_kernel", ("depthwise_kernel", "bias")),
                         ("kernel", ("kernel", "bias"))):
        if isinstance(getattr(mod, first, None), torch.Tensor):
            return names
    return ()


def _keras3_tree(f, net) -> dict:
    """The Keras-3 file's weights of the layers ``net`` has, by name; a
    variable the layer lacks (a conv's bias where it has none) is skipped,
    as the JAX loader skips it."""
    tree = {}
    for lname, arrays in _keras3_layers(f):
        layer = _canonical_layer(lname, net)
        mod = getattr(net, layer, None)
        if not isinstance(mod, torch.nn.Module):
            continue
        tree[layer] = {n: a for n, a in zip(_keras3_names(mod), arrays)
                       if isinstance(getattr(mod, n, None), torch.Tensor)}
    return tree


def load_keras_h5(path: str, net):
    """Load a Keras weights file into ``net`` by layer name, like Keras
    ``load_weights(by_name=True)``: file layers the model lacks are
    skipped.  Both the legacy Keras-2 layout and the Keras-3
    ``.weights.h5`` layout are detected.  Returns ``net``."""
    import h5py
    tree = {}
    with h5py.File(path, "r") as f:
        if _is_keras3_layout(f):
            tree = _keras3_tree(f, net)
            if _assign(net, (tree,), strict=False) == 0:
                raise ValueError(f"no weights matched the model in {path}")
            return net
        g = f["model_weights"] if "model_weights" in f else f
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


def save_keras_h5(path: str, net) -> None:
    """Write ``net``'s weights as a Keras-2 h5 (JAX ``save_keras_h5``): one
    group per layer with its ``weight_names``, the arrays in the Keras
    layouts, readable by the reference's ``load_weights``, by the JAX
    ``load_keras_h5`` and by :func:`load_keras_h5`."""
    import h5py
    params, state = trees_from_net(net)
    layer_names = sorted(set(params) | set(state))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in layer_names])
        # the arrays are in the Keras (TensorFlow) layouts
        f.attrs["backend"] = b"tensorflow"
        for lname in layer_names:
            grp = f.create_group(lname)
            merged = {**params.get(lname, {}), **state.get(lname, {})}
            names = []
            for var in sorted(merged, key=lambda v: _VAR_ORDER.index(v)
                              if v in _VAR_ORDER else len(_VAR_ORDER)):
                full = f"{lname}/{var}:0"
                grp.create_dataset(full, data=merged[var])
                names.append(full.encode())
            grp.attrs["weight_names"] = np.array(names)


def weight_key(prefix: str, layer: str, var: str) -> str:
    """The npz key of one weight: the JSON of ``[prefix, layer, var]``,
    ``"p"`` for a parameter, ``"s"`` for a BN statistic (the JAX serving
    artifact's key)."""
    return json.dumps([prefix, layer, var])


def flat_keys(tree, prefix: str) -> dict:
    """``{layer: {var: array}}`` -> ``{npz key: array}`` under
    :func:`weight_key` (JAX ``export._flat_keys``)."""
    return {weight_key(prefix, layer, var): arr
            for layer, vars_ in tree.items() for var, arr in vars_.items()}


def unflatten(arrays):
    """The inverse of :func:`flat_keys` over a mapping of npz keys (keys
    starting ``__`` are skipped): ``(params, state)`` trees."""
    params, state = {}, {}
    for key in arrays:
        if key.startswith("__"):
            continue
        prefix, layer, var = json.loads(key)
        (params if prefix == "p" else state).setdefault(layer, {})[var] = \
            arrays[key]
    return params, state


def atomic_savez(path: str, arrays: dict) -> None:
    """``np.savez`` of ``arrays`` to ``path``: written beside it as
    ``path + ".tmp"`` and moved into place, so that a reader never sees a
    half-written file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def save_npz(path: str, net) -> None:
    """Write ``net``'s weights as one numpy-only ``.npz`` (no ``h5py``):
    every parameter and BN statistic in the Keras layout under the serving
    artifact's key, :func:`flat_keys`."""
    params, state = trees_from_net(net)
    arrays = flat_keys(params, "p")
    arrays.update(flat_keys(state, "s"))
    atomic_savez(path, arrays)


def load_npz(path: str, net, strict: bool = True):
    """Load a :func:`save_npz` file into ``net``.  ``strict`` demands that
    the file and the net hold the same layers and variables; otherwise the
    file's layers the net lacks are skipped, as :func:`load_keras_h5` skips
    them.  Returns ``net``."""
    with np.load(path, allow_pickle=False) as npz:
        params, state = unflatten({k: npz[k] for k in npz.files})
    if _assign(net, (params, state), strict=strict) == 0:
        raise ValueError(f"no weights matched the model in {path}")
    return net


def load_weights(path: str, net):
    """Load a weight file by its suffix: ``.npz`` through :func:`load_npz`
    (by name), anything else as Keras h5 through :func:`load_keras_h5`.
    Returns ``net``."""
    if path.endswith(".npz"):
        return load_npz(path, net, strict=False)
    return load_keras_h5(path, net)


def h5_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def weights_suffix() -> str:
    """``".h5"`` where ``h5py`` imports, else ``".npz"``: the weight file a
    training run on this machine can write."""
    return ".h5" if h5_available() else ".npz"


PASCAL_VOC_FILES = {
    "xception": "deeplabv3_xception_tf_dim_ordering_tf_kernels.h5",
    "mobilenetv2": "deeplabv3_mobilenetv2_tf_dim_ordering_tf_kernels.h5"}


def load_pretrained_pascal_voc(net, backbone: str):
    """The reference's release weights for ``backbone`` (reference
    deeplabv3p.py:456-465, JAX ``load_pretrained_pascal_voc``), loaded into
    ``net`` by layer name from a local file: ``$DEEPLAB_TPU_WEIGHTS_DIR``,
    then ``weights/``, then ``~/.keras/models``.  Nothing is downloaded; a
    missing file raises ``FileNotFoundError``.  Returns ``net``."""
    fname = PASCAL_VOC_FILES["xception" if backbone == "xception"
                             else "mobilenetv2"]
    for root in (os.environ.get("DEEPLAB_TPU_WEIGHTS_DIR", ""), "weights",
                 os.path.expanduser("~/.keras/models")):
        if root and os.path.exists(os.path.join(root, fname)):
            return load_keras_h5(os.path.join(root, fname), net)
    raise FileNotFoundError(
        f"pretrained weights {fname} not found locally; nothing is "
        "downloaded. Place the file in ./weights or set "
        "DEEPLAB_TPU_WEIGHTS_DIR.")
