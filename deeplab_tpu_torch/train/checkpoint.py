"""Whole train-state checkpoints (deeplab_tpu/train/checkpoint.py).

One ``.npz`` holds everything a resumed fit needs to continue as if it had
never stopped: the net's parameters and BN buffers, the Adam state of every
trainable parameter (``exp_avg``, ``exp_avg_sq``, ``step``), the Keras decay
schedule's step count (``KerasAdam.count``) and the dropout generator's
state, with ``__meta__`` (step, ``lr_scale``, the caller's ``extra``).  The
JAX package folds the step into its dropout key, so a resumed run draws the
masks an uninterrupted one draws; the port draws from one
``torch.Generator``, whose state rides along instead.  Arrays are stored in
the port's own layouts under the net's parameter names (``params::Conv.kernel``,
``opt::Conv.kernel::exp_avg``): a checkpoint is for resuming this package,
while ``params.save_npz``/``save_keras_h5`` write weights for others.  The
file is written beside its path and moved into place (``params.atomic_savez``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deeplab_tpu_torch.params import atomic_savez

_RNG_KEY = "rng::dropout"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_train_state(path: str, net, opt, step: int, lr_scale: float,
                     extra: Optional[Dict[str, Any]] = None,
                     generator: Optional[torch.Generator] = None) -> None:
    """Write ``net``, the ``KerasAdam`` ``opt`` over its trainable
    parameters, ``generator``'s state and the meta record to ``path``."""
    arrays = {f"params::{n}": _np(p) for n, p in net.named_parameters()}
    arrays.update({f"state::{n}": _np(b) for n, b in net.named_buffers()})
    names = {id(p): n for n, p in net.named_parameters()}
    for p, st in opt.opt.state.items():
        for k, v in st.items():
            arrays[f"opt::{names[id(p)]}::{k}"] = _np(torch.as_tensor(v))
    if generator is not None:
        arrays[_RNG_KEY] = _np(generator.get_state())
    meta = {"step": int(step), "lr_scale": float(lr_scale),
            "count": int(opt.count), "extra": extra or {}}
    arrays["__meta__"] = np.asarray(json.dumps(meta))
    atomic_savez(path, arrays)


def _restore(data, key: str, slot: torch.Tensor) -> None:
    if key not in data.files:
        raise KeyError(f"checkpoint lacks {key}")
    arr = data[key]
    if tuple(arr.shape) != tuple(slot.shape):
        raise ValueError(f"checkpoint shape mismatch at {key}: "
                         f"{tuple(arr.shape)} vs {tuple(slot.shape)}")
    with torch.no_grad():
        slot.copy_(torch.from_numpy(arr))


def restore_train_state(path: str, net, opt,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[int, float, Dict[str, Any]]:
    """Restore a :func:`save_train_state` file onto ``net``, ``opt`` and
    ``generator`` in place; returns ``(step, lr_scale, extra)``.  Every
    parameter and buffer of ``net`` must be in the file at its shape: a
    missing key or another shape raises and names the key."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for n, p in net.named_parameters():
            _restore(data, f"params::{n}", p)
        for n, b in net.named_buffers():
            _restore(data, f"state::{n}", b)
        names = {id(p): n for n, p in net.named_parameters()}
        params = [p for g in opt.opt.param_groups for p in g["params"]]
        saved_opt = {k for k in data.files if k.startswith("opt::")}
        state = {}
        for i, p in enumerate(params):
            prefix = f"opt::{names[id(p)]}::"
            keys = sorted(k for k in saved_opt if k.startswith(prefix))
            saved_opt.difference_update(keys)
            if not keys:
                if opt.opt.state.get(p) or meta["count"]:
                    raise KeyError(f"checkpoint lacks the optimizer state "
                                   f"of {names[id(p)]}")
                continue
            entry = {}
            for k in keys:
                arr = data[k]
                want = (() if k.endswith("::step") else tuple(p.shape))
                if tuple(arr.shape) != want:
                    raise ValueError(f"checkpoint shape mismatch at {k}: "
                                     f"{tuple(arr.shape)} vs {want}")
                entry[k[len(prefix):]] = torch.from_numpy(arr)
            state[i] = entry
        if saved_opt:
            raise KeyError(f"checkpoint holds optimizer state for parameters "
                           f"the optimizer does not train, e.g. "
                           f"{sorted(saved_opt)[0]}")
        sd = opt.opt.state_dict()
        sd["state"] = state
        # casts the moments to each parameter's device; ``step`` stays as
        # saved (a CPU scalar, where torch.optim.Adam keeps it)
        opt.opt.load_state_dict(sd)
        opt.count = meta["count"]
        if generator is not None and _RNG_KEY in data.files:
            generator.set_state(torch.from_numpy(data[_RNG_KEY]))
    return meta["step"], meta["lr_scale"], meta["extra"]
