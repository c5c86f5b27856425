"""``deeplab_tpu_torch.train.Trainer.fit`` on tiny in-memory arrays, on the
CPU: the loss falls, the history keys are the JAX Trainer's, two runs from
the same seed are identical, frozen layers do not move, the callbacks act,
the constructor's argument checks raise, and ``spatial=True`` without a
mesh is the plain fit.

The task: 32x32 images of a colored disc on a flat background, labels disc /
background (2 classes; 2 = void, on the top row), so a few steps learn it.
"""

import numpy as np
import pytest
import torch

from deeplab_tpu_torch.data.generator import ArrayBatcher, Prefetcher
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.train import (EarlyStopping, JSONLLogger,
                                     ReduceLROnPlateau, Trainer)

SZ, N_CLS = 32, 2


def _data(n=4, seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SZ, :SZ]
    X = np.zeros((n, SZ, SZ, 3), np.float32)
    Y = np.zeros((n, SZ, SZ), np.int32)
    for i in range(n):
        cy, cx = r.randint(10, 22, 2)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < 36
        X[i] = r.randint(0, 80, 3)
        X[i][disc] = r.randint(150, 255, 3)
        Y[i][disc] = 1
        Y[i][0, :] = N_CLS                      # a void row
    return X, Y.reshape(n, SZ * SZ)


def _fit(epochs=3, callbacks=(), seed=0, workers=0, **kw):
    X, Y = _data()
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35, seed=seed)
    tr = Trainer(net, epochs=epochs, callbacks=callbacks,
                 device="cpu", workers=workers, verbose=0, **kw)
    hist = tr.fit(net, ArrayBatcher(X, Y, 2, n_classes=N_CLS),
                  ArrayBatcher(X[:2], Y[:2], 2, n_classes=N_CLS))
    return net, tr, hist


def test_fit_learns_with_the_jax_history_keys():
    net, tr, hist = _fit(epochs=4, workers=1)
    assert set(hist) == {"loss", "Jaccard", "sparse_accuracy", "val_loss",
                         "val_Jaccard", "val_sparse_accuracy"}
    assert all(len(v) == 4 for v in hist.values())
    assert hist["loss"][-1] < hist["loss"][0]
    assert all(np.isfinite(v).all() for v in hist.values())
    assert tr.opt.count == 8                  # 2 batches x 4 epochs


def test_fit_is_deterministic():
    a, _, ha = _fit(epochs=2)
    b, _, hb = _fit(epochs=2)
    assert ha == hb
    for (k, u), (_, v) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(u, v), k


def test_frozen_layers_do_not_move():
    X, Y = _data()
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tr = Trainer(net, epochs=1, freeze_before="concat_projection",
                 device="cpu", workers=0, verbose=0)
    tr.fit(net, ArrayBatcher(X, Y, 2, n_classes=N_CLS))
    frozen = tr.frozen
    assert "Conv" in frozen and "aspp0_BN" in frozen
    assert "concat_projection" not in frozen
    for k, v in net.state_dict().items():
        layer = k.split(".")[0]
        if layer in frozen:
            assert torch.equal(v, before[k]), k
    moved = [k for k in net.state_dict()
             if k.split(".")[0] not in frozen
             and not torch.equal(net.state_dict()[k], before[k])]
    assert "concat_projection.kernel" in moved
    assert "concat_projection_BN.moving_mean" in moved


def test_reduce_lr_on_plateau_and_early_stopping_act(tmp_path):
    # "max" on the falling training loss never improves after epoch 0
    plateau = ReduceLROnPlateau(monitor="loss", mode="max", patience=1,
                                factor=0.5)
    stop = EarlyStopping(monitor="loss", mode="max", patience=2)
    log = JSONLLogger(str(tmp_path / "log.jsonl"))
    _, tr, hist = _fit(epochs=6, callbacks=[plateau, stop, log])
    assert len(hist["loss"]) == 3             # stopped after epoch 3
    assert tr.lr_scale == 0.25                # halved after epochs 2 and 3
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == 3 and '"lr"' in lines[0]


def test_prefetcher_yields_the_batches_in_order():
    X, Y = _data(6)
    gen = ArrayBatcher(X, Y, 2, n_classes=N_CLS)
    got = list(Prefetcher(gen))
    assert len(got) == 3
    for i, (x, y, sw) in enumerate(got):
        np.testing.assert_array_equal(x, X[2 * i:2 * i + 2])
        assert sw["pred_mask"].shape == (2, SZ * SZ)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(spatial=True),
                                dict(ddp=True, spatial=True)])
def test_later_slices_raise(kw):
    """A mesh must be a ``parallel.mesh.Mesh``; ``ddp`` with ``spatial``
    raises JAX's ValueError.  ``spatial=True`` without a mesh has no space
    axis to shard over: it is the plain fit, as in JAX (its history and
    weights equal the plain fit's bit for bit)."""
    if kw == dict(spatial=True):
        net, tr, hist = _fit(epochs=2, spatial=True)
        plain, _, want = _fit(epochs=2)
        assert not tr.spatial and hist == want
        for a, b in zip(net.state_dict().values(),
                        plain.state_dict().values()):
            assert torch.equal(a, b)
        return
    err, match = ((TypeError, "Mesh") if "mesh" in kw else
                  (ValueError, "ddp"))
    with pytest.raises(err, match=match):
        Trainer(SegNet((SZ, SZ), N_CLS, alpha=0.35), device="cpu", **kw)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(SegNet((SZ, SZ), N_CLS, alpha=0.35))
