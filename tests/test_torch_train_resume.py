"""Train-state checkpoints and resume (deeplab_tpu_torch/train/checkpoint.py,
``Trainer.fit(state_checkpoint=, resume_from=)``) and the callbacks that
ride them, on the CPU.

- The state round trip restores parameters, BN buffers, the Adam moments
  and step, the decay schedule's count and the dropout generator; a net of
  another shape raises and names the key.
- A float32 fit of 2 epochs equals 1 epoch, a save and a 1-epoch resume bit
  for bit, with dropout on: every later draw comes from the restored
  generator, every update from the restored optimizer.
- The port's resumed fit against the JAX package's resumed fit on the same
  weights, batches and dropout mask (a fixed mask on both sides: the two
  draw from different generators), 2 epochs of 2 steps, interrupted after
  the first.  Each epoch's loss within 1e-4 relative (measured: 3e-6).  The
  fit is the reference's fine-tuning (notebook cell 5): the trained
  3-class weights (``tests/data/mini_voc_trained.npz`` into the port, the
  h5 into JAX), the mini_voc tiles at 64x64, the trunk frozen before
  ``concat_projection``.  A whole network's f32 trajectory is not a
  yardstick past its first step: Adam's first update is ``lr * sign(g)``
  for every parameter, also where ``g`` is rounding noise (zero in exact
  arithmetic, e.g. a beta before another BN), so the two frameworks part
  at once (measured, ROADMAP C5: 5.8e-5, 5e-4, 2.6e-3 relative after 1, 2
  and 3 steps from the trained weights; 1-2% after one step from seeded
  ones), while one step agrees to 1e-5 (tests/test_torch_train_step.py).
- Callback state across a resume (JAX tests/test_trainer.py:259);
  ``ModelCheckpoint`` best-only, unconditional, and an h5 path without
  ``h5py`` refused at construction.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu.data.generator import ArrayBatcher as JArrayBatcher
from deeplab_tpu.models import deeplabv3p as JD
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.params import load_keras_h5 as jload_h5
from deeplab_tpu.parallel.mesh import get_mesh
from deeplab_tpu.train.trainer import Trainer as JTrainer

from deeplab_tpu_torch.data.generator import (ArrayBatcher, _imread_bgr,
                                              _imread_gray)
from deeplab_tpu_torch.models import deeplabv3p as D
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_npz
from deeplab_tpu_torch.train import (EarlyStopping, ModelCheckpoint,
                                     ReduceLROnPlateau, Trainer,
                                     restore_train_state, save_train_state)

SZ, N_CLS = 32, 2
DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
NPZ = os.path.join(DATA, "mini_voc_trained.npz")
JAX_LOSS_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small steps: the suite's test workers
    share the cores, and torch's thread pools oversubscribed spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=4, seed=0):
    """32x32 discs on a flat background, a void row (tests/
    test_torch_train_fit.py's task)."""
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
        Y[i][0, :] = N_CLS
    return X, Y.reshape(n, SZ * SZ)


def _gens(batcher=ArrayBatcher):
    X, Y = _data()
    return (batcher(X, Y, 2, n_classes=N_CLS),
            batcher(X[:2], Y[:2], 2, n_classes=N_CLS))


def _callbacks(tmp_path):
    return [ModelCheckpoint(str(tmp_path / "best.npz")),
            ReduceLROnPlateau(monitor="loss", mode="max", patience=3),
            EarlyStopping(patience=5)]


def _fit(epochs, tmp_path=None, seed=0, **fit_kw):
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35, seed=seed)
    tr = Trainer(net, epochs=epochs, device="cpu", workers=0, verbose=0,
                 callbacks=_callbacks(tmp_path) if tmp_path else ())
    hist = tr.fit(net, *_gens(), **fit_kw)
    return net, tr, hist


def test_state_round_trip_and_shape_mismatch(tmp_path):
    net, tr, _ = _fit(1)
    path = str(tmp_path / "state.npz")
    save_train_state(path, net, tr.opt, 7, 0.5, extra={"epoch": 1},
                     generator=tr.gen)
    assert not os.path.exists(path + ".tmp")

    other = SegNet((SZ, SZ), N_CLS, alpha=0.35, seed=3)
    t2 = Trainer(other, device="cpu", workers=0, verbose=0, seed=9)
    t2.setup(other)
    step, scale, extra = restore_train_state(path, other, t2.opt, t2.gen)
    assert (step, scale, extra) == (7, 0.5, {"epoch": 1})
    assert t2.opt.count == tr.opt.count == 2
    for (k, u), v in zip(net.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(u, v), k
    assert torch.equal(t2.gen.get_state(), tr.gen.get_state())
    by_name = {id(p): n for n, p in other.named_parameters()}
    want = {n: tr.opt.opt.state[p] for n, p in net.named_parameters()}
    assert len(t2.opt.opt.state) == len(want)
    for p, st in t2.opt.opt.state.items():
        for k, v in st.items():
            assert torch.equal(v, want[by_name[id(p)]][k]), (k,
                                                             by_name[id(p)])

    wide = SegNet((SZ, SZ), 3, alpha=0.35)
    t3 = Trainer(wide, device="cpu", workers=0, verbose=0)
    t3.setup(wide)
    with pytest.raises(ValueError, match="conv_upsample"):
        restore_train_state(path, wide, t3.opt, t3.gen)


def test_resumed_f32_fit_equals_uninterrupted_bit_for_bit(tmp_path):
    whole, tw, hw = _fit(2, tmp_path / "a")
    ckpt = str(tmp_path / "state.npz")
    _, _, h1 = _fit(1, tmp_path / "b", state_checkpoint=ckpt)
    # another seed: every tensor must come from the checkpoint
    resumed, tr, h2 = _fit(2, tmp_path / "b", seed=4, state_checkpoint=ckpt,
                           resume_from=ckpt)
    assert h1["loss"] == hw["loss"][:1]
    for k in hw:
        assert h2[k] == hw[k][1:], k
    for (k, u), v in zip(whole.state_dict().items(),
                         resumed.state_dict().values()):
        assert torch.equal(u, v), k
    assert (tr.opt.count, tr.step, tr.lr_scale) == (4, 4, tw.lr_scale)
    assert torch.equal(tr.gen.get_state(), tw.gen.get_state())
    # dropout draws moved the generator: the check covers them
    assert not torch.equal(tw.gen.get_state(),
                           torch.Generator().manual_seed(0).get_state())


def _tiles(sz=64, n=4, n_cls=3):
    d = os.path.join(DATA, "mini_voc")
    names = sorted(os.listdir(os.path.join(d, "JPEGImages", "train")))[:n]
    X = np.stack([_imread_bgr(os.path.join(d, "JPEGImages", "train", f))
                  [:sz, :sz] for f in names]).astype(np.float32)
    Y = np.stack([_imread_gray(os.path.join(
        d, "SegmentationClassAug", os.path.splitext(f)[0] + ".png"))
        [:sz, :sz] for f in names]).astype(np.int32).reshape(n, sz * sz)
    Y[Y > n_cls] = n_cls
    return X, Y


def test_resumed_fit_matches_jax_resumed_fit(tmp_path, monkeypatch):
    sz, B, n_cls = 64, 2, 3
    mask = np.random.RandomState(1).rand(B, sz // 8, sz // 8, 256) < 0.9
    monkeypatch.setattr(JD, "dropout", lambda ctx, x, rate: jnp.where(
        jnp.asarray(mask), x / 0.9, 0.0).astype(x.dtype))
    tmask = torch.from_numpy(mask).permute(0, 3, 1, 2)
    monkeypatch.setattr(D, "dropout", lambda x, rate, gen, band=None:
                        torch.where(tmask, x / 0.9, 0.0).to(x.dtype))
    X, Y = _tiles(sz, 2 * B, n_cls)
    freeze = "concat_projection"

    jnet = JSegNet((sz, sz), n_cls, "mobilenetv2", "original")
    params, state = jload_h5(H5, *jnet.init(jax.random.key(0)))
    mesh = get_mesh(jax.devices()[:1])
    jck = str(tmp_path / "jax.npz")
    want = []
    for epochs, kw in ((1, {}), (2, {"resume_from": jck})):
        jt = JTrainer(jnet, epochs=epochs, mesh=mesh, verbose=0,
                      freeze_before=freeze)
        want += jt.fit(params, state, JArrayBatcher(X, Y, B, n_classes=n_cls),
                       state_checkpoint=jck, **kw)["loss"]

    ck = str(tmp_path / "port.npz")
    losses = []
    for epochs, kw in ((1, {}), (2, {"resume_from": ck})):
        net = load_npz(NPZ, SegNet((sz, sz), n_cls))
        tr = Trainer(net, epochs=epochs, device="cpu", workers=0, verbose=0,
                     freeze_before=freeze)
        losses += tr.fit(net, ArrayBatcher(X, Y, B, n_classes=n_cls),
                         state_checkpoint=ck, **kw)["loss"]
    assert len(losses) == len(want) == 2
    np.testing.assert_allclose(losses, want, rtol=JAX_LOSS_REL)


def test_callback_state_rides_the_checkpoint(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    _, tr, _ = _fit(2, tmp_path, state_checkpoint=ckpt)
    saved = [cb.get_state() for cb in tr.callbacks]
    assert np.isfinite(saved[0]["best"]) and saved[1]["wait"] == 1
    # a fresh trainer, its callbacks in another order: each class finds its
    # own state; the epoch count is restored, so nothing more runs
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35)
    cbs = _callbacks(tmp_path)[::-1]
    t2 = Trainer(net, epochs=2, device="cpu", workers=0, verbose=0,
                 callbacks=cbs)
    hist = t2.fit(net, *_gens(), state_checkpoint=ckpt, resume_from=ckpt)
    assert hist["loss"] == []
    assert [cb.get_state() for cb in cbs[::-1]] == saved
    assert t2.lr_scale == tr.lr_scale


class _Saves(list):
    def __call__(self, path, net):
        self.append(path)


def test_model_checkpoint_best_only_and_unconditional(tmp_path,
                                                      monkeypatch):
    from deeplab_tpu_torch import params as P
    saves = _Saves()
    monkeypatch.setattr(P, "save_npz", saves)
    best = ModelCheckpoint(str(tmp_path / "b.npz"), monitor="loss",
                           mode="min")
    every = ModelCheckpoint(str(tmp_path / "e.npz"), save_best_only=False)
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35)
    for cb in (best, every):
        cb.set_trainer(type("T", (), {"model": net})())
    for epoch, loss in enumerate((0.5, 0.7, 0.4, 0.4)):
        best.on_epoch_end(epoch, {"loss": loss})
    assert saves == [str(tmp_path / "b.npz")] * 2 and best.best == 0.4
    saves.clear()
    for epoch in range(3):              # no val_Jaccard: saved all the same
        every.on_epoch_end(epoch, {"loss": 1.0})
    assert saves == [str(tmp_path / "e.npz")] * 3


def test_model_checkpoint_writes_both_formats(tmp_path):
    _, _, hist = _fit(1, tmp_path)
    assert os.path.exists(tmp_path / "best.npz")
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35)
    tr = Trainer(net, epochs=1, device="cpu", workers=0, verbose=0,
                 callbacks=[ModelCheckpoint(str(tmp_path / "best.h5"))])
    tr.fit(net, *_gens())
    from deeplab_tpu_torch.params import load_weights
    for name in ("best.h5", "best.npz"):
        load_weights(str(tmp_path / name), SegNet((SZ, SZ), N_CLS,
                                                  alpha=0.35))


def test_model_checkpoint_h5_without_h5py_refused_at_construction(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r"\.npz"):
        ModelCheckpoint(str(tmp_path / "w.h5"))
    ModelCheckpoint(str(tmp_path / "w.npz"))
