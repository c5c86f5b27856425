"""Training on the card: a bf16 fit resumed from its train-state checkpoint,
remat's launch counts, and weights saved as ``.npz`` reloaded and served.

Imports only torch and numpy, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_gpu.py

Without CUDA every test skips.  MobileNetV2 at width 0.35, 64x64, B=2,
3 classes: the 14 training blocks run the five phase kernels.
"""

import os

import numpy as np
import pytest
import torch

from deeplab_tpu_torch.crf import PRODUCTION_CONFIG
from deeplab_tpu_torch.data.generator import ArrayBatcher
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_npz
from deeplab_tpu_torch.predictor import Predictor
from deeplab_tpu_torch.train import ModelCheckpoint, Trainer

SZ, N_CLS = 64, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _data(n=4):
    r = np.random.RandomState(0)
    X = (r.rand(n, SZ, SZ, 3) * 255).astype(np.float32)
    Y = r.randint(0, N_CLS + 1, (n, SZ * SZ)).astype(np.int32)
    return ArrayBatcher(X, Y, 2, n_classes=N_CLS)


def _fit(epochs, cuda, callbacks=(), **fit_kw):
    net = SegNet((SZ, SZ), N_CLS, alpha=0.35, seed=1)
    tr = Trainer(net, epochs=epochs, compute_dtype=torch.bfloat16,
                 callbacks=callbacks, workers=0, verbose=0, device=cuda)
    return net, tr, tr.fit(net, _data(), **fit_kw)


@pytest.mark.gpu
def test_bf16_resume_equals_uninterrupted_bit_for_bit(cuda, tmp_path):
    for n in FMT.PHASES:
        getattr(FMT, n).launches = 0
    whole, tw, hw = _fit(2, cuda)
    assert all(getattr(FMT, n).launches == 14 * 4 for n in FMT.PHASES)
    ckpt = str(tmp_path / "state.npz")
    _fit(1, cuda, state_checkpoint=ckpt)
    resumed, tr, hr = _fit(2, cuda, state_checkpoint=ckpt, resume_from=ckpt)
    assert hr["loss"] == hw["loss"][1:]
    for (k, u), v in zip(whole.state_dict().items(),
                         resumed.state_dict().values()):
        assert torch.equal(u, v), k
    assert torch.equal(tr.gen.get_state(), tw.gen.get_state())


@pytest.mark.gpu
def test_remat_launch_counts(cuda):
    X, Y, sw = _data()[0]
    for remat, fwd in ((False, 14), (True, 28)):
        net = SegNet((SZ, SZ), N_CLS, alpha=0.35, seed=1)
        tr = Trainer(net, compute_dtype=torch.bfloat16, remat=remat,
                     verbose=0, device=cuda)
        tr.setup(net)
        for n in FMT.PHASES:
            getattr(FMT, n).launches = 0
        tr.train_step(X, Y, sw["pred_mask"])
        got = {n: getattr(FMT, n).launches for n in FMT.PHASES}
        assert got == {"f1": fwd, "f2": fwd, "f3": fwd, "b2": 14,
                       "b34": 14}, (remat, got)


@pytest.mark.gpu
def test_npz_weights_reload_into_predictor_bit_for_bit(cuda, tmp_path):
    path = str(tmp_path / "w.npz")
    net, _, _ = _fit(1, cuda, callbacks=[ModelCheckpoint(
        path, save_best_only=False)])
    assert os.path.exists(path)
    fresh = load_npz(path, SegNet((SZ, SZ), N_CLS, alpha=0.35, seed=7))
    X = _data()[0][0]
    img = torch.from_numpy(X).to(cuda)
    fresh, net = fresh.to(cuda).eval(), net.eval()
    assert torch.equal(fresh.logits(img, "mixed"), net.logits(img, "mixed"))
    for crf in (None, PRODUCTION_CONFIG):
        np.testing.assert_array_equal(
            Predictor(fresh, crf=crf, compute_dtype="mixed")(X),
            Predictor(net, crf=crf, compute_dtype="mixed")(X))
