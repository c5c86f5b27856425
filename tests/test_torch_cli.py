"""The port's command line (deeplab_tpu_torch/cli.py) on the CPU, mirroring
tests/test_cli.py: predict (against the JAX CLI's masks, the port's
Predictor, the notebook CRF), export-serving then predict --artifact, serve
--artifact over HTTP, evaluate (against the JAX CLI's mean IoU),
export-config, and train, which is not ported.  Every command runs with
``--device cpu``: without it the port asks for the card."""

import io
import os
import re
import urllib.request

import numpy as np
import pytest
from PIL import Image

from deeplab_tpu import cli as jcli

from deeplab_tpu_torch import cli
from deeplab_tpu_torch.config import Config
from deeplab_tpu_torch.data.augment import resize_bilinear
from deeplab_tpu_torch.data.generator import _imread_bgr
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import load_keras_h5
from deeplab_tpu_torch.predictor import Predictor
from deeplab_tpu_torch.serve import BatchingServer

DATA = os.path.join(os.path.dirname(__file__), "data")
H5 = os.path.join(DATA, "mini_voc_trained.h5")
VOC = os.path.join(DATA, "mini_voc")
CPU = ["--device", "cpu"]


def _config(root, size, **crf):
    cfg = Config()
    cfg.model.image_size = (size, size)
    cfg.model.n_classes = 3
    cfg.data.dataset = VOC
    # keep the checkpoint fallback away from the repo's weights/ folder
    cfg.train.checkpoint_dir = str(root / "ckpt")
    for k, v in crf.items():
        setattr(cfg.crf, k, v)
    path = str(root / f"config{size}.json")
    cfg.save(path)
    return path, cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg_path, cfg = _config(root, 64, n_iters=2)
    d = os.path.join(VOC, "JPEGImages", "train")
    imgs = [os.path.join(d, f) for f in sorted(os.listdir(d))[:2]]
    return cfg_path, cfg, imgs, root


def _masks(out_dir, imgs):
    return [np.asarray(Image.open(os.path.join(
        out_dir, os.path.splitext(os.path.basename(p))[0] + "_mask.png")))
        for p in imgs]


def _live(cfg, crf, return_raw=False):
    net = load_keras_h5(H5, SegNet(tuple(cfg.model.image_size), 3))
    return Predictor(net, crf=cli._crf_config(cfg) if crf else None,
                     compute_dtype="float32", device="cpu",
                     return_raw=return_raw)


def _inputs(imgs, size):
    return np.stack([resize_bilinear(_imread_bgr(p), (size, size))
                     for p in imgs]).astype(np.float32)


def test_predict_agrees_with_the_jax_cli(setup):
    cfg_path, _, imgs, root = setup
    out, jout = str(root / "p"), str(root / "p_jax")
    cli.main(["predict", "--config", cfg_path, "--weights", H5,
              "--images", *imgs, "--out-dir", out] + CPU)
    jcli.main(["predict", "--config", cfg_path, "--weights", H5,
               "--images", *imgs, "--out-dir", jout])
    for m, j in zip(_masks(out, imgs), _masks(jout, imgs)):
        assert m.shape == (64, 64) and m.max() < 3
        agree = float((m == j).mean())
        print(f"predict: port vs JAX CLI masks {agree:.5f}")
        assert agree >= 0.99, agree


def test_predict_crf_equals_the_predictor(setup):
    cfg_path, cfg, imgs, root = setup
    out = str(root / "p_crf")
    cli.main(["predict", "--config", cfg_path, "--weights", H5, "--crf",
              "--images", *imgs, "--out-dir", out] + CPU)
    raw, refined = _live(cfg, True, return_raw=True)(_inputs(imgs, 64))
    assert (raw != refined).any()          # the CRF moved some pixels
    for m, want in zip(_masks(out, imgs), refined):
        np.testing.assert_array_equal(m, want)
    for p in imgs:                          # the colorized mask is written
        stem = os.path.splitext(os.path.basename(p))[0]
        assert os.path.exists(os.path.join(out, stem + "_color.png"))


def test_predict_notebook_crf_runs(setup):
    cfg_path, _, imgs, root = setup
    out = str(root / "p_nb")
    cli.main(["predict", "--config", cfg_path, "--weights", H5, "--crf",
              "--notebook-crf", "--images", imgs[0], "--out-dir", out] + CPU)
    (m,) = _masks(out, imgs[:1])
    assert m.shape == (64, 64) and m.max() < 3


def test_device_defaults_to_the_card(setup):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    cfg_path, _, imgs, root = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["predict", "--config", cfg_path, "--images", imgs[0],
                  "--out-dir", str(root / "p_card")])


def test_export_serving_then_predict_from_the_artifact(setup, capsys):
    cfg_path, _, imgs, root = setup
    art = str(root / "serving.npz")
    cli.main(["export-serving", "--config", cfg_path, "--weights", H5,
              "--out", art, "--crf", "--f32"] + CPU)
    said = capsys.readouterr().out
    assert "platforms=['cpu']" in said and "batch=symbolic" in said
    out, ref = str(root / "p_art"), str(root / "p_ref")
    cli.main(["predict", "--images", *imgs, "--artifact", art,
              "--out-dir", out] + CPU)
    cli.main(["predict", "--config", cfg_path, "--weights", H5, "--crf",
              "--images", *imgs, "--out-dir", ref] + CPU)
    for a, b in zip(_masks(out, imgs), _masks(ref, imgs)):
        np.testing.assert_array_equal(a, b)


def test_serve_artifact_clamps_the_batch_and_answers(setup, monkeypatch):
    cfg_path, cfg, imgs, root = setup
    art = str(root / "serve.npz")
    cli.main(["export-serving", "--config", cfg_path, "--weights", H5,
              "--out", art, "--batch", "2", "--f32"] + CPU)
    captured = {}
    monkeypatch.setattr(
        BatchingServer, "serve_forever",
        lambda self, host="0.0.0.0", port=8517: captured.update(
            server=self, host=host, port=port))
    cli.main(["serve", "--artifact", art, "--port", "0", "--max-batch", "8",
              "--max-wait-ms", "1"] + CPU)
    srv = captured["server"]
    assert srv.sz == (64, 64)
    assert srv.dispatcher.max_batch == 2     # the artifact's fixed batch
    port = srv.start(port=0)
    try:
        with open(imgs[0], "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=f.read(),
                method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            mask = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        srv.stop()
    np.testing.assert_array_equal(mask,
                                  _live(cfg, False)(_inputs(imgs[:1], 64))[0])


def _mean_iou(text):
    return float(re.findall(r"Mean IOU \(published metric\): ([0-9.]+)",
                            text)[-1])


def test_evaluate_prints_the_jax_cli_mean_iou(tmp_path, capsys):
    cfg_path, _ = _config(tmp_path, 128)
    jcli.main(["evaluate", "--config", cfg_path, "--weights", H5])
    want = _mean_iou(capsys.readouterr().out)
    cli.main(["evaluate", "--config", cfg_path, "--weights", H5] + CPU)
    got = _mean_iou(capsys.readouterr().out)
    print(f"evaluate: mean IoU port {got}, JAX CLI {want}")
    assert abs(got - want) <= 1e-4


def test_export_config_equals_jax(capsys):
    cli.main(["export-config"])
    mine = capsys.readouterr().out
    jcli.main(["export-config"])
    assert mine == capsys.readouterr().out
    assert Config.from_json(mine).to_json() + "\n" == mine


def test_train_is_not_ported(setup):
    cfg_path = setup[0]
    with pytest.raises(NotImplementedError, match="A7"):
        cli.main(["train", "--config", cfg_path, "--no-finetune"] + CPU)
