"""The port's notebook workflow (``deeplab_tpu_torch/examples/
segmentation_workflow.py``) and gallery (``deeplab_tpu_torch/tools/
make_gallery.py``) on the CPU, one torch thread.

- The workflow runs in process on 30 synthetic 48x48 VOC images (the JAX
  example test's dataset) at 32x32 for 2 epochs: it prints the three result
  lines, writes its checkpoint as ``.npz`` where ``h5py`` does not import
  (made so here), and reloading that file into a fresh net gives the
  workflow's reloaded weights bit for bit.
- Its evaluation cells, given JAX's weights carried across
  (``params.params_from_jax``) and the same batches (the trained 3-class
  net on the mini_voc tiles at 64x64), give JAX's results: the sample's
  prediction and ``viz.mIOU`` equal, ``viz.calculate_iou``'s confusion
  matrix and per-class IoU equal and its published mean within 2 f32 ulps
  (both forwards float32: summation order only).
- The gallery at 64x64 gives the port ``Predictor``s' masks bit for bit, and
  its raw masks agree with JAX's gallery stack (its ``Predictor`` under
  "mixed") on at least 0.99 of pixels (the "mixed" argmax bound).
"""

import os

import numpy as np
import pytest
import torch

from deeplab_tpu_torch import grade as G
from deeplab_tpu_torch import params as P
from deeplab_tpu_torch.examples import segmentation_workflow as WF
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.tools import make_gallery as MG

SZ = 64
ULPS2 = 2 * float(np.finfo(np.float32).eps)
MIXED_FLOOR = 0.99


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("voc_wf")
    (root / "JPEGImages" / "train").mkdir(parents=True)
    (root / "SegmentationClassAug").mkdir()
    rng = np.random.RandomState(0)
    for i in range(30):
        img = np.zeros((48, 48, 3), np.uint8)
        img[:] = (40, 90, 160)
        cy, cx, r = rng.randint(12, 36), rng.randint(12, 36), rng.randint(6, 12)
        yy, xx = np.mgrid[:48, :48]
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        img[m] = (220, 60, 50)
        Image.fromarray(img).save(
            root / "JPEGImages" / "train" / f"im{i:02d}.jpg", quality=95)
        Image.fromarray(m.astype(np.uint8), mode="L").save(
            root / "SegmentationClassAug" / f"im{i:02d}.png")
    return str(root)


def test_workflow_runs_and_reloads_its_checkpoint(voc_dir, tmp_path,
                                                  capsys, monkeypatch):
    monkeypatch.setattr(P, "h5_available", lambda: False)
    out_dir = tmp_path / "w"
    res = WF.main(["--dataset", voc_dir, "--image-size", "32", "32",
                   "--batch-size", "4", "--epochs", "2", "--out-dir",
                   str(out_dir), "--device", "cpu", "--seed", "3"])
    out = capsys.readouterr().out
    assert "sample mIOU (no CRF):" in out
    assert "sample mIOU (+CRF):" in out
    assert 'Published-metric "Mean IOU"' in out
    assert res["modelpath"] == str(out_dir / "mobilenetv2_original.npz")
    assert os.path.exists(res["modelpath"])
    assert len(res["history"]["val_Jaccard"]) == 2
    fresh = P.load_weights(res["modelpath"], SegNet((32, 32), 21, seed=9))
    got, want = fresh.state_dict(), res["model"].state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert 0.0 <= res["mean_iou"] <= 1.0


class Tiles:
    """The first 8 mini_voc tiles at 64x64 in batches of 4, as the
    generator gives them: X (B, H, W, 3) BGR f32, Y (B, H*W, 1) ids."""

    def __init__(self):
        X, Y = G._load_tiles((SZ, SZ))
        self.X, self.Y = X[:8], Y[:8].reshape(8, -1, 1)

    def __len__(self):
        return 2

    def __getitem__(self, i):
        s = slice(4 * i, 4 * i + 4)
        return self.X[s], self.Y[s], None


@pytest.fixture(scope="module")
def nets():
    """JAX's net with the trained weights (its strict h5 load) and the
    port's with the same arrays carried across."""
    import jax
    from deeplab_tpu.models.seg_model import SegNet as JSegNet
    from deeplab_tpu.params import load_keras_h5 as jload_h5
    jnet = JSegNet((SZ, SZ), G.N_CLASSES, "mobilenetv2", "original")
    params, state = jload_h5(G.WEIGHTS[:-4] + ".h5",
                             *jnet.init(jax.random.key(0)), strict=True)
    tnet = P.params_from_jax(SegNet((SZ, SZ), G.N_CLASSES, seed=5), params,
                             state).eval()
    return jnet, params, state, tnet


def test_evaluation_cells_equal_jax(nets):
    import jax.numpy as jnp
    from deeplab_tpu import viz as JV
    jnet, params, state, tnet = nets
    gen = Tiles()
    # cells 7-9: the sample's float32 prediction and its mIOU
    for seed in (0, 1):
        x, gt, preds, _, miou, _ = WF.sample_compare(tnet, gen, (SZ, SZ),
                                                     seed, "cpu")
        i = np.random.RandomState(seed).randint(0, len(gen))
        jx = gen[i][0]
        jpred = np.argmax(np.asarray(jnet.apply(params, state,
                                                jnp.asarray(jx))[0]),
                          -1)[0].reshape(SZ, SZ)
        np.testing.assert_array_equal(x, jx[0])
        np.testing.assert_array_equal(preds, jpred)
        assert miou == JV.mIOU(gt, jpred)
    # cells 10-11: the confusion matrix and the published mean
    conf, iou, mean = WF.dataset_iou(tnet, gen, G.N_CLASSES)
    jconf, jiou, jmean = JV.calculate_iou(jnet, params, state, gen,
                                          nb_classes=G.N_CLASSES)
    np.testing.assert_array_equal(conf, jconf)
    np.testing.assert_array_equal(iou, jiou)
    assert mean == pytest.approx(jmean, rel=ULPS2, abs=0)
    assert conf.sum() == (gen.Y < G.N_CLASSES).sum()


def test_gallery_gives_the_predictors_masks(tmp_path, nets):
    import jax.numpy as jnp  # noqa: F401
    from deeplab_tpu.predictor import Predictor as JPredictor
    from deeplab_tpu_torch.predictor import Predictor
    out = MG.render(str(tmp_path), (SZ, SZ), device="cpu")
    saved = np.load(os.path.join(tmp_path, "gallery_masks.npz"))
    for k in ("picks", "gt", "raw", "crf"):
        np.testing.assert_array_equal(saved[k], out[k])
    X, _ = G._load_tiles((SZ, SZ))
    batch = X[list(MG.PICKS)]
    net = G._net((SZ, SZ))
    raw = Predictor(net, compute_dtype="mixed", device="cpu")(batch)
    crf = G._stacks(net, device="cpu")["production"](batch)
    np.testing.assert_array_equal(out["raw"], raw)
    np.testing.assert_array_equal(out["crf"], crf)
    assert out["raw"].shape == (4, SZ, SZ)
    jnet, params, state, _ = nets
    jraw = np.asarray(JPredictor(jnet, params, state, crf=None,
                                 compute_dtype="mixed")(batch))
    agree = float((out["raw"] == jraw).mean())
    print(f"gallery raw masks against JAX's mixed Predictor: {agree:.5f}")
    assert agree >= MIXED_FLOOR, agree
