"""The rest of the training surface on the CPU, against the JAX package where
it has a counterpart: remat, the profiler window, ``StepTimer``,
``calibrate_bn``, the multi-process pipeline, ``ArrayBatcher``'s adaptive
weights, ``CityscapesGenerator``, ``TensorBoard``, the ``SegModel`` training
methods and ``cli train``.

Tolerances.  Remat against plain: loss ``rtol`` 1e-5, parameters 1e-5 /
1e-6 (JAX tests/test_trainer.py:108); the recompute replays the same ops on
the same values, so on the CPU they agree bit for bit, which is asserted
too.  ``calibrate_bn`` against JAX's: both average per-batch means and
biased variances in f32 and differ only in summation order, which the
seeded net's later layers amplify (BN over 2x4x4 values): 1e-4 of each
buffer's largest magnitude, a mean's scale being at least its channel's
standard deviation (measured: 6e-5 at ``concat_projection_BN``).
Generators and pipelines move and draw the same numbers: exact.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import jax
import torch

import deeplab_tpu.data.native as JN
from deeplab_tpu.data import cityscapes as JC
from deeplab_tpu.data.generator import ArrayBatcher as JArrayBatcher
from deeplab_tpu.data.generator import \
    MultiprocessPrefetcher as JMultiprocessPrefetcher
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.train.bn_calibrate import calibrate_bn as jcalibrate_bn

from deeplab_tpu_torch import cli
from deeplab_tpu_torch.config import Config
from deeplab_tpu_torch.data import cityscapes as TC
from deeplab_tpu_torch.data.generator import (ArrayBatcher,
                                              MultiprocessPrefetcher)
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
from deeplab_tpu_torch.models.seg_model import SegModel, SegNet
from deeplab_tpu_torch.params import params_from_jax, trees_from_net
from deeplab_tpu_torch.train import (EarlyStopping, ModelCheckpoint,
                                     ReduceLROnPlateau, TensorBoard, Trainer,
                                     calibrate_bn)
from deeplab_tpu_torch.train.profiling import StepTimer, StepWindowProfiler

import torch_pipeline_gens as G

DATA = os.path.join(os.path.dirname(__file__), "data")
VOC = os.path.join(DATA, "mini_voc")
SZ, N_CLS = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small steps: the suite's test workers
    share the cores, and torch's thread pools oversubscribed spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _disc_data(n=4, seed=0, sz=SZ):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:sz, :sz]
    X = np.zeros((n, sz, sz, 3), np.float32)
    Y = np.zeros((n, sz, sz), np.int32)
    for i in range(n):
        cy, cx = r.randint(sz // 3, 2 * sz // 3, 2)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (sz // 5) ** 2
        X[i] = r.randint(0, 80, 3)
        X[i][disc] = r.randint(150, 255, 3)
        Y[i][disc] = 1
        Y[i][0, :] = N_CLS
    return X, Y.reshape(n, sz * sz)


def _fit(epochs=2, sz=SZ, **kw):
    X, Y = _disc_data(sz=sz)
    net = SegNet((sz, sz), N_CLS, alpha=0.35, seed=1)
    kw.setdefault("workers", 0)
    tr = Trainer(net, epochs=epochs, device="cpu", verbose=0, **kw)
    return net, tr, tr.fit(net, ArrayBatcher(X, Y, 2, n_classes=N_CLS))


# ----------------------------------------------------------------- remat ----

def test_remat_fit_matches_plain_and_updates_bn_once():
    plain, _, hp = _fit()
    remat, _, hr = _fit(remat=True)
    np.testing.assert_allclose(hr["loss"], hp["loss"], rtol=1e-5)
    for (k, u), v in zip(plain.state_dict().items(),
                         remat.state_dict().values()):
        # BN buffers included: a second momentum update would move them
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert torch.equal(u, v), k
    assert hr["loss"] == hp["loss"]


def test_bf16_remat_step_launch_counts_and_equality():
    """Under bf16 the 14 training blocks run the phases (their plain
    versions on the CPU): remat runs F1-F3 again in the recompute, 28
    each a step, and B2, B34 once, 14; the step equals the plain one."""
    r = np.random.RandomState(4)
    X = (r.rand(2, 64, 64, 3) * 255).astype(np.float32)
    Y = r.randint(0, 4, (2, 64 * 64, 1)).astype(np.int32)
    SW = np.ones((2, 64 * 64), np.float32)
    out = {}
    for remat in (False, True):
        net = SegNet((64, 64), 3, alpha=0.35, seed=2)
        tr = Trainer(net, compute_dtype=torch.bfloat16, device="cpu",
                     workers=0, verbose=0, remat=remat)
        tr.setup(net)
        with FMT.plain_versions() as calls:
            m = tr.train_step(X, Y, SW)
        counts = {n: len(calls[n]) for n in FMT.PHASES}
        want = 28 if remat else 14
        assert counts == {"f1": want, "f2": want, "f3": want, "b2": 14,
                          "b34": 14}, (remat, counts)
        out[remat] = (m["loss"].item(), dict(net.named_parameters()),
                      dict(net.named_buffers()), tr.gen.get_state())
    (lp, pp, bp, gp), (lr, pr, br, gr) = out[False], out[True]
    assert lp == lr
    for n in pp:
        assert torch.equal(pp[n].grad, pr[n].grad), n
        assert torch.equal(pp[n], pr[n]), n
    for n in bp:
        assert torch.equal(bp[n], br[n]), n
    assert torch.equal(gp, gr)


# ------------------------------------------------------------- profiling ----

def test_profile_dir_writes_a_trace_of_the_window(tmp_path):
    d = str(tmp_path / "prof")
    _, tr, _ = _fit(epochs=2, profile_dir=d, profile_steps=(1, 3))
    path = os.path.join(d, "steps_1_3.pt.trace.json")
    assert tr.profiler.done and tr.profiler.path == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::convolution") for n in names)


def test_profiler_close_recovers_an_open_window(tmp_path):
    d = str(tmp_path / "prof")
    # a window past the run's end: fit closes it and writes what it traced
    _, tr, _ = _fit(epochs=1, profile_dir=d, profile_steps=(1, 50))
    assert tr.profiler.done and not tr.profiler.active
    assert os.path.exists(os.path.join(d, "steps_1_50.pt.trace.json"))
    p = StepWindowProfiler(str(tmp_path / "p2"), 0, 3)
    p.before_step(0)
    p.after_step(0)                 # not the window's last step
    assert p.active
    p.close()
    assert p.done and os.path.exists(p.path)
    p.close()                       # a second close is a no-op
    with pytest.raises(ValueError):
        StepWindowProfiler(d, 3, 3)


def test_step_timer():
    t = StepTimer(window=3)
    assert t.mean_step_s == 0.0 and t.items_per_s == 0.0
    for items in (2, 4, 6, 8):
        t.start()
        t.stop(items)
    assert len(t.times) == 3 and [i for _, i in t.times] == [4, 6, 8]
    assert t.items_per_s == pytest.approx(
        18 / sum(s for s, _ in t.times))
    assert t.summary().endswith("items/s") and "ms/step" in t.summary()


# --------------------------------------------------------- BN calibration ---

def test_calibrate_bn_matches_jax_and_leaves_frozen_layers():
    jnet = JSegNet((32, 32), 3, "mobilenetv2", "original", alpha=0.35)
    params, state = jnet.init(jax.random.key(3))
    r = np.random.RandomState(5)
    batches = [(r.rand(2, 32, 32, 3) * 255).astype(np.float32)
               for _ in range(3)]
    frozen = frozenset({"Conv_BN", "expanded_conv_2_expand_BN"})
    jstate = jcalibrate_bn(jnet, params, state, batches, frozen=frozen)
    net = params_from_jax(SegNet((32, 32), 3, alpha=0.35),
                          jax.tree.map(np.asarray, params),
                          jax.tree.map(np.asarray, state))
    before = {k: v.clone() for k, v in net.named_buffers()}
    calibrate_bn(net, batches, frozen=frozen)
    assert not net.calibrating and net.training
    _, got = trees_from_net(net)
    for layer, vars_ in jstate.items():
        for var, want in vars_.items():
            want = np.asarray(want)
            # a mean's scale is its channel's spread too: after a batch-
            # normalized input and a linear layer it is zero in exact
            # arithmetic, and what is left is rounding
            scale = max(np.abs(want).max(), np.sqrt(np.asarray(
                jstate[layer]["moving_variance"]).max()))
            err = np.abs(got[layer][var] - want).max()
            assert err <= 1e-4 * scale, (layer, var, err / scale)
    for layer in frozen:
        for var in ("moving_mean", "moving_variance"):
            assert torch.equal(getattr(getattr(net, layer), var),
                               before[f"{layer}.{var}"])
    moved = [k for k, v in net.named_buffers()
             if not torch.equal(v, before[k])]
    assert "expanded_conv_3_expand_BN.moving_mean" in moved


def test_calibrate_bn_takes_the_plain_composition_under_bf16(monkeypatch):
    """No training phase, no eval-mode kernel, no dropout draw: the BN
    statistics are the plain composition's, whatever the policy."""
    from deeplab_tpu_torch.kernels import fused_dw as FDW
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    net = SegNet((64, 64), 3, alpha=0.35, seed=4)
    X = (np.random.RandomState(6).rand(2, 64, 64, 3) * 255).astype(
        np.float32)
    calls = []
    for mod, name in ((FM, "fused_mbconv_reference"),
                      (FDW, "fused_dw_bn_relu6_reference")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k:
                            calls.append(1) or _o(*a, **k))
    with FMT.plain_versions() as phases:
        calibrate_bn(net.eval(), [X], compute_dtype=torch.bfloat16)
    assert not calls and not any(phases[n] for n in FMT.PHASES)
    assert not net.training
    # the statistics are the bf16 composition's batch statistics
    ref = SegNet((64, 64), 3, alpha=0.35, seed=4).train()
    ref.calibrating = True
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: seen.__setitem__(n, a[0].float()))
        for n, m in ref.named_children() if n.endswith("_BN")]
    with torch.no_grad():
        ref.apply_logits(torch.from_numpy(X), torch.bfloat16)
    for h in hooks:
        h.remove()
    x = seen["expanded_conv_4_project_BN"]
    np.testing.assert_allclose(
        net.expanded_conv_4_project_BN.moving_mean.numpy(),
        x.mean(dim=(0, 2, 3)).numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- pipeline --

def test_mp_prefetcher_ordered_complete_unaliased():
    pf = MultiprocessPrefetcher(G.CountingGen(), workers=3)
    for _ in range(2):                        # fresh workers each pass
        batches = list(pf)
        assert len(batches) == 7
        for i, (X, Y, sw) in enumerate(batches):
            assert X[0, 0, 0, 0] == i and Y[0, 0, 0] == i
            assert sw["pred_mask"][0, 0] == i


@pytest.mark.parametrize("gen,match", [(G.FailingGen(), "failed"),
                                       (G.DyingGen(), "died")])
def test_mp_prefetcher_errors_propagate(gen, match):
    with pytest.raises(RuntimeError, match=match):
        list(MultiprocessPrefetcher(gen, workers=2))


def test_mp_prefetcher_reseeds_and_equals_jax():
    pf = MultiprocessPrefetcher(G.NoisyGen(n=4), workers=2, seed=5)
    jpf = JMultiprocessPrefetcher(G.NoisyGen(n=4), workers=2, seed=5)
    epochs = [[b[0] for b in pf] for _ in range(2)]
    jepochs = [[b[0] for b in jpf] for _ in range(2)]
    assert not all(np.array_equal(a, b) for a, b in zip(*epochs))
    for mine, theirs in zip(epochs, jepochs):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_mp_prefetcher_workers_run_nothing_of_the_main_script(tmp_path):
    """The workers do not re-run the parent's main script (a training
    script's torch import would cost every worker seconds): a script with
    no ``__main__`` guard, which they would re-enter, iterates twice."""
    import subprocess
    script = tmp_path / "train_script.py"
    script.write_text(
        "import sys\n"
        f"sys.path[:0] = [{os.path.dirname(DATA)!r}, "
        f"{os.path.dirname(os.path.dirname(DATA))!r}]\n"
        "import torch_pipeline_gens as G\n"
        "from deeplab_tpu_torch.data.generator import "
        "MultiprocessPrefetcher\n"
        "pf = MultiprocessPrefetcher(G.CountingGen(n=4), workers=2)\n"
        "print([len(list(pf)) for _ in range(2)], sys.modules['__main__']"
        ".__file__ == __file__)\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[4, 4] True"


def test_trainer_multiprocess_workers_match_sync():
    _, _, sync = _fit(epochs=2)
    _, _, multi = _fit(epochs=2, workers=2, use_multiprocessing=True)
    assert sync["loss"] == multi["loss"]


def test_array_batcher_adaptive_weights_equal_jax():
    r = np.random.RandomState(7)
    X = r.rand(5, 8, 8, 3).astype(np.float32)
    Y = r.randint(0, 5, (5, 64)).astype(np.int32)      # 4 is void
    Y[1] = 0
    mine = ArrayBatcher(X, Y, 2, n_classes=4, adaptive_weights=True)
    theirs = JArrayBatcher(X, Y, 2, n_classes=4, adaptive_weights=True)
    np.testing.assert_array_equal(mine.SW, theirs.SW)
    assert mine.SW.dtype == np.float32 and not np.all(mine.SW == 1)
    for i in range(len(mine)):
        for a, b in zip(mine[i][:2], theirs[i][:2]):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- Cityscapes --

def _fake_cityscapes(root):
    from PIL import Image
    r = np.random.RandomState(8)
    ids = np.array([0, 1, 7, 8, 11, 17, 21, 23, 24, 26, 33, 255])
    for split, n in (("train", 6), ("val", 2)):
        for c, city in enumerate(("aachen", "bonn")):
            for i in range(n // 2):
                stem = f"{city}_{i:06d}_{c:06d}"
                for top, suffix, arr in (
                        ("leftImg8bit", "leftImg8bit",
                         r.randint(0, 255, (24, 40, 3)).astype(np.uint8)),
                        ("gtFine", "gtFine_labelIds",
                         ids[r.randint(0, len(ids), (24, 40))].astype(
                             np.uint8))):
                    d = os.path.join(root, top, split, city)
                    os.makedirs(d, exist_ok=True)
                    Image.fromarray(arr).save(
                        os.path.join(d, f"{stem}_{suffix}.png"))


@pytest.mark.parametrize("mode,split", [("train", 0.0), ("validation", 0.0),
                                        ("train", 0.5)])
def test_cityscapes_generator_equals_jax(tmp_path, monkeypatch, mode, split):
    monkeypatch.setattr(JN, "available", lambda: False)
    _fake_cityscapes(str(tmp_path))
    assert TC.CLASS_NAMES == JC.CLASS_NAMES and TC.N_CLASSES == JC.N_CLASSES
    np.testing.assert_array_equal(TC._ID_TO_TRAIN, JC._ID_TO_TRAIN)
    kw = dict(mode=mode, validation_split=split, batch_size=2,
              resize_shape=(32, 16), crop_shape=None, blur=3,
              horizontal_flip=True, brightness=0.2, rotation=5.0, zoom=0.1,
              do_ahisteq=False)
    mine = TC.CityscapesGenerator(str(tmp_path), **kw)
    theirs = JC.CityscapesGenerator(str(tmp_path), **kw)
    assert mine.image_path_list == theirs.image_path_list
    assert mine.label_path_list == theirs.label_path_list
    assert len(mine) == len(theirs) >= 1
    import random
    for i in range(len(mine)):
        out = []
        for g in (mine, theirs):
            random.seed(i)
            np.random.seed(i)
            X, Y, sw = g[i]
            out.append((X.copy(), Y.copy(), sw["pred_mask"].copy()))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        assert out[0][1].max() <= TC.N_CLASSES


# ------------------------------------------------------------- callbacks ----

def test_tensorboard_writes_scalars_or_is_a_no_op(monkeypatch, tmp_path):
    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(("dir", log_dir))

        def add_scalar(self, k, v, step):
            written.append((k, v, step))

        def flush(self):
            pass
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    cb = TensorBoard(str(tmp_path))
    cb.set_trainer(type("T", (), {"current_lr": lambda self: 0.5})())
    cb.on_epoch_end(3, {"loss": 1.25})
    assert written == [("dir", str(tmp_path)), ("loss", 1.25, 3),
                       ("lr", 0.5, 3)]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    quiet = TensorBoard(str(tmp_path / "none"))
    quiet.set_trainer(cb.trainer)
    quiet.on_epoch_end(0, {"loss": 1.0})
    assert not os.path.exists(tmp_path / "none")


# ---------------------------------------------------------------- facade ----

def test_seg_model_train_generator_build_callbacks_and_train(tmp_path):
    seg = SegModel(VOC, (32, 32))
    seg.set_batch_size(2)
    seg.set_num_epochs(1)
    try:
        net = seg.create_seg_model("original", n=3, alpha=0.35)
        assert seg.modelpath == "weights/mobilenetv2_original.h5"
        seg.modelpath = str(tmp_path / "best.npz")
        cbs = seg.build_callbacks()
        assert [type(c) for c in cbs] == [ModelCheckpoint, ReduceLROnPlateau,
                                          EarlyStopping]
        assert cbs[0].filepath == seg.modelpath
        assert [type(c) for c in seg.build_callbacks(tf_board=True)] == [
            ReduceLROnPlateau, EarlyStopping, TensorBoard]
        kw = dict(do_ahisteq=False, n_classes=3, validation_split=0.2)
        tgen = seg.create_generators(mode="train", **kw)
        vgen = seg.create_generators(mode="validation", **kw)
        before = net.conv_upsample.kernel.detach().clone()
        hist = seg.train_generator(net, tgen, vgen, callbacks=cbs,
                                   workers=2, device="cpu", verbose=0)
        assert seg.model is net and len(hist["val_Jaccard"]) == 1
        assert not torch.equal(before, net.conv_upsample.kernel)
        assert os.path.exists(seg.modelpath)      # the best epoch's weights
        best = net.conv_upsample.kernel.detach().clone()
        fresh = seg.create_seg_model("original", n=3, alpha=0.35, seed=9)
        seg.modelpath = str(tmp_path / "best.npz")
        assert torch.equal(seg.load_weights(fresh).conv_upsample.kernel,
                           best)

        X, Y = _disc_data(4, sz=32)
        hist = seg.train(net, X, Y, (X[:2], Y[:2]), device="cpu",
                         workers=0, verbose=0)
        assert set(hist) >= {"loss", "val_loss", "val_Jaccard"}
    finally:
        SegModel.set_batch_size(16)
        SegModel.set_num_epochs(20)


# ------------------------------------------------------------------- cli ----

def _train_config(tmp_path, epochs):
    cfg = Config()
    cfg.model.image_size = (32, 32)
    cfg.model.n_classes = 3
    cfg.model.alpha = 0.35
    cfg.data.dataset = VOC
    cfg.data.validation_split = 0.2
    cfg.data.blur = 0
    cfg.train.epochs = epochs
    cfg.train.batch_size = 2
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.state_checkpoint = str(tmp_path / "state.npz")
    path = str(tmp_path / f"config{epochs}.json")
    cfg.save(path)
    return cfg, path


def test_cli_train_writes_weights_and_resumes(tmp_path, capsys,
                                              monkeypatch):
    # the card's machine: no h5py, so the weights are an npz
    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg, path = _train_config(tmp_path, 1)
    cli.main(["train", "--config", path, "--device", "cpu"])
    out = capsys.readouterr().out
    weights = os.path.join(cfg.train.checkpoint_dir,
                           "mobilenetv2_original.npz")
    assert f"weights: {weights}" in out
    assert os.path.exists(weights) and os.path.exists(
        cfg.train.state_checkpoint)
    _, path2 = _train_config(tmp_path, 2)
    cli.main(["train", "--config", path2, "--device", "cpu", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "(epoch 1," in out
    assert "Epoch 2/2" in out and "Epoch 1/2" not in out
    # the written weights load as --weights, by suffix
    cli.main(["train", "--config", path, "--device", "cpu", "--weights",
              weights])
    assert "freeze policy skipped" not in capsys.readouterr().out
