"""The reference's entry point, ``Deeplabv3``, and its probability-form
losses against the JAX package's on the CPU.

- ``Deeplabv3`` probabilities against JAX ``Deeplabv3.apply`` on the JAX
  net's own initial weights (numpy-carried through ``params_from_jax``),
  float32, within 1e-4: MobileNetV2 with the 21-class ``logits_semantic``
  head and a 3-class ``custom_logits_semantic`` one, Xception at output
  stride 16; ``infer`` shapes; the ``ValueError``s; ``weights=
  "pascal_voc"`` from a file written with ``save_keras_h5``, and
  ``FileNotFoundError`` without one (nothing is downloaded).
- ``sparse_crossentropy_ignoring_last_label`` and ``masked_sparse_ce``
  against JAX's within 1e-6 (void labels, saturated probabilities where
  the 1e-7 clip binds, with and without weights; the gradient).
- One f32 train step of a ``Deeplabv3`` (no ``apply_logits``: the Trainer's
  probability path) against the JAX Trainer's jitted step on the same
  weights, batch and dropout mask: loss within 1e-5, every gradient within
  1e-3 of its scale against ``jax.grad`` of the same loss (the bounds of
  tests/test_torch_train_step.py); under bf16 the 14 blocks take the
  training phases (their plain versions here), and the probability loss
  equals the logits loss of a ``SegNet`` with the same weights.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu import losses as JL
from deeplab_tpu.models import deeplabv3p as JD
from deeplab_tpu.params import save_keras_h5 as jsave_keras_h5
from deeplab_tpu.parallel.mesh import get_mesh
from deeplab_tpu.train.trainer import Trainer as JTrainer

import deeplab_tpu_torch
from deeplab_tpu_torch import losses
from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
from deeplab_tpu_torch.models import deeplabv3p as D
from deeplab_tpu_torch.models.deeplabv3p import Deeplabv3
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import (PASCAL_VOC_FILES, params_from_jax,
                                      to_keras_layout)
from deeplab_tpu_torch.train import Trainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(sz, classes, backbone="mobilenetv2", OS=16, alpha=0.35, seed=0,
          **kw):
    """(JAX Deeplabv3, params, state, port Deeplabv3 with those weights)."""
    jnet = JD.Deeplabv3(input_shape=(sz, sz, 3), classes=classes,
                        backbone=backbone, OS=OS, alpha=alpha, **kw)
    params, state = jnet.init(jax.random.key(seed))
    np_p = jax.tree.map(np.asarray, params)
    np_s = jax.tree.map(np.asarray, state)
    net = params_from_jax(Deeplabv3(input_shape=(sz, sz, 3), classes=classes,
                                    backbone=backbone, OS=OS, alpha=alpha,
                                    **kw), np_p, np_s)
    assert net.layer_order == jnet.layer_order
    return jnet, params, state, net


@pytest.mark.parametrize("classes,backbone,OS,sz", [
    (21, "mobilenetv2", 16, 32), (3, "mobilenetv2", 8, 32),
    (3, "xception", 16, 32)])
def test_probabilities_match_jax(classes, backbone, OS, sz):
    jnet, params, state, net = _pair(sz, classes, backbone, OS)
    head = "logits_semantic" if classes == 21 else "custom_logits_semantic"
    assert net.layer_order[-1] == head
    X = (np.random.RandomState(1).rand(2, sz, sz, 3) * 255).astype(
        np.float32)
    want, _ = jnet.apply(params, state, jnp.asarray(X))
    got = net.apply(torch.from_numpy(X))
    assert got.shape == (2, sz * sz, classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the eval-mode logits (the Predictor's labels are their argmax): the
    # probabilities are their softmax
    net.eval()
    logits = net.logits(torch.from_numpy(X))
    assert logits.shape == (2, sz, sz, classes)
    np.testing.assert_allclose(
        torch.softmax(logits.float(), -1).reshape(2, -1, classes).numpy(),
        got.numpy(), rtol=0, atol=1e-6)
    assert net.predict_ids(torch.from_numpy(X)).shape == (2, sz, sz)


def test_infer_shapes_and_errors():
    net = Deeplabv3(input_shape=(32, 32, 3), classes=4, alpha=0.35,
                    infer=True)
    x = torch.rand(2, 32, 32, 3) * 255
    probs = net.apply(x)
    assert probs.shape == (2, 32, 32, 4)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 32, 32))
    assert net.apply(x, infer=False).shape == (2, 32 * 32, 4)
    with pytest.raises(ValueError, match="weights"):
        Deeplabv3(weights="imagenet")
    with pytest.raises(ValueError, match="backbone"):
        Deeplabv3(backbone="resnet50")
    with pytest.raises(ValueError):
        JD.Deeplabv3(weights="imagenet")


def test_package_reexports():
    assert deeplab_tpu_torch.Deeplabv3 is Deeplabv3
    assert deeplab_tpu_torch.losses is losses
    assert deeplab_tpu_torch.metrics.jaccard_from_ids
    from deeplab_tpu_torch.models.seg_model import SegModel
    assert deeplab_tpu_torch.SegModel is SegModel


def test_pascal_voc_weights_from_a_local_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                 # no weights/ here
    monkeypatch.setenv("HOME", str(tmp_path))   # nor ~/.keras/models
    monkeypatch.setenv("DEEPLAB_TPU_WEIGHTS_DIR", str(tmp_path / "w"))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        Deeplabv3(weights="pascal_voc", input_shape=(32, 32, 3),
                  alpha=0.35)
    jnet = JD.Deeplabv3(input_shape=(32, 32, 3), alpha=0.35)
    params, state = jnet.init(jax.random.key(3))
    (tmp_path / "w").mkdir()
    jsave_keras_h5(str(tmp_path / "w" / PASCAL_VOC_FILES["mobilenetv2"]),
                   params, state)
    net = Deeplabv3(weights="pascal_voc", input_shape=(32, 32, 3),
                    alpha=0.35)
    X = (np.random.RandomState(2).rand(1, 32, 32, 3) * 255).astype(
        np.float32)
    want, _ = jnet.apply(params, state, jnp.asarray(X))
    np.testing.assert_allclose(net.apply(torch.from_numpy(X)).numpy(),
                               np.asarray(want), rtol=0, atol=1e-4)


def test_probability_losses_match_jax():
    r = np.random.RandomState(5)
    B, N, C = 2, 40, 4
    z = (r.randn(B, N, C) * 3).astype(np.float32)
    z[0, :5, 0] = 40.0                # saturated: the 1e-7 clip binds
    p = np.exp(z - z.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    Y = r.randint(0, C + 1, (B, N, 1)).astype(np.int32)   # C is void
    Y[0, :3, 0] = 1                   # the label the saturated rows miss
    sw = ((r.rand(B, N) > 0.3) * r.rand(B, N)).astype(np.float32)
    per = losses.sparse_crossentropy_ignoring_last_label(
        torch.from_numpy(Y), torch.from_numpy(p))
    jper = JL.sparse_crossentropy_ignoring_last_label(jnp.asarray(Y),
                                                      jnp.asarray(p))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-6,
                               atol=1e-6)
    assert (per.numpy()[Y[..., 0] == C] == 0).all()
    np.testing.assert_allclose(per.numpy()[0, :3], -np.log(np.float32(1e-7)),
                               rtol=1e-6)
    for w in (None, sw):
        pt = torch.from_numpy(p).requires_grad_()
        loss = losses.masked_sparse_ce(
            torch.from_numpy(Y), pt, None if w is None else
            torch.from_numpy(w))
        loss.backward()
        jloss, jg = jax.value_and_grad(lambda q: JL.masked_sparse_ce(
            jnp.asarray(Y), q, None if w is None else jnp.asarray(w)))(
                jnp.asarray(p))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6, atol=1e-6)


def _grads(net):
    return {layer: {var: to_keras_layout(var, p.grad)
                    for var, p in mod.named_parameters(recurse=False)}
            for layer, mod in net.named_children()}


def test_one_f32_train_step_matches_jax_trainer(monkeypatch):
    """The Trainer's path for a net without ``apply_logits`` (``apply``
    and ``masked_sparse_ce``) against JAX's (``trainer.py:165-186``)."""
    sz, n_cls, B = 64, 3, 2
    r = np.random.RandomState(4)
    X = (r.rand(B, sz, sz, 3) * 255).astype(np.float32)
    Y = r.randint(0, n_cls + 1, (B, sz * sz, 1)).astype(np.int32)
    SW = (0.5 + r.rand(B, sz * sz)).astype(np.float32)
    mask = r.rand(B, sz // 8, sz // 8, 256) < 0.9
    monkeypatch.setattr(JD, "dropout", lambda ctx, x, rate: jnp.where(
        jnp.asarray(mask), x / 0.9, 0.0).astype(x.dtype))
    tmask = torch.from_numpy(mask).permute(0, 3, 1, 2)
    monkeypatch.setattr(D, "dropout", lambda x, rate, gen, band=None:
                        torch.where(tmask, x / 0.9, 0.0).to(x.dtype))

    jnet, params, state, net = _pair(sz, n_cls, seed=1)
    assert not hasattr(jnet, "apply_logits")
    jt = JTrainer(jnet, mesh=get_mesh(jax.devices()[:1]), verbose=0)
    train_jit, _, tx = jt._build_steps(frozenset())
    copy = lambda t: jax.tree.map(jnp.array, t)
    _, _, _, jm = train_jit(copy(params), copy(state),
                            tx.init(copy(params)), jnp.float32(1.0),
                            jax.random.key(0), jnp.asarray(X),
                            jnp.asarray(Y), jnp.asarray(SW))

    def loss_fn(p):
        out, _ = jnet.apply(p, state, jnp.asarray(X), training=True,
                            rng=jax.random.key(0))
        return JL.masked_sparse_ce(jnp.asarray(Y), out, jnp.asarray(SW))
    direct = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))

    tr = Trainer(net, device="cpu", workers=0, verbose=0)
    tr.setup(net)
    assert not tr.fused
    m = tr.train_step(X, Y, SW)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    for k in ("Jaccard", "sparse_accuracy"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=1e-6)
    grads = _grads(net)
    gmax = max(np.abs(g).max() for t in direct.values() for g in t.values())
    for layer, vars_ in direct.items():
        for var, want in vars_.items():
            scale = max(np.abs(want).max(), 1e-3 * gmax)
            err = np.abs(grads[layer][var] - want).max()
            assert err <= 1e-3 * scale, (layer, var, err / scale)


def test_bf16_steps_run_the_phases_and_equal_the_logits_loss():
    """Under bf16 a Deeplabv3 step runs each training phase 14 times (the
    plain versions on the CPU) and no serving kernel; its first loss
    (probabilities, ``masked_sparse_ce``) equals a ``SegNet``'s with the
    same weights (logits, ``masked_sparse_ce_logits``) within 1e-4 (they
    differ by the 1e-7 clip and the rounding of the softmax); a short fit
    lowers it."""
    sz, n_cls, B = 64, 3, 2
    r = np.random.RandomState(6)
    X = (r.rand(B, sz, sz, 3) * 255).astype(np.float32)
    Y = r.randint(0, n_cls, (B, sz * sz, 1)).astype(np.int32)
    SW = np.ones((B, sz * sz), np.float32)
    net = Deeplabv3(input_shape=(sz, sz, 3), classes=n_cls, alpha=0.35,
                    seed=2)
    seg = SegNet((sz, sz), n_cls, alpha=0.35, seed=2)
    sd = {k.replace("custom_logits_semantic", "conv_upsample"): v
          for k, v in net.state_dict().items()}
    seg.load_state_dict(sd)
    losses_ = []
    for model in (net, seg):
        tr = Trainer(model, compute_dtype=torch.bfloat16, device="cpu",
                     workers=0, verbose=0, seed=3)
        tr.setup(model)
        before = FM.fused_mbconv.launches
        with FMT.plain_versions() as calls:
            m = tr.train_step(X, Y, SW)
        assert all(len(calls[n]) == 14 for n in FMT.PHASES)
        assert FM.fused_mbconv.launches == before
        losses_.append(m["loss"].item())
    assert abs(losses_[0] - losses_[1]) <= 1e-4 * abs(losses_[1]), losses_

    from deeplab_tpu_torch.data.generator import ArrayBatcher
    fresh = Deeplabv3(input_shape=(sz, sz, 3), classes=n_cls, alpha=0.35,
                      seed=2)
    hist = Trainer(fresh, epochs=3, compute_dtype=torch.bfloat16,
                   device="cpu", workers=0, verbose=0).fit(
        fresh, ArrayBatcher(X, Y, B, n_classes=n_cls))
    assert hist["loss"][-1] < hist["loss"][0], hist["loss"]
    probs = Trainer(fresh, device="cpu", verbose=0).predict(X, batch_size=1)
    assert probs.shape == (B, sz * sz, n_cls)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
