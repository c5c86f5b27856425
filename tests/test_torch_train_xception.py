"""The training half of the Xception and subpixel nets: one f32 train step of
the port's ``Trainer`` on the CPU against the JAX package, on the JAX net's
own seeded weights, the same batch and the same dropout mask (drawn once
with numpy and patched into both packages' dropout).  Training never takes
``fused_sepconv`` (eval-only): the SepConvs train through the plain
composition, as in JAX.

The subpixel head's step is in tests/test_torch_train_subpixel.py (a file
of its own, so that the two JAX compilations run on two test workers).

Xception at output stride 16 with the 'original' head, full width, 32x32,
B=4.  A seeded Xception in f32 is ill-conditioned at any size a CPU test
can afford: ReLU'd inputs leave channels nearly constant on 2x2 maps and
batch-statistic BN amplifies their rounding, layer after layer.  The JAX
``Trainer``'s own f32 gradients stray from the exact (float64) ones by a
median 2.9% of a parameter's scale, 4.0% at the 90th percentile and 37% at
worst (measured, this batch; 1.7-5% at 64x64 and B=2): no 1e-3 comparison
of two f32 implementations holds.  So the yardstick is the JAX net's
forward and backward in float64 (compiled once): the port's f32 loss within
1e-5 of it, the BN moving statistics within 1e-4 (1e-5 absolute), and its
gradients' error statistics over the parameters (median, 90th percentile,
worst, relative to each parameter's scale with the floor above) no larger
than the JAX f32 gradients' measured ones (the port measured 1.8%, 2.5%
and 17%).  ROADMAP C5 records this.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplab_tpu import losses as JL
from deeplab_tpu.models import deeplabv3p as JD
from deeplab_tpu.models.seg_model import SegNet as JSegNet

from deeplab_tpu_torch.kernels import fused_mbconv as FM
from deeplab_tpu_torch.models import deeplabv3p as D
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import (params_from_jax, to_keras_layout,
                                      trees_from_net)
from deeplab_tpu_torch.train import Trainer

N_CLS = 3
# the JAX f32 step's gradient error against float64 on the Xception case
# (median, 90th percentile, worst), the bound for the port's
XCEPTION_JAX_F32_ERR = (0.029, 0.040, 0.37)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small steps: the suite's test workers
    share the cores, and torch's thread pools oversubscribed spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(sz, B, stride, monkeypatch):
    r = np.random.RandomState(4)
    X = (r.rand(B, sz, sz, 3) * 255).astype(np.float32)
    Y = r.randint(0, N_CLS + 1, (B, sz * sz, 1)).astype(np.int32)
    SW = (0.5 + r.rand(B, sz * sz)).astype(np.float32)
    mask = r.rand(B, sz // stride, sz // stride, 256) < 0.9
    monkeypatch.setattr(JD, "dropout", lambda ctx, x, rate: jnp.where(
        jnp.asarray(mask), x / 0.9, 0.0).astype(x.dtype) if ctx.training
        else x)
    tmask = torch.from_numpy(mask).permute(0, 3, 1, 2)
    monkeypatch.setattr(D, "dropout", lambda x, rate, gen, band=None:
                        torch.where(tmask, x / 0.9, 0.0).to(x.dtype))
    return X, Y, SW


def _port_step(monkeypatch, sz, backbone, head, kw, params, state, X, Y,
               SW):
    """One port f32 step from the JAX trees; returns the net and the step
    metrics, with no ``fused_sepconv`` call."""
    net = params_from_jax(SegNet((sz, sz), N_CLS, backbone, head, **kw),
                          jax.tree.map(np.asarray, params),
                          jax.tree.map(np.asarray, state))
    tr = Trainer(net, device="cpu", workers=0, verbose=0)
    tr.setup(net)
    calls = []
    monkeypatch.setattr(FM, "fused_sepconv_reference",
                        lambda *a, **k: calls.append(1))
    m = tr.train_step(X, Y, SW)
    assert not calls            # training never takes the eval-only kernel
    return net, tr, m


def _grads(net):
    return {layer: {var: to_keras_layout(var, p.grad)
                    for var, p in mod.named_parameters(recurse=False)}
            for layer, mod in net.named_children()}


def _jax_loss_fn(jnet, state, X, Y, SW, dt):
    B, sz = X.shape[0], X.shape[1]

    def loss_fn(p):
        s = jax.tree.map(lambda a: a.astype(dt), state)
        out, new_state = jnet.apply_logits(
            p, s, jnp.asarray(X, dt), training=True, rng=jax.random.key(0),
            compute_dtype=dt)
        loss = JL.masked_sparse_ce_logits(
            jnp.asarray(Y)[..., 0].reshape(B, sz, sz), out.astype(dt),
            jnp.asarray(SW, dt).reshape(B, sz, sz))
        return loss, new_state
    return loss_fn


def test_xception_step_matches_jax_float64(monkeypatch):
    sz, B, kw = 32, 4, dict(OS=16)
    X, Y, SW = _batch(sz, B, 16, monkeypatch)
    jnet = JSegNet((sz, sz), N_CLS, "xception", "original", **kw)
    params, state = jnet.init(jax.random.key(1))
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        (loss64, state64), g64 = jax.jit(jax.value_and_grad(
            _jax_loss_fn(jnet, state, X, Y, SW, jnp.float64),
            has_aux=True))(p64)
        loss64 = float(loss64)
        g64 = jax.tree.map(lambda a: np.asarray(a, np.float64), g64)
        state64 = jax.tree.map(lambda a: np.asarray(a, np.float64), state64)

    net, _, m = _port_step(monkeypatch, sz, "xception", "original", kw,
                           params, state, X, Y, SW)
    np.testing.assert_allclose(m["loss"].item(), loss64, rtol=1e-5)
    grads = _grads(net)
    gmax = max(np.abs(g).max() for t in g64.values() for g in t.values())
    errs = []
    for layer in g64:
        for var, want in g64[layer].items():
            scale = max(np.abs(want).max(), 1e-3 * gmax)
            errs.append(np.abs(grads[layer][var] - want).max() / scale)
    got = (np.median(errs), np.percentile(errs, 90), max(errs))
    assert all(g <= b for g, b in zip(got, XCEPTION_JAX_F32_ERR)), got
    _, new_state = trees_from_net(net)
    for layer, vars_ in state64.items():
        for var, want in vars_.items():
            np.testing.assert_allclose(new_state[layer][var], want,
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{layer}/{var}")
