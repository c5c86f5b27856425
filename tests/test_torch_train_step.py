"""The port's training path against the JAX package's, on the CPU: training
BatchNorm, relu6's derivative, the losses and metrics, Keras Adam, the freeze
policy and layer order, the fused-block gate, and one whole f32 train step
of the Trainer against the JAX Trainer's ``train_step``.

Tolerances: f32 everywhere; elementwise ops and reductions differ only in
summation order (1e-5 relative).  The whole step goes through ~60 layers
forward and backward: loss 1e-5 relative; each gradient within 1e-3 of its
largest magnitude against ``jax.grad`` of the same loss (measured: 2e-4 in
the trunk).  The gradient inside the Trainer's jitted step (Adam's first
moment over 1 - b1) is no sharper reference: it differs from ``jax.grad`` by
up to 4.5e-2 of a tensor's largest value in the deep dilated depthwise
layers, where BN over 2x8x8 values amplifies rounding.  Each bound has a
floor of 1e-3 of the
network's largest gradient, because the project BNs' beta gradients are zero
in exact arithmetic (the next BN removes a constant shift) and hold rounding
noise of 1e-8..1e-6; BN statistics 1e-4.  One Adam step moves each parameter
by about ``lr * sign(grad)``: updated parameters are held to the Trainer's
within 1e-6 where the gradient is at least 0.1 of that scale (its sign is
not in doubt), and elsewhere within 2 lr.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from deeplab_tpu import core as jcore
from deeplab_tpu import losses as JL
from deeplab_tpu import metrics as JM
from deeplab_tpu.models import deeplabv3p as JD
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.ops.bn import batch_norm as jbatch_norm
from deeplab_tpu.ops.conv import relu6 as jrelu6
from deeplab_tpu.parallel.mesh import get_mesh
from deeplab_tpu.train import optimizer as JO
from deeplab_tpu.train.trainer import Trainer as JTrainer

from deeplab_tpu_torch import core, losses, metrics
from deeplab_tpu_torch.models import deeplabv3p as D
from deeplab_tpu_torch.models import mobilenetv2 as M
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.ops.bn import BatchNorm
from deeplab_tpu_torch.ops.conv import relu6
from deeplab_tpu_torch.params import (params_from_jax, to_keras_layout,
                                      trees_from_net)
from deeplab_tpu_torch.train import Trainer, optimizer as O


@pytest.mark.parametrize("momentum,frozen", [(0.999, False), (0.99, False),
                                             (0.999, True)])
def test_training_batchnorm_matches_jax(momentum, frozen):
    r = np.random.RandomState(0)
    x = (r.randn(2, 6, 5, 7) * 2 + 1).astype(np.float32)
    gamma, beta = 1 + 0.1 * r.randn(7), 0.1 * r.randn(7)
    mm, mv = r.rand(7), 0.5 + r.rand(7)
    f = lambda a: np.asarray(a, np.float32)
    params = {"bn": {"gamma": jnp.asarray(f(gamma)),
                     "beta": jnp.asarray(f(beta))}}
    state = {"bn": {"moving_mean": jnp.asarray(f(mm)),
                    "moving_variance": jnp.asarray(f(mv))}}
    cot = r.randn(2, 6, 5, 7).astype(np.float32)

    def jfn(p, xx):
        ctx = jcore.Ctx(mode="apply", params=p, state=state, training=True,
                        frozen=frozenset({"bn"}) if frozen else frozenset())
        out = jbatch_norm(ctx, xx, "bn", epsilon=1e-3, momentum=momentum)
        return out, ctx.new_state
    jout, jstate = jfn(params, jnp.asarray(x))
    jg = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx)[0] * cot),
                  argnums=(0, 1))(params, jnp.asarray(x))

    bn = BatchNorm(7, 1e-3, momentum=momentum).train()
    bn.frozen = frozen   # as the Trainer freezes: no grad, moving statistics
    for p in bn.parameters():
        p.requires_grad_(not frozen)
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(f(gamma)))
        bn.beta.copy_(torch.from_numpy(f(beta)))
        bn.moving_mean.copy_(torch.from_numpy(f(mm)))
        bn.moving_variance.copy_(torch.from_numpy(f(mv)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = bn(xt)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(jout), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg[1]), **tol)
    for var in ("gamma", "beta"):
        want = np.asarray(jg[0]["bn"][var])
        got = getattr(bn, var).grad
        if frozen:
            assert got is None and not want.any()
        else:
            np.testing.assert_allclose(got.numpy(), want, **tol)
    want_state = jstate.get("bn", state["bn"])
    np.testing.assert_allclose(bn.moving_mean.numpy(),
                               np.asarray(want_state["moving_mean"]), **tol)
    np.testing.assert_allclose(bn.moving_variance.numpy(),
                               np.asarray(want_state["moving_variance"]),
                               **tol)
    if frozen:
        np.testing.assert_array_equal(bn.moving_mean.numpy(), f(mm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu6_derivative_matches_jax_at_the_ties(dtype):
    v = np.array([-1.0, 0.0, 0.5, 5.5, 6.0, 7.0], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jrelu6(a).astype(jnp.float32)))(
        jnp.asarray(v).astype(dtype))
    t = torch.from_numpy(v).to(getattr(torch, dtype)).requires_grad_()
    out = relu6(t)
    out.float().sum().backward()
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  np.asarray(jg).astype(np.float32))
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  [0, 0, 1, 1, 0.5, 0])
    assert out.dtype == t.dtype


def test_dropout_keeps_and_scales_from_the_generator():
    x = torch.ones(4, 256, 8, 8)
    a = D.dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = D.dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    np.testing.assert_allclose(a[a != 0].numpy(), 1 / 0.9, rtol=1e-6)


def test_losses_match_jax():
    r = np.random.RandomState(1)
    logits = (r.randn(2, 5, 6, 4) * 3).astype(np.float32)
    labels = r.randint(0, 5, (2, 5, 6)).astype(np.int32)   # 4 is void
    sw = (r.rand(2, 5, 6) > 0.3).astype(np.float32) * r.rand(2, 5, 6)
    per = losses.sparse_logits_crossentropy_ignoring_last_label(
        torch.from_numpy(labels), torch.from_numpy(logits))
    jper = JL.sparse_logits_crossentropy_ignoring_last_label(
        jnp.asarray(labels), jnp.asarray(logits))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-5,
                               atol=1e-6)
    assert (per.numpy()[labels == 4] == 0).all()
    got = losses.weighted_loss(per, torch.from_numpy(sw))
    np.testing.assert_allclose(got.item(), float(JL.weighted_loss(
        jper, jnp.asarray(sw))), rtol=1e-6)

    lt = torch.from_numpy(logits).requires_grad_()
    loss = losses.masked_sparse_ce_logits(torch.from_numpy(labels[..., None]),
                                          lt, torch.from_numpy(sw))
    loss.backward()
    jloss, jg = jax.value_and_grad(lambda z: JL.masked_sparse_ce_logits(
        jnp.asarray(labels[..., None]), z, jnp.asarray(sw)))(
            jnp.asarray(logits))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        losses.masked_sparse_ce_logits(torch.from_numpy(labels),
                                       torch.from_numpy(logits)).item(),
        float(JL.masked_sparse_ce_logits(jnp.asarray(labels),
                                         jnp.asarray(logits))), rtol=1e-6)


def test_metrics_match_jax():
    r = np.random.RandomState(2)
    labels = r.randint(0, 4, (3, 50))          # 3 is void, class 2 absent
    labels[labels == 2] = 0
    pred = r.randint(0, 3, (3, 50))
    L, P = torch.from_numpy(labels), torch.from_numpy(pred)
    jl, jp = jnp.asarray(labels), jnp.asarray(pred)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-6)
    close(metrics.accuracy_from_ids(L, P, 3), JM.accuracy_from_ids(jl, jp, 3))
    for a, b in zip(metrics.accuracy_sums_from_ids(L, P, 3),
                    JM.accuracy_sums_from_ids(jl, jp, 3)):
        close(a, b)
    for a, b in zip(metrics.jaccard_sums_from_ids(L, P, 3),
                    JM.jaccard_sums_from_ids(jl, jp, 3)):
        close(a, b)
    close(metrics.jaccard_from_ids(L, P, 3), JM.jaccard_from_ids(jl, jp, 3))
    s, n = metrics.jaccard_sums_from_ids(L, P, 3)
    close(metrics.jaccard_from_sums(s, n),
          JM.jaccard_from_sums(jnp.asarray(s.numpy()),
                               jnp.asarray(n.numpy())))


def test_two_keras_adam_steps_match_optax_with_lr_scale_and_decay():
    r = np.random.RandomState(3)
    w0 = r.randn(5, 3).astype(np.float32)
    grads = [r.randn(5, 3).astype(np.float32) for _ in range(2)]
    scales = [1.0, 0.5]
    tx = JO.make_optimizer(lr=1e-2, epsilon=1e-8, decay=0.1)
    jp = {"w": jnp.asarray(w0)}
    st = tx.init(jp)
    for g, s in zip(grads, scales):
        upd, st = tx.update({"w": jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * s, upd))

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = O.KerasAdam([w], lr=1e-2, epsilon=1e-8, decay=0.1)
    for g, s in zip(grads, scales):
        opt.zero_grad()
        w.grad = torch.from_numpy(g)
        opt.step(s)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    assert opt.count == 2


@pytest.fixture(scope="module")
def jax_net32():
    net = JSegNet((32, 32), 3, "mobilenetv2", "original", alpha=0.35)
    params, state = net.init(jax.random.key(0))
    return net, params, state


def test_layer_order_and_freeze_set_match_jax(jax_net32):
    jnet, params, _ = jax_net32
    net = SegNet((32, 32), 3, alpha=0.35)
    assert net.layer_order == jnet.layer_order
    for anchor in ("concat_projection", "expanded_conv_7_expand", None):
        assert (O.freeze_set(net.layer_order, anchor, order=net.layer_order)
                == JO.freeze_set(params, anchor, order=jnet.layer_order))
    with pytest.raises(ValueError):
        O.freeze_set(net.layer_order, "no_such_layer")


def test_training_gate_engages_on_14_blocks_under_bf16_only():
    net = SegNet((64, 64), 3, alpha=0.35).train()
    x = torch.zeros(1, 8, 16, 16)
    bf16, f32 = (core.resolve_compute_dtype(d) for d in ("bfloat16",
                                                         "float32"))
    count = lambda pol: sum(
        M.FMT.use_fused_train_block(net, x, pol, s, b, M._prefix(b))
        for _, s, _, b, _, _ in M.BLOCK_TABLE)
    assert count(bf16) == 14
    assert count(f32) == 0
    net.expanded_conv_5_depthwise_BN.frozen = True
    assert count(bf16) == 13
    net.eval()
    assert count(bf16) == 0
    assert not M.FMT.use_fused_train_block(
        net.train(), torch.zeros(1, 8, 12, 12), bf16, 1, 4, M._prefix(4))


def _grads(net):
    """Each parameter's gradient as a Keras-layout tree."""
    return {layer: {var: to_keras_layout(var, p.grad)
                    for var, p in mod.named_parameters(recurse=False)}
            for layer, mod in net.named_children()}


def _step_data(sz, n_cls, B=2, seed=4):
    r = np.random.RandomState(seed)
    X = (r.rand(B, sz, sz, 3) * 255).astype(np.float32)
    Y = r.randint(0, n_cls + 1, (B, sz * sz, 1)).astype(np.int32)
    SW = (0.5 + r.rand(B, sz * sz)).astype(np.float32)
    mask = r.rand(B, sz // 8, sz // 8, 256) < 0.9
    return X, Y, SW, mask


def test_one_f32_train_step_matches_jax_trainer(monkeypatch):
    """Loss, every gradient, the BN moving statistics and the updated params
    after one f32 step at 64x64, B=2, 3 classes, against the JAX Trainer's
    jitted train_step on the same weights, batch and dropout mask; the
    gradients against ``jax.grad`` of the same loss."""
    sz, n_cls, alpha = 64, 3, 0.35
    X, Y, SW, mask = _step_data(sz, n_cls)
    monkeypatch.setattr(JD, "dropout", lambda ctx, x, rate: jnp.where(
        jnp.asarray(mask), x / 0.9, 0.0).astype(x.dtype))
    tmask = torch.from_numpy(mask).permute(0, 3, 1, 2)
    monkeypatch.setattr(D, "dropout", lambda x, rate, gen, band=None:
                        torch.where(tmask, x / 0.9, 0.0).to(x.dtype))

    jnet = JSegNet((sz, sz), n_cls, "mobilenetv2", "original", alpha=alpha)
    params, state = jnet.init(jax.random.key(1))
    np_params = jax.tree.map(np.asarray, params)
    np_state = jax.tree.map(np.asarray, state)
    jt = JTrainer(jnet, mesh=get_mesh(jax.devices()[:1]), verbose=0)
    train_jit, _, tx = jt._build_steps(frozenset())
    copy = lambda t: jax.tree.map(jnp.array, t)
    p1, s1, o1, jm = train_jit(copy(params), copy(state),
                               tx.init(copy(params)), jnp.float32(1.0),
                               jax.random.key(0), jnp.asarray(X),
                               jnp.asarray(Y), jnp.asarray(SW))
    def loss_fn(p):
        out, _ = jnet.apply_logits(p, state, jnp.asarray(X), training=True,
                                   rng=jax.random.key(0))
        return JL.masked_sparse_ce_logits(
            jnp.asarray(Y)[..., 0].reshape(2, sz, sz), out,
            jnp.asarray(SW).reshape(2, sz, sz))
    direct = jax.jit(jax.grad(loss_fn))(params)

    net = params_from_jax(SegNet((sz, sz), n_cls, alpha=alpha), np_params,
                          np_state)
    tr = Trainer(net, device="cpu", workers=0, verbose=0)
    tr.setup(net)
    m = tr.train_step(X, Y, SW)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    for k in ("Jaccard", "sparse_accuracy"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=1e-6)

    grads = _grads(net)
    new_params, new_state = trees_from_net(net)
    lr = tr.base_lr
    direct = jax.tree.map(np.asarray, direct)
    gmax = max(np.abs(g).max() for t in direct.values() for g in t.values())
    for layer in np_params:
        for var, want in direct[layer].items():
            scale = max(np.abs(want).max(), 1e-3 * gmax)
            err = np.abs(grads[layer][var] - want).max()
            assert err <= 1e-3 * scale, (layer, var, err / scale)
            diff = np.abs(new_params[layer][var] - np.asarray(p1[layer][var]))
            assert diff.max() <= 2 * lr, (layer, var)
            sure = np.abs(want) >= 0.1 * scale      # a sign both sides share
            assert diff[sure].max(initial=0) <= 1e-6, (layer, var)
    for layer, vars_ in s1.items():
        for var, want in vars_.items():
            np.testing.assert_allclose(new_state[layer][var],
                                       np.asarray(want), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{layer}/{var}")


def test_bf16_step_through_the_block_kernels_tracks_float32():
    """A bf16 step at 64x64 with the 14 blocks on the phase kernels' plain
    versions (on the CPU; each phase runs 14 times) strays from the float32
    step no further than the same step through the plain bf16 layer
    composition does: in the loss, within 1e-2 of it, and in the gradients'
    global norm-relative error, within 1.25x (measured: loss 0.9427 against
    0.9698 and f32 0.9352; gradients 1.28 against 1.76 -- a seeded net at
    this size, with BN over 2x8x8 values, is far from its trained regime)."""
    from deeplab_tpu_torch.kernels import fused_mbconv_train as FMT
    X, Y, SW, _ = _step_data(64, 3)
    out = {}
    for name, fuse, dt in (("kernels", True, torch.bfloat16),
                           ("composition", False, torch.bfloat16),
                           ("f32", False, torch.float32)):
        net = SegNet((64, 64), 3, alpha=0.35, seed=2, fuse_blocks=fuse)
        tr = Trainer(net, compute_dtype=dt, device="cpu", workers=0,
                     verbose=0)
        tr.setup(net)
        with FMT.plain_versions() as calls:
            m = tr.train_step(X, Y, SW)
        want = 14 if name == "kernels" else 0
        assert all(len(calls[n]) == want for n in FMT.PHASES), name
        out[name] = (m["loss"].item(), _grads(net))

    def rel(a, b):
        num = sum(np.sum((a[l][v] - b[l][v]) ** 2) for l in b for v in b[l])
        return np.sqrt(num / sum(np.sum(b[l][v] ** 2)
                                 for l in b for v in b[l]))
    (lk, gk), (lc, gc), (l32, g32) = (out[n] for n in ("kernels",
                                                       "composition", "f32"))
    assert np.isfinite(lk)
    assert abs(lk - l32) <= abs(lc - l32) + 1e-2 * l32, (lk, lc, l32)
    assert rel(gk, g32) <= 1.25 * rel(gc, g32), (rel(gk, g32), rel(gc, g32))
