"""The training half of the subpixel head: one f32 train step of the port's
``Trainer`` on the CPU against the JAX ``Trainer``'s jitted ``train_step``,
MobileNetV2 (width 0.35) with the 'subpixel' head, 64x64, B=2, on the JAX
net's own seeded weights, the same batch and the same dropout mask
(tests/test_torch_train_xception.py's helpers).

Tolerances, tests/test_torch_train_step.py's, reasoned there: loss 1e-5
relative; each gradient within 1e-3 of its largest magnitude against
``jax.grad`` of the same loss, floored at 1e-3 of the network's largest
gradient; BN moving statistics 1e-4; each updated parameter within 1e-6 of
the JAX step's where the gradient's sign is not in doubt, elsewhere within
2 lr.  (At 32x32 the JAX f32 gradients themselves stray from their float64
values by up to 3.8e-3 of a parameter's scale: BN over 2x4x4 values.)
"""

import numpy as np
import jax
import jax.numpy as jnp

from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.parallel.mesh import get_mesh
from deeplab_tpu.train.trainer import Trainer as JTrainer

from deeplab_tpu_torch.params import trees_from_net

from test_torch_train_xception import (N_CLS, _batch, _grads, _jax_loss_fn,
                                       _one_thread, _port_step)  # noqa: F401


def test_subpixel_step_matches_jax_trainer(monkeypatch):
    sz, B, kw = 64, 2, dict(alpha=0.35)
    X, Y, SW = _batch(sz, B, 8, monkeypatch)
    jnet = JSegNet((sz, sz), N_CLS, "mobilenetv2", "subpixel", **kw)
    params, state = jnet.init(jax.random.key(1))
    jt = JTrainer(jnet, mesh=get_mesh(jax.devices()[:1]), verbose=0)
    train_jit, _, tx = jt._build_steps(frozenset())
    copy = lambda t: jax.tree.map(jnp.array, t)
    p1, s1, _, jm = train_jit(copy(params), copy(state),
                              tx.init(copy(params)), jnp.float32(1.0),
                              jax.random.key(0), jnp.asarray(X),
                              jnp.asarray(Y), jnp.asarray(SW))
    direct = jax.tree.map(np.asarray, jax.jit(jax.grad(
        _jax_loss_fn(jnet, state, X, Y, SW, jnp.float32),
        has_aux=True))(params)[0])

    net, tr, m = _port_step(monkeypatch, sz, "mobilenetv2", "subpixel", kw,
                            params, state, X, Y, SW)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    for k in ("Jaccard", "sparse_accuracy"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=1e-6)
    grads = _grads(net)
    new_params, new_state = trees_from_net(net)
    lr = tr.base_lr
    gmax = max(np.abs(g).max() for t in direct.values() for g in t.values())
    for layer in direct:
        for var, want in direct[layer].items():
            scale = max(np.abs(want).max(), 1e-3 * gmax)
            err = np.abs(grads[layer][var] - want).max()
            assert err <= 1e-3 * scale, (layer, var, err / scale)
            diff = np.abs(new_params[layer][var] - np.asarray(p1[layer][var]))
            assert diff.max() <= 2 * lr, (layer, var)
            sure = np.abs(want) >= 0.1 * scale
            assert diff[sure].max(initial=0) <= 1e-6, (layer, var)
    for layer, vars_ in s1.items():
        for var, want in vars_.items():
            np.testing.assert_allclose(new_state[layer][var],
                                       np.asarray(want), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{layer}/{var}")
