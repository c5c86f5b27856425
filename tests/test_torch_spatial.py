"""Spatial (height) sharding on the CPU: one spawned gloo group of 4
processes, data 2 x space 2 (tests/torch_spatial_workers.py, no JAX), runs
every check in one start, on one torch thread each, while this process
computes the references: JAX's spatial step and Predictor on a 2 x 2 mesh
of the 8 CPU devices the conftest gives it, and the one-process port.

- (a) The halo exchange alone: a band conv against the whole-map conv,
  forward and the input's gradient (f32, within 1e-6 of each one's largest
  magnitude), at kernel 1 and 3, stride 1 and 2, rate 1/2/4/6, SAME and
  the fixed pads, depthwise and full, an uneven last band (72 and 75
  rows), and halos deeper than a band (rate 6 on 4- and 2-row bands), on
  the 2 x 2 mesh and on a 1 x 4 one (rows from up to three neighbours).
- (b) One f32 ``Trainer(mesh, spatial=True)`` step at 64x64 against JAX's
  ``Trainer(mesh=get_mesh(jax.devices()[:4], data=2, space=2),
  spatial=True)`` step, on the same weights, global batch of 4 and
  injected dropout mask: the loss within 1e-5; the metrics those of the
  step's own logits' argmax, which equals the one-process port's wherever
  the top two logits are more than 1e-4 of the scale apart (a near tie may
  flip, and one pixel moves the metrics by ~1e-4), whose metrics are
  JAX's within 1e-5; the gradient within ``GRAD_REL`` of its norm
  against the one-process port's on the whole batch, the updated weights
  and BN buffers within tests/test_torch_train_step.py's bounds (JAX's
  after its step); the four processes hold the
  same weights bit for bit; the image pool's BN normalizes each image once
  (over the data axis).  At 72x64 (uneven bands) the same step against the
  one-process port's.
- (c) ``Predictor(mesh, spatial=True, crf=CrfConfig(backend="pallas"),
  return_raw=True)`` against JAX's spatial Predictor on a 2 x 2 mesh: raw
  labels equal, refined masks >= 0.995; ``Trainer.predict`` against the
  one-process port.
- (d) The port's spatial logits against its one-process logits within
  1e-5 of their scale (f32); under "mixed" the serving kernels' plain
  versions run on halo-extended bands (14 + 1 calls a band forward, heights
  a multiple of 8 for ``fused_mbconv``) within 1e-3, on the 2 x 2 mesh and
  on the 1 x 4 one, whose inner bands are thinner than the rate-4 halo
  (the extension stops at the image's edges, where the kernels' own zero
  padding acts).
- (e) Xception OS 16 at 64x64: the ASPP's rates 6/12/18 on 2-row bands
  (halos deeper than a band), f32 and "mixed" (65 ``fused_sepconv``
  calls), "mixed" also on 1-row bands (1 x 4).
- A spatial step whose space processes hold different images raises.
- (f) 72x64 and 75x64 images (uneven bands, a height that is not a
  multiple of 8).
- The 'subpixel' head (its phase shift local to a band) and the
  reference's ``Deeplabv3`` (its head's resize to the whole image's
  height) against one process.
"""

import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as tmp_mp

from deeplab_tpu.crf import CrfConfig as JCrfConfig
from deeplab_tpu.models import deeplabv3p as JD
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.parallel.mesh import get_mesh as jget_mesh
from deeplab_tpu.predictor import Predictor as JPredictor
from deeplab_tpu.train.trainer import Trainer as JTrainer

from deeplab_tpu_torch import metrics as M
from deeplab_tpu_torch.models import deeplabv3p as D
from deeplab_tpu_torch.params import to_keras_layout
from deeplab_tpu_torch.train import Trainer

import torch_spatial_workers as W

SZ, N_CLS, ALPHA, B = 64, 3, 0.35, 4
LR = 7e-4
WORLD = 4
# the all-reduced gradient against the one-process port's, relative to
# each tensor's norm (tests/test_torch_parallel.py's bound for its SPMD
# step, there of the largest element).  BN statistics summed in another
# order move the forward by ~1e-7, which can flip a relu or relu6 whose
# input sits at its boundary: that changes one channel's gradient at one
# position, up to 2.5e-2 of the tensor's largest element (measured, block
# 12's expand BN beta at 64x64, its other channels within 8e-4) but
# 6.7e-3 of its norm
GRAD_REL = 1e-2
# the training forward's logits, spatial against one-process (BN's batch
# statistics summed in another order), relative to the largest; the
# argmax must agree wherever the top two logits are further apart than
# TIE_REL of it (tests/test_torch_tta.py's rule: a near tie may flip, and
# one flipped pixel moves the metrics by ~1e-4)
TRAIN_LOGIT_REL, TIE_REL = 1e-4, 1e-4
# (name, conv kind, k, stride, rate, image rows, unit, map stride)
EXCHANGE_CASES = [
    ("1x1", "same", 1, 1, 1, 64, 8, 4),
    ("3x3", "same", 3, 1, 1, 64, 8, 2),
    ("3x3 stride 2", "same", 3, 2, 1, 64, 8, 1),
    ("dw rate 2", "depthwise", 3, 1, 2, 64, 8, 8),
    ("dw rate 4", "depthwise", 3, 1, 4, 64, 8, 8),
    ("3x3 rate 6, deeper than a band", "same", 3, 1, 6, 64, 8, 8),
    ("dw stride 2 fixed pads", "depthwise", 3, 2, 1, 64, 16, 4),
    ("3x3 stride 2 fixed pads", "fixed", 3, 2, 1, 64, 16, 1),
    ("1x1 stride 2 fixed pads", "fixed", 1, 2, 1, 64, 16, 2),
    ("uneven 72, dw rate 2", "depthwise", 3, 1, 2, 72, 8, 4),
    ("uneven 72, stride 2", "same", 3, 2, 1, 72, 8, 2),
    ("75 rows, stride 2", "same", 3, 2, 1, 75, 8, 1),
    ("75 rows, rate 6", "same", 3, 1, 6, 75, 8, 8),
]
MESHES = ("2x2", "1x4")
STEP_SIZES = ((SZ, SZ), (72, SZ))
# (image size, backbone, policy, mesh) of the logits checks (d), (e), (f);
# on the 1 x 4 mesh the inner bands are thinner than some halos (2 rows at
# stride 8 against rate 4; 1 row at stride 16 against rate 18); "bn":
# seeded BN statistics, under which a kernel's output on rows of zeros
# differs from its zero padding
LOGIT_CASES = {
    "64 f32": ((SZ, SZ), "mobilenetv2", "float32", "2x2"),
    "64 mixed": ((SZ, SZ), "mobilenetv2", "mixed", "2x2"),
    "64 mixed bn": ((SZ, SZ), "mobilenetv2 bn", "mixed", "2x2"),
    "64 mixed bn 1x4": ((SZ, SZ), "mobilenetv2 bn", "mixed", "1x4"),
    "72 f32": ((72, SZ), "mobilenetv2", "float32", "2x2"),
    "75 f32": ((75, SZ), "mobilenetv2", "float32", "2x2"),
    "xception f32": ((SZ, SZ), "xception", "float32", "2x2"),
    "xception mixed": ((SZ, SZ), "xception", "mixed", "2x2"),
    "xception mixed 1x4": ((SZ, SZ), "xception", "mixed", "1x4"),
    "subpixel f32": ((SZ, SZ), "subpixel", "float32", "2x2"),
    "deeplabv3 f32": ((72, SZ), "deeplabv3", "float32", "2x2"),
}
SPACE = {"2x2": 2, "1x4": 4}
# spatial against one-process logits, relative to the largest logit:
# f32 differs by summation order (the image pool's sums, the resize's
# products); under "mixed" the kernels' plain versions round their
# operands to bf16 on either side, and one flipped rounding carries
LOGIT_REL = {"float32": 1e-5, "mixed": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: six test workers' thread pools would oversubscribe
    the cores (the spawned processes set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(r, size):
    h, w = size
    X = (r.rand(B, h, w, 3) * 255).astype(np.float32)
    Y = r.randint(0, N_CLS + 1, (B, h * w, 1)).astype(np.int32)
    SW = (0.5 + r.rand(B, h * w)).astype(np.float32)
    mask = r.rand(B, -(-h // 8), w // 8, 256) < 0.9
    return X, Y, SW, mask


def _jax_step(jnet, params, state, cfg):
    """JAX's spatial train step on a 2 x 2 mesh of 4 devices."""
    mask = jnp.asarray(cfg["mask"][(SZ, SZ)])
    saved = JD.dropout
    JD.dropout = lambda ctx, x, rate: jnp.where(mask, x / 0.9, 0.0).astype(
        x.dtype)
    try:
        jt = JTrainer(jnet, mesh=jget_mesh(jax.devices()[:4], data=2,
                                           space=2),
                      spatial=True, verbose=0)
        train_jit, _, tx = jt._build_steps(frozenset())
        copy = lambda t: jax.tree.map(jnp.array, t)
        p1, s1, _, jm = train_jit(
            copy(params), copy(state), tx.init(copy(params)),
            jnp.float32(1.0), jax.random.key(0),
            *(jnp.asarray(cfg[k][(SZ, SZ)]) for k in ("X", "Y", "SW")))
    finally:
        JD.dropout = saved
    return (jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1),
            {k: float(v) for k, v in jm.items()})


def _port_step(cfg, size):
    """The one-process port's step on the whole batch (the same injected
    dropout mask): loss, gradients, weights and BN buffers."""
    from deeplab_tpu_torch.params import trees_from_net
    tmask = torch.from_numpy(cfg["mask"][size]).permute(0, 3, 1, 2)
    saved = D.dropout
    D.dropout = lambda x, rate, gen, band=None: torch.where(
        tmask, x / 0.9, 0.0).to(x.dtype)
    try:
        net = W.net_for(cfg, size).train()
        tr = Trainer(net, device="cpu", verbose=0)
        tr.setup(net)
        outs = []
        apply_logits = net.apply_logits
        net.apply_logits = lambda *a, **k: outs.append(apply_logits(
            *a, **k)) or outs[-1]
        m = tr.train_step(*(cfg[k][size] for k in ("X", "Y", "SW")))
    finally:
        D.dropout = saved
    grads = {layer: {var: to_keras_layout(var, p.grad)
                     for var, p in mod.named_parameters(recurse=False)}
             for layer, mod in net.named_children()}
    params, state = trees_from_net(net)
    return ({k: float(v) for k, v in m.items()}, grads, params, state,
            outs[0].detach().numpy())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The four processes' results, and the references computed while
    they run."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    r = np.random.RandomState(17)
    jnet = JSegNet((SZ, SZ), N_CLS, "mobilenetv2", "original", alpha=ALPHA)
    params, state = jnet.init(jax.random.key(2))
    cfg = {"sz": SZ, "n_cls": N_CLS, "alpha": ALPHA, "tmp": tmp,
           "xc_seed": 5, "exchange_cases": EXCHANGE_CASES,
           "logit_cases": LOGIT_CASES, "step_sizes": STEP_SIZES,
           "params": jax.tree.map(np.asarray, params),
           "state": jax.tree.map(np.asarray, state),
           "X": {}, "Y": {}, "SW": {}, "mask": {}, "images": {}}
    for size in {c[0] for c in LOGIT_CASES.values()} | set(STEP_SIZES):
        X, Y, SW, mask = _batch(r, size)
        for k, v in (("X", X), ("Y", Y), ("SW", SW), ("mask", mask),
                     ("images", X)):
            cfg[k][size] = v
    ctx = tmp_mp.start_processes(
        W.run, args=(WORLD, os.path.join(tmp, "store"), cfg), nprocs=WORLD,
        join=False, start_method="spawn")
    try:
        ref = {"jax_step": _jax_step(jnet, params, state, cfg)}
        X = cfg["images"][(SZ, SZ)]
        jraw, jref = JPredictor(jnet, params, state,
                                crf=JCrfConfig(backend="pallas"),
                                compute_dtype=jnp.float32,
                                mesh=jget_mesh(jax.devices()[:4], data=2,
                                               space=2),
                                spatial=True, return_raw=True)(X)
        ref["jax_predictor"] = (np.asarray(jraw), np.asarray(jref))
        ref["port_step"] = {size: _port_step(cfg, size)
                            for size in STEP_SIZES}
        logits = {}
        for key, (size, backbone, _, _) in LOGIT_CASES.items():
            net = W.net_for(cfg, size, backbone)
            logits[key] = net.logits(torch.from_numpy(cfg["images"][size]),
                                     LOGIT_CASES[key][2]).float().numpy()
        ref["logits"] = logits
        net = W.net_for(cfg, (SZ, SZ))
        ref["probs"] = Trainer(net, device="cpu", verbose=0).predict(
            X, batch_size=1)
    finally:
        while not ctx.join(timeout=300):
            pass
    res = []
    for rank in range(WORLD):
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return cfg, ref, res


def _slot_rows(x, rank, space=2):
    """Data slot ``rank // space``'s rows of the global batch."""
    per = B * space // WORLD
    d = rank // space
    return x[d * per:(d + 1) * per]


def test_mesh_layout_and_axis_sums(setup):
    *_, res = setup
    for rank, r in enumerate(res):
        assert r["mesh"] == (rank // 2, rank % 2, 2, 2)
        slot = rank // 2
        assert r["sums"] == (float(4 * slot + 1), 6.0,
                             float(2 + 2 * (rank % 2)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in EXCHANGE_CASES])
def test_exchange_matches_the_whole_map_conv(setup, case, mesh):
    *_, res = setup
    deeper = False
    for r in res:
        got = r["exchange"][(case, mesh)]
        assert got["fwd"] <= 1e-6 and got["bwd"] <= 1e-6, (case, mesh, got)
        a, b = got["rows"]
        spec = next(c for c in EXCHANGE_CASES if c[0] == case)
        deeper |= spec[4] > b - a
    if "deeper" in case:
        assert deeper          # the halo reaches past the neighbour's band


def _check_step(cfg, port, want_params, want_state, ref_grads, res, size,
                want_metrics):
    """The loss within 1e-5 of ``want_metrics``'; the metrics of the
    one-process port's step within 1e-5 of them, and the spatial step's
    the metrics of its own logits' argmax, which equals the one-process
    step's wherever the top-two margin exceeds ``TIE_REL`` of the scale
    (the logits within ``TRAIN_LOGIT_REL``); gradients, weights and BN
    buffers as the test says."""
    hist = [r["step"][size]["hist"] for r in res]
    for k in ("loss", "Jaccard", "sparse_accuracy"):
        assert all(h[k] == hist[0][k] for h in hist), k
        np.testing.assert_allclose(port[0][k], want_metrics[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(hist[0]["loss"][0], want_metrics["loss"],
                               rtol=1e-5, atol=1e-5)
    one = port[4]
    scale = np.abs(one).max()
    top = np.sort(one, axis=-1)
    sure = top[..., -1] - top[..., -2] > TIE_REL * scale
    labels = torch.from_numpy(cfg["Y"][size][..., 0].reshape(B, -1))
    preds = []
    for rank, r in enumerate(res):
        got = r["step"][size]["logits"]
        err = np.abs(got - _slot_rows(one, rank)).max() / scale
        assert err <= TRAIN_LOGIT_REL, (size, rank, err)
        ids = got.argmax(-1)
        np.testing.assert_array_equal(ids[_slot_rows(sure, rank)],
                                      _slot_rows(one.argmax(-1),
                                                 rank)[_slot_rows(sure,
                                                                  rank)])
        if rank % 2 == 0:
            preds.append(torch.from_numpy(ids.reshape(B // 2, -1)))
    preds = torch.cat(preds)
    np.testing.assert_allclose(
        hist[0]["Jaccard"][0], float(M.jaccard_from_ids(labels, preds,
                                                         N_CLS)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        hist[0]["sparse_accuracy"][0],
        float(M.accuracy_from_ids(labels, preds, N_CLS)), rtol=1e-6,
        atol=1e-6)
    a = res[0]["step"][size]
    gmax = max(np.abs(g).max() for t in ref_grads.values()
               for g in t.values())
    for layer, vars_ in ref_grads.items():
        for var, want in vars_.items():
            for r in res[1:]:
                np.testing.assert_array_equal(r["step"][size]["params"][
                    layer][var], a["params"][layer][var])
            scale = max(np.abs(want).max(), 1e-3 * gmax)
            err = np.linalg.norm(a["grads"][layer][var] - want)
            norm = max(np.linalg.norm(want), 1e-3 * gmax)
            assert err <= GRAD_REL * norm, (size, layer, var, err / norm)
            diff = np.abs(a["params"][layer][var]
                          - np.asarray(want_params[layer][var]))
            assert diff.max() <= 2 * LR, (size, layer, var)
            sure = np.abs(want) >= 0.1 * scale
            assert diff[sure].max(initial=0) <= 1e-6, (size, layer, var)
    for layer, vars_ in want_state.items():
        for var, want in vars_.items():
            for r in res[1:]:
                np.testing.assert_array_equal(
                    r["step"][size]["state"][layer][var],
                    a["state"][layer][var])
            np.testing.assert_allclose(a["state"][layer][var],
                                       np.asarray(want), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{layer}/{var}")


def test_spatial_step_matches_jax(setup):
    """(b) against JAX's spatial step: loss and metrics within 1e-5,
    gradients within ``GRAD_REL`` of the one-process port's, weights and
    BN buffers within tests/test_torch_train_step.py's bounds (a step
    moves each weight by about lr * sign(grad): within 1e-6 where the
    gradient is at least 0.1 of its tensor's scale, within 2 lr
    elsewhere; buffers 1e-4)."""
    cfg, ref, res = setup
    p1, s1, jm = ref["jax_step"]
    port = ref["port_step"][(SZ, SZ)]
    _check_step(cfg, port, p1, s1, port[1], res, (SZ, SZ), jm)


def test_uneven_bands_step_matches_one_process(setup):
    """(f) the 72x64 step (bands of 32 and 40 rows) against the
    one-process port's step, with the same bounds."""
    cfg, ref, res = setup
    size = (72, SZ)
    port = ref["port_step"][size]
    _check_step(cfg, port, port[2], port[3], port[1], res, size, port[0])


def test_image_pool_bn_counts_each_image_once(setup):
    """The image pool's input is the whole image's mean, the same on both
    space processes of a slot: its BN normalizes over the data axis (2
    processes, each slot's 2 images once), the others over all 4."""
    *_, res = setup
    for r in res:
        for size in STEP_SIZES:
            assert r["step"][size]["pool"] == [((2, 256, 1, 1), 2)]


def test_spatial_predictor_matches_jax(setup):
    """(c) raw labels equal to JAX's spatial Predictor's, refined masks
    >= 0.995, both space processes of a slot returning the slot's."""
    _, ref, res = setup
    jraw, jref = ref["jax_predictor"]
    for rank, r in enumerate(res):
        raw, refined = r["serving"]["raw"], r["serving"]["refined"]
        assert raw.shape == refined.shape == (B // 2, SZ, SZ)
        np.testing.assert_array_equal(raw, _slot_rows(jraw, rank))
        agree = float((refined == _slot_rows(jref, rank)).mean())
        assert agree >= 0.995, (rank, agree)
        assert len(np.unique(raw)) > 1


def test_trainer_predict_returns_the_slot(setup):
    _, ref, res = setup
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r["serving"]["probs"],
                                   _slot_rows(ref["probs"], rank), rtol=0,
                                   atol=1e-6)


def test_trainer_refuses_different_images_in_a_slot(setup):
    """The space processes of a slot given the slot's images in another
    order (a generator sharded by rank, not by data slot): the step
    raises on both, before it trains."""
    *_, res = setup
    assert all("hold different images" in r["guard"] for r in res)


def test_tta_with_spatial_raises(setup):
    *_, res = setup
    assert all("TTA" in r["serving"]["tta"] for r in res)


@pytest.mark.parametrize("key", list(LOGIT_CASES))
def test_spatial_logits_match_one_process(setup, key):
    """(d), (e), (f) each process's gathered logits of its slot against
    the one-process port's; under "mixed" the serving kernels' wrappers
    run once a layer, on bands extended by the halo (heights a multiple of
    8 for ``fused_mbconv``, as its gate asks of the map)."""
    _, ref, res = setup
    size, backbone, policy, mesh = LOGIT_CASES[key]
    want = ref["logits"][key]
    scale = np.abs(want).max()
    for rank, r in enumerate(res):
        got = r["logits"][key]["logits"]
        err = np.abs(got - _slot_rows(want, rank, SPACE[mesh])).max() / scale
        assert err <= LOGIT_REL[policy], (key, rank, err)
        calls = r["logits"][key]["calls"]
        bounds = r["logits"][key]["bounds"]
        if policy == "float32":
            assert calls == {}
        elif backbone == "xception":
            assert list(calls) == ["fused_sepconv"]
            assert len(calls["fused_sepconv"]) == 65
        else:
            assert len(calls["fused_mbconv"]) == 14
            assert len(calls["fused_dw_bn_relu6"]) == 1
            assert all(h % 8 == 0 for h in calls["fused_mbconv"])
            a, b = bounds[rank % SPACE[mesh]]
            # block 0's map (stride 2) with a halo of 1 on each inner side
            inner = (a > 0) + (b < size[0])
            assert calls["fused_dw_bn_relu6"] == [(b - a) // 2 + inner]
