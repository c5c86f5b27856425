"""Data parallelism over ``torch.distributed`` on the CPU: one spawned gloo
group of world size 2 (tests/torch_parallel_workers.py, no JAX) runs every
multi-process check in one start, against the JAX package on 2 of the 8
CPU devices the conftest gives it.

- ``Trainer(mesh=...)`` (BN over the global batch) against JAX's
  ``Trainer(mesh=get_mesh(jax.devices()[:2]))`` SPMD step, and
  ``Trainer(mesh=..., ddp=True)`` against JAX's ``ddp=True`` step, each
  one step on the same weights, global batch of 4 (2 rows a process) and
  dropout mask (one step: ROADMAP C5): loss and metrics within 1e-5, every
  gradient within 1e-3 of its scale against ``jax.grad`` of the same loss,
  the updated weights and BN buffers within tests/test_torch_train_step.py's
  bounds; both processes hold the same weights bit for bit.
- ``Trainer.predict`` and ``Predictor(mesh)`` on each process's rows
  against the single-process port on the whole batch.
- The generator's host shard (``host_id``/``num_hosts`` left to the group)
  against JAX's file lists; the checkpoints, the weight file and the JSONL
  log written by rank 0 only; ``spatial=True`` at ``space == 1`` equal to
  the SPMD step, with ddp or test-time augmentation raising; processes
  that serve different batches raising.
- At world size 1 (no group): the mesh helpers are the identity, and the
  CLI's torchrun path trains through a gloo group of one.
"""

import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as tmp_mp

from deeplab_tpu.data import generator as JG
from deeplab_tpu.models import deeplabv3p as JD
from deeplab_tpu.models.seg_model import SegNet as JSegNet
from deeplab_tpu.parallel.mesh import get_mesh as jget_mesh
from deeplab_tpu.train.trainer import Trainer as JTrainer

from deeplab_tpu_torch import Predictor
from deeplab_tpu_torch.models import deeplabv3p as D
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.params import params_from_jax, to_keras_layout
from deeplab_tpu_torch.parallel import mesh as M
from deeplab_tpu_torch.train import Trainer

import torch_parallel_workers

SZ, N_CLS, ALPHA, B = 64, 3, 0.35, 4
VOC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "mini_voc")
LR = 7e-4
# the all-reduced gradient against the single-process port's, of each
# tensor's scale: SPMD's BN statistics sum each process's partial sums and
# then all-reduce them, another order than one process's mean, which BN
# over 4x8x8 values amplifies through the blocks (measured 5.8e-3, in
# expanded_conv_14_expand_BN); ddp normalizes each process's rows as one
# process does (measured 5.1e-5)
GRAD_REL = {"spmd": 1e-2, "ddp": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: six test workers' thread pools would oversubscribe
    the cores (the spawned processes set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX net's initial trees, the global batch, and the two
    processes' results."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    r = np.random.RandomState(4)
    X = (r.rand(B, SZ, SZ, 3) * 255).astype(np.float32)
    Y = r.randint(0, N_CLS + 1, (B, SZ * SZ, 1)).astype(np.int32)
    SW = (0.5 + r.rand(B, SZ * SZ)).astype(np.float32)
    mask = r.rand(B, SZ // 8, SZ // 8, 256) < 0.9
    jnet = JSegNet((SZ, SZ), N_CLS, "mobilenetv2", "original", alpha=ALPHA)
    params, state = jnet.init(jax.random.key(1))
    cfg = {"sz": SZ, "n_cls": N_CLS, "alpha": ALPHA, "X": X, "Y": Y,
           "SW": SW, "mask": mask, "voc": VOC, "tmp": tmp,
           "params": jax.tree.map(np.asarray, params),
           "state": jax.tree.map(np.asarray, state)}
    tmp_mp.start_processes(torch_parallel_workers.run,
                           args=(2, os.path.join(tmp, "store"), cfg),
                           nprocs=2, join=True, start_method="spawn")
    res = []
    for rank in range(2):
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return jnet, params, state, cfg, res


def _jax_step(monkeypatch, jnet, params, state, cfg, ddp):
    """JAX's train step on 2 devices."""
    mask = jnp.asarray(cfg["mask"])

    def jdrop(ctx, x, rate):
        m = mask
        if x.shape[0] != m.shape[0]:          # a shard inside shard_map
            i = jax.lax.axis_index("data")
            m = jax.lax.dynamic_slice_in_dim(m, i * x.shape[0], x.shape[0])
        return jnp.where(m, x / 0.9, 0.0).astype(x.dtype)
    monkeypatch.setattr(JD, "dropout", jdrop)
    jt = JTrainer(jnet, mesh=jget_mesh(jax.devices()[:2]), ddp=ddp,
                  verbose=0)
    train_jit, _, tx = jt._build_steps(frozenset())
    copy = lambda t: jax.tree.map(jnp.array, t)
    p1, s1, _, jm = train_jit(copy(params), copy(state),
                              tx.init(copy(params)), jnp.float32(1.0),
                              jax.random.key(0),
                              *(jnp.asarray(cfg[k]) for k in ("X", "Y",
                                                              "SW")))
    return p1, s1, jm


def _port_grads(monkeypatch, cfg, rows):
    """The single-process port's gradient of the loss on ``rows``."""
    tmask = torch.from_numpy(cfg["mask"][rows]).permute(0, 3, 1, 2)
    monkeypatch.setattr(D, "dropout", lambda x, rate, gen, band=None:
                        torch.where(tmask, x / 0.9, 0.0).to(x.dtype))
    net = params_from_jax(SegNet((SZ, SZ), N_CLS, alpha=ALPHA),
                          cfg["params"], cfg["state"])
    tr = Trainer(net, device="cpu", verbose=0)
    tr.setup(net)
    tr.train_step(*(cfg[k][rows] for k in ("X", "Y", "SW")))
    return {layer: {var: to_keras_layout(var, p.grad)
                    for var, p in mod.named_parameters(recurse=False)}
            for layer, mod in net.named_children()}


@pytest.mark.parametrize("mode", ["spmd", "ddp"])
def test_one_step_matches_jax(setup, monkeypatch, mode):
    """Loss and metrics against JAX within 1e-5; weights and BN buffers
    within tests/test_torch_train_step.py's bounds (a step moves each
    weight by about lr * sign(grad): within 1e-6 where the gradient is at
    least 0.1 of its tensor's scale, within 2 lr elsewhere; buffers 1e-4);
    the gradient against the single-process port's on the same rows
    within ``GRAD_REL`` of its scale (SPMD: the whole batch; ddp: the mean
    of the two halves', each normalized by its own weight count, which is
    half the global one)."""
    jnet, params, state, cfg, res = setup
    p1, s1, jm = _jax_step(monkeypatch, jnet, params, state, cfg,
                           ddp=mode == "ddp")
    if mode == "spmd":
        ref = _port_grads(monkeypatch, cfg, slice(0, B))
    else:
        halves = [_port_grads(monkeypatch, cfg, slice(i, i + 2))
                  for i in (0, 2)]
        ref = {layer: {var: 0.5 * (g + halves[1][layer][var])
                       for var, g in vars_.items()}
               for layer, vars_ in halves[0].items()}
    a, b = res[0][mode], res[1][mode]
    for k in ("loss", "Jaccard", "sparse_accuracy"):
        assert a["hist"][k] == b["hist"][k]
        np.testing.assert_allclose(a["hist"][k][0], float(jm[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    gmax = max(np.abs(g).max() for t in ref.values() for g in t.values())
    for layer, vars_ in ref.items():
        for var, want in vars_.items():
            np.testing.assert_array_equal(b["params"][layer][var],
                                          a["params"][layer][var])
            scale = max(np.abs(want).max(), 1e-3 * gmax)
            err = np.abs(a["grads"][layer][var] - want).max()
            assert err <= GRAD_REL[mode] * scale, (mode, layer, var,
                                                   err / scale)
            diff = np.abs(a["params"][layer][var]
                          - np.asarray(p1[layer][var]))
            assert diff.max() <= 2 * LR, (mode, layer, var)
            sure = np.abs(want) >= 0.1 * scale
            assert diff[sure].max(initial=0) <= 1e-6, (mode, layer, var)
    for layer, vars_ in s1.items():
        for var, want in vars_.items():
            np.testing.assert_array_equal(a["state"][layer][var],
                                          b["state"][layer][var])
            np.testing.assert_allclose(a["state"][layer][var],
                                       np.asarray(want), rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"{mode} {layer}/{var}")


def test_predict_and_predictor_on_each_process(setup):
    _, _, _, cfg, res = setup
    net = params_from_jax(SegNet((SZ, SZ), N_CLS, alpha=ALPHA),
                          cfg["params"], cfg["state"])
    probs = Trainer(net, device="cpu", verbose=0).predict(cfg["X"],
                                                          batch_size=1)
    masks = Predictor(net, device="cpu", compute_dtype="float32")(cfg["X"])
    got_probs = np.concatenate([r["serving"]["probs"] for r in res])
    np.testing.assert_allclose(got_probs, probs, rtol=0, atol=1e-6)
    got = np.concatenate([r["serving"]["masks"] for r in res])
    np.testing.assert_array_equal(got, masks)
    for r in res:
        np.testing.assert_array_equal(r["serving"]["gathered"], masks)


def test_mesh_and_host_shard(setup):
    *_, res = setup
    for rank, r in enumerate(res):
        assert r["mesh"] == (rank, 2, "cpu")
        assert r["counts"] == (rank, 2)
        assert r["coordinator"] == (rank == 0)
        for mode in ("train", "validation"):
            want = JG.SegmentationGenerator(
                folder=VOC, mode=mode, n_classes=21, batch_size=1,
                resize_shape=(32, 32), validation_split=0.2, seed=7,
                host_id=rank, num_hosts=2).image_path_list
            assert r["files"]["shards"][mode] == [os.path.basename(p)
                                                  for p in want]
    train = res[0]["files"]["shards"]["train"] + \
        res[1]["files"]["shards"]["train"]
    assert len(set(train)) == len(train) == 16


def test_only_the_coordinator_writes(setup):
    *_, res = setup
    assert res[0]["files"]["written"] == {"weights": True, "log": True,
                                          "state": True}
    assert res[1]["files"]["written"] == {"weights": False, "log": False,
                                          "state": False}


def test_what_raises_in_a_group(setup):
    """ddp and test-time augmentation with spatial sharding raise, as do
    processes serving different batches; ``spatial=True`` over a mesh
    with ``space == 1`` trains: its step equals the SPMD step bit for bit
    (history, weights, BN buffers), as in JAX."""
    *_, res = setup
    for r in res:
        sp, spmd = r["raises"]["spatial"], r["spmd"]
        assert sp["hist"] == spmd["hist"]
        for tree in ("params", "state"):
            for layer, vars_ in spmd[tree].items():
                for var, want in vars_.items():
                    np.testing.assert_array_equal(sp[tree][layer][var], want)
        assert r["raises"]["ddp_spatial"][0] == "ValueError"
        kind, msg = r["raises"]["tta_spatial"]
        assert kind == "ValueError" and "TTA" in msg
        assert "different batches" in r["raises"]["unequal"]


def test_one_process_mesh_is_the_identity():
    assert not torch.distributed.is_initialized()
    mesh = M.get_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.device.type) == (0, 1, "cpu")
    assert M.process_count() == 1 and M.is_coordinator()
    t = torch.arange(6.0).reshape(3, 2)
    assert M.gather_rows(t, mesh) is t
    assert torch.equal(M.local_batch_rows(t, mesh), t)
    assert torch.equal(mesh.all_sum(t.clone()), t)
    M.warmup_collectives(mesh)
    assert M.get_available_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        M.local_batch_rows(t, M.Mesh(None, 0, 2, torch.device("cpu")))


@pytest.mark.parametrize("ddp", [True, False])
def test_cli_train_under_torchrun_variables(tmp_path, monkeypatch, capsys,
                                            ddp):
    """``cli train`` with torchrun's variables set (world size 1) starts a
    gloo group itself, trains data-parallel, writes its weights on rank 0
    and ends the group."""
    _cli_train(tmp_path, monkeypatch, capsys, ddp)


def test_cli_train_spatial_under_torchrun_variables(tmp_path, monkeypatch,
                                                    capsys):
    """``cli train`` with ``spatial: true`` in its config trains: under
    torchrun the mesh has ``space == 1``, as JAX's CLI builds it, so the
    step is the SPMD step."""
    _cli_train(tmp_path, monkeypatch, capsys, False, spatial=True)


def _cli_train(tmp_path, monkeypatch, capsys, ddp, spatial=False):
    import socket
    from deeplab_tpu_torch import cli
    from deeplab_tpu_torch.config import Config
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "1"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    cfg = Config()
    cfg.model.image_size = (32, 32)
    cfg.model.n_classes = 3
    cfg.model.alpha = 0.35
    cfg.data.dataset = VOC
    cfg.data.validation_split = 0.2
    cfg.data.blur = 0
    cfg.train.epochs = 1
    cfg.train.batch_size = 4
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.spatial = spatial
    path = str(tmp_path / "config.json")
    cfg.save(path)
    cli.main(["train", "--config", path, "--device", "cpu"]
             + (["--ddp"] if ddp else []))
    out = capsys.readouterr().out
    assert "data-parallel: rank 0 of 1 on cpu, " + (
        "ddp" if ddp else "BN over the global batch") in out, out
    assert "Epoch 1/1" in out
    assert os.path.exists(tmp_path / "ckpt" / "mobilenetv2_original.npz")
    assert not torch.distributed.is_initialized()
