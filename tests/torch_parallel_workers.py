"""The processes of the data-parallel tests (tests/test_torch_parallel.py):
one gloo group of world size 2, both started once, each running every
multi-process check on its own rows and writing what it saw to a pickle.
Spawned processes import this module, so it imports the port (torch) and
never JAX."""

import os
import pickle

import numpy as np


def _steps(rank, cfg, mesh, ddp, spatial=False):
    """One ``Trainer.fit`` step on this process's rows from the shared
    initial weights; the loss, metrics, gradients, weights and BN
    buffers after it."""
    import torch
    from deeplab_tpu_torch.data.generator import ArrayBatcher
    from deeplab_tpu_torch.models import deeplabv3p as D
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.params import (params_from_jax, to_keras_layout,
                                          trees_from_net)
    from deeplab_tpu_torch.parallel.mesh import local_batch_rows
    from deeplab_tpu_torch.train import Trainer

    sz, n_cls = cfg["sz"], cfg["n_cls"]
    mask = torch.from_numpy(local_batch_rows(cfg["mask"], mesh)).permute(
        0, 3, 1, 2)
    D.dropout = lambda x, rate, gen, band=None: torch.where(
        mask, x / 0.9, 0.0).to(x.dtype)
    net = params_from_jax(SegNet((sz, sz), n_cls, alpha=cfg["alpha"]),
                          cfg["params"], cfg["state"])
    rows = [local_batch_rows(cfg[k], mesh) for k in ("X", "Y", "SW")]
    gen = ArrayBatcher(rows[0], rows[1], len(rows[0]), n_classes=n_cls,
                       sample_weights=rows[2])
    tr = Trainer(net, epochs=1, mesh=mesh, ddp=ddp, workers=0, verbose=0,
                 spatial=spatial)
    hist = tr.fit(net, gen)
    grads = {layer: {var: to_keras_layout(var, p.grad)
                     for var, p in mod.named_parameters(recurse=False)}
             for layer, mod in net.named_children()}
    params, state = trees_from_net(net)
    return {"hist": hist, "grads": grads, "params": params, "state": state}


def _serving(rank, cfg, mesh):
    """``Trainer.predict`` and ``Predictor(mesh)`` on this process's
    images."""
    from deeplab_tpu_torch import Predictor
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.params import params_from_jax
    from deeplab_tpu_torch.parallel.mesh import gather_rows, local_batch_rows
    from deeplab_tpu_torch.train import Trainer
    import torch

    net = params_from_jax(SegNet((cfg["sz"], cfg["sz"]), cfg["n_cls"],
                                 alpha=cfg["alpha"]),
                          cfg["params"], cfg["state"])
    X = local_batch_rows(cfg["X"], mesh)
    probs = Trainer(net, mesh=mesh, verbose=0).predict(X, batch_size=1)
    pred = Predictor(net, mesh=mesh, compute_dtype="float32")
    assert pred.device == mesh.device
    masks = pred(X)
    every = gather_rows(torch.from_numpy(masks), mesh).numpy()
    return {"probs": probs, "masks": masks, "gathered": every}


def _files(rank, cfg, mesh):
    """The per-host shard with host_id/num_hosts left to the group, and
    the coordinator-only writes of a fit."""
    from deeplab_tpu_torch.data.generator import (ArrayBatcher,
                                                  SegmentationGenerator)
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.train import (JSONLLogger, ModelCheckpoint,
                                         Trainer)
    from deeplab_tpu_torch.parallel.mesh import local_batch_rows

    shards = {}
    for mode in ("train", "validation"):
        g = SegmentationGenerator(folder=cfg["voc"], mode=mode, n_classes=21,
                                  batch_size=1, resize_shape=(32, 32),
                                  validation_split=0.2, seed=7)
        shards[mode] = [os.path.basename(p) for p in g.image_path_list]
    tmp = cfg["tmp"]
    net = SegNet((cfg["sz"], cfg["sz"]), cfg["n_cls"], alpha=cfg["alpha"])
    X, Y = (local_batch_rows(cfg[k], mesh) for k in ("X", "Y"))
    gen = ArrayBatcher(X, Y, len(X), n_classes=cfg["n_cls"])
    paths = {"weights": os.path.join(tmp, f"best_r{rank}.npz"),
             "log": os.path.join(tmp, f"log_r{rank}.jsonl"),
             "state": os.path.join(tmp, f"state_r{rank}.npz")}
    cbs = [ModelCheckpoint(paths["weights"], save_best_only=False),
           JSONLLogger(paths["log"])]
    Trainer(net, epochs=1, mesh=mesh, callbacks=cbs, workers=0,
            verbose=0).fit(net, gen, state_checkpoint=paths["state"])
    written = {k: os.path.exists(p) for k, p in paths.items()}
    return {"shards": shards, "written": written}


def _raises(rank, cfg, mesh):
    """What must raise in a group: ddp with spatial, test-time
    augmentation with spatial, and processes that serve different
    batches; and ``spatial=True`` over this mesh, whose data slots hold
    one process each (``space == 1``), training as the SPMD step does."""
    from deeplab_tpu_torch import Predictor
    from deeplab_tpu_torch.data.generator import ArrayBatcher
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.train import Trainer

    out = {"spatial": _steps(rank, cfg, mesh, ddp=False, spatial=True)}
    net = SegNet((cfg["sz"], cfg["sz"]), cfg["n_cls"], alpha=cfg["alpha"])
    for name, make in (
            ("ddp_spatial", lambda: Trainer(net, mesh=mesh, ddp=True,
                                            spatial=True)),
            ("tta_spatial", lambda: Predictor(net, mesh=mesh, spatial=True,
                                              tta_flip=True))):
        try:
            make()
        except Exception as e:      # noqa: BLE001 - the type is the result
            out[name] = (type(e).__name__, str(e))
    n = 2 if rank == 0 else 1       # rank 0 serves two batches, rank 1 one
    gen = ArrayBatcher(cfg["X"][:n], cfg["Y"][:n], 1,
                       n_classes=cfg["n_cls"])
    try:
        Trainer(net, mesh=mesh, workers=0, verbose=0).fit(net, gen)
    except ValueError as e:
        out["unequal"] = str(e)
    return out


def run(rank, world, store, cfg):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from deeplab_tpu_torch.parallel import mesh as M
        mesh = M.get_mesh()
        M.warmup_collectives(mesh)
        res = {"mesh": (mesh.rank, mesh.world, str(mesh.device)),
               "coordinator": M.is_coordinator(),
               "counts": (M.process_index(), M.process_count())}
        res["spmd"] = _steps(rank, cfg, mesh, ddp=False)
        res["ddp"] = _steps(rank, cfg, mesh, ddp=True)
        res["serving"] = _serving(rank, cfg, mesh)
        res["files"] = _files(rank, cfg, mesh)
        res["raises"] = _raises(rank, cfg, mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(cfg["tmp"], f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
