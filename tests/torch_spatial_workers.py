"""The processes of the spatial-sharding tests (tests/test_torch_spatial.py):
one gloo group of 4 processes laid out data 2 x space 2, started once, each
running every check on its band of its data slot's images and writing what
it saw to a pickle.  Spawned processes import this module, so it imports the
port (torch) and never JAX."""

import contextlib
import os
import pickle

import numpy as np

B_SLOT = 2      # images of a data slot (the global batch over 2 slots)


def _counting(mod, name, calls):
    """Record the input height of every call of ``mod.name`` in
    ``calls[name]`` (on the CPU the wrappers run their plain versions)."""
    fn = getattr(mod, name)

    def wrapped(x, *a, **k):
        calls.setdefault(name, []).append(x.shape[1])
        return fn(x, *a, **k)
    return fn, wrapped


@contextlib.contextmanager
def _kernel_calls():
    """The heights the three serving kernels' wrappers see (NHWC)."""
    from deeplab_tpu_torch.kernels import fused_dw as FDW
    from deeplab_tpu_torch.kernels import fused_mbconv as FM
    calls = {}
    saved = []
    for mod, name in ((FM, "fused_mbconv"), (FM, "fused_sepconv"),
                      (FDW, "fused_dw_bn_relu6")):
        fn, wrapped = _counting(mod, name, calls)
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _exchange_cases(cfg, meshes):
    """(a) A band conv against the whole-map conv, forward and the input's
    gradient, relative to each one's largest magnitude: every case on the
    2 x 2 mesh and on a 1 x 4 one."""
    import torch
    from deeplab_tpu_torch import core
    from deeplab_tpu_torch.ops import conv as C
    from deeplab_tpu_torch.ops.padding import manual_pads
    from deeplab_tpu_torch.parallel.spatial import Band
    f32 = core.resolve_compute_dtype("float32")
    out = {}
    for i, case in enumerate(cfg["exchange_cases"]):
        name, kind, k, stride, rate, H, unit, s = case
        r = np.random.RandomState(100 + i)
        hs = -(-H // s)
        cin = 3
        x = torch.from_numpy(r.randn(2, cin, hs, 6).astype(np.float32))
        if kind == "depthwise":
            w = torch.from_numpy(r.randn(cin, 1, k, k).astype(np.float32))
        else:
            w = torch.from_numpy(r.randn(4, cin, k, k).astype(np.float32))

        def conv(t, band):
            if kind == "same":
                return C.conv2d(t, w, f32, stride, rate, band=band)
            if kind == "fixed":
                return C.conv2d_fixed(t, w, f32, stride, rate, band=band)
            pads = manual_pads(k, rate) if stride > 1 else None
            return C.depthwise_conv2d(t, w, f32, stride, rate,
                                      explicit_pads=pads, band=band)
        whole = x.clone().requires_grad_()
        want = conv(whole, None)
        gout = torch.from_numpy(r.randn(*want.shape).astype(np.float32))
        (want * gout).sum().backward()
        for mname, mesh in meshes.items():
            band = Band.of(mesh, H, unit)
            a, b = band.rows(s)
            oa, ob = band.rows(s * stride)
            part = x[:, :, a:b].clone().requires_grad_()
            got = conv(part, band)
            (got * gout[:, :, oa:ob]).sum().backward()
            fwd = (got - want[:, :, oa:ob]).abs().max().item() / \
                want.abs().max().item()
            bwd = (part.grad - whole.grad[:, :, a:b]).abs().max().item() / \
                whole.grad.abs().max().item()
            out[(name, mname)] = {"fwd": fwd, "bwd": bwd,
                                  "rows": (a, b), "out_rows": (oa, ob),
                                  "shape": tuple(got.shape)}
    return out


def _seed_bn(net, seed):
    """Seeded BN moving statistics (fresh ones make BN(0) zero, which
    hides what a kernel computes on zero rows)."""
    import torch
    from deeplab_tpu_torch.ops.bn import BatchNorm
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                c = m.gamma.shape[0]
                m.moving_mean.copy_(torch.from_numpy(
                    0.1 * r.randn(c).astype(np.float32)))
                m.moving_variance.copy_(torch.from_numpy(
                    (1.0 + r.rand(c)).astype(np.float32)))
    return net


def net_for(cfg, size, backbone="mobilenetv2"):
    """The net of a check, in eval mode: MobileNetV2 with the JAX net's
    weights, and with seeded BN statistics ("mobilenetv2 bn"); the port's
    seeded MobileNetV2 with the 'subpixel' head, or as the reference's
    ``Deeplabv3`` (OS 8); or the port's seeded Xception (OS 16) with
    seeded BN statistics (the test builds the same ones)."""
    from deeplab_tpu_torch.models.deeplabv3p import Deeplabv3
    from deeplab_tpu_torch.models.seg_model import SegNet
    from deeplab_tpu_torch.params import params_from_jax
    if backbone == "subpixel":
        return SegNet(size, cfg["n_cls"], net="subpixel", alpha=cfg["alpha"],
                      seed=cfg["xc_seed"]).eval()
    if backbone == "deeplabv3":
        return Deeplabv3(input_shape=size + (3,), classes=cfg["n_cls"],
                         alpha=cfg["alpha"], OS=8, seed=cfg["xc_seed"]).eval()
    if backbone == "xception":
        net = SegNet(size, cfg["n_cls"], "xception", OS=16,
                     seed=cfg["xc_seed"])
        return _seed_bn(net, cfg["xc_seed"]).eval()
    net = params_from_jax(SegNet(size, cfg["n_cls"], alpha=cfg["alpha"]),
                          cfg["params"], cfg["state"]).eval()
    return _seed_bn(net, cfg["xc_seed"]) if backbone == "mobilenetv2 bn" \
        else net


def _logits(cfg, meshes):
    """(d), (e), (f): the eval logits of the slot's images through bands
    (on the case's mesh), gathered, and the serving kernels' (plain
    versions') input heights."""
    import torch
    from deeplab_tpu_torch.parallel.mesh import local_batch_rows
    from deeplab_tpu_torch.parallel.spatial import Band, banded, unit_of
    out = {}
    for key, (size, backbone, policy, mname) in cfg["logit_cases"].items():
        mesh = meshes[mname]
        net = net_for(cfg, size, backbone)
        X = torch.from_numpy(local_batch_rows(cfg["images"][size], mesh))
        band = Band.of(mesh, size[0], unit_of(net))
        with _kernel_calls() as calls, banded(net, band):
            part = net.logits(band.take(X), policy)
        out[key] = {"logits": band.gather(part).float().numpy(),
                    "calls": calls, "bounds": band.bounds}
    return out


def _step(cfg, mesh, size, mask):
    """(b) One ``Trainer(mesh, spatial=True)`` step on the slot's images;
    the loss, metrics, gradients, weights and BN buffers after it."""
    import torch
    from deeplab_tpu_torch.data.generator import ArrayBatcher
    from deeplab_tpu_torch.models import deeplabv3p as D
    from deeplab_tpu_torch.params import to_keras_layout, trees_from_net
    from deeplab_tpu_torch.parallel.mesh import local_batch_rows
    from deeplab_tpu_torch.parallel.spatial import Band, unit_of
    from deeplab_tpu_torch.train import Trainer

    slot = torch.from_numpy(local_batch_rows(mask, mesh)).permute(0, 3, 1, 2)

    def drop(x, rate, gen, band=None):
        a, b = band.rows(band.level(x.shape[2]))
        return torch.where(slot[:, :, a:b], x / 0.9, 0.0).to(x.dtype)
    D.dropout = drop
    net = net_for(cfg, size).train()
    X, Y, SW = (local_batch_rows(cfg[k][size], mesh) for k in ("X", "Y",
                                                               "SW"))
    gen = ArrayBatcher(X, Y, len(X), n_classes=cfg["n_cls"],
                       sample_weights=SW)
    tr = Trainer(net, epochs=1, mesh=mesh, spatial=True, workers=0,
                 verbose=0)
    pool = []           # what the image pool's BN normalizes, and over what
    hook = net.image_pooling_BN.register_forward_pre_hook(
        lambda m, args: pool.append((tuple(args[0].shape), m.group.world)))
    outs = []           # the band logits the loss and the metrics see
    apply_logits = net.apply_logits

    def keep(*args, **kw):
        out = apply_logits(*args, **kw)
        outs.append(out.detach().clone())
        return out
    net.apply_logits = keep
    hist = tr.fit(net, gen)
    hook.remove()
    del net.apply_logits
    H = cfg["X"][size].shape[1]
    band = Band.of(mesh, H, unit_of(net))
    grads = {layer: {var: to_keras_layout(var, p.grad)
                     for var, p in mod.named_parameters(recurse=False)}
             for layer, mod in net.named_children()}
    params, state = trees_from_net(net)
    return {"hist": hist, "grads": grads, "params": params, "state": state,
            "pool": pool, "logits": band.gather(outs[0]).numpy()}


def _serving(cfg, mesh):
    """(c) ``Predictor(mesh, spatial=True, crf=..., return_raw=True)`` and
    ``Trainer.predict`` on the slot's images; the TTA case raising."""
    from deeplab_tpu_torch import Predictor
    from deeplab_tpu_torch.crf import CrfConfig
    from deeplab_tpu_torch.parallel.mesh import local_batch_rows
    from deeplab_tpu_torch.train import Trainer
    size = (cfg["sz"], cfg["sz"])
    net = net_for(cfg, size)
    X = local_batch_rows(cfg["images"][size], mesh)
    pred = Predictor(net, mesh=mesh, spatial=True, return_raw=True,
                     crf=CrfConfig(backend="pallas"),
                     compute_dtype="float32")
    raw, refined = pred(X)
    probs = Trainer(net, mesh=mesh, spatial=True, verbose=0).predict(
        X, batch_size=1)
    try:
        Predictor(net, mesh=mesh, spatial=True, tta_flip=True)
        tta = None
    except ValueError as e:
        tta = str(e)
    return {"raw": raw, "refined": refined, "probs": probs, "tta": tta}


def _guard(cfg, mesh):
    """A spatial step whose second space process holds its slot's images
    in reverse order: what it raises."""
    from deeplab_tpu_torch.parallel.mesh import local_batch_rows
    from deeplab_tpu_torch.train import Trainer
    size = (cfg["sz"], cfg["sz"])
    X, Y, SW = (local_batch_rows(cfg[k][size], mesh) for k in ("X", "Y",
                                                               "SW"))
    if mesh.space_index:
        X, Y, SW = X[::-1], Y[::-1], SW[::-1]
    net = net_for(cfg, size).train()
    tr = Trainer(net, mesh=mesh, spatial=True, verbose=0)
    tr.setup(net)
    try:
        tr.train_step(X.copy(), Y.copy(), SW.copy())
    except ValueError as e:
        return str(e)
    return ""


def run(rank, world, store, cfg):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from deeplab_tpu_torch.parallel import mesh as M
        mesh = M.get_mesh(space=2)
        line = M.get_mesh(space=4)
        M.warmup_collectives(mesh)
        res = {"mesh": (mesh.data_index, mesh.space_index, mesh.data,
                        mesh.space),
               "sums": (mesh.space_sum(torch.tensor([float(rank)])).item(),
                        mesh.all_sum(torch.tensor([float(rank)])).item(),
                        mesh.data_axis().all_sum(
                            torch.tensor([float(rank)])).item())}
        meshes = {"2x2": mesh, "1x4": line}
        res["exchange"] = _exchange_cases(cfg, meshes)
        res["logits"] = _logits(cfg, meshes)
        res["step"] = {size: _step(cfg, mesh, size, cfg["mask"][size])
                       for size in cfg["step_sizes"]}
        res["serving"] = _serving(cfg, mesh)
        res["guard"] = _guard(cfg, mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(cfg["tmp"], f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
