"""The system under test, built from a configuration file through the
port's public entry points (``deeplab_tpu_torch``), with the harness's
seeded weights."""

from __future__ import annotations

from portbench import harness as H


def build_net(config: dict, weights: dict, device, size=None):
    """A ``SegNet`` of ``config`` at ``size`` (the configuration's image
    size by default) on ``device``, holding ``weights``."""
    from deeplab_tpu_torch import SegNet
    net = SegNet(tuple(size or config["image_size"]), config["n_classes"],
                 backbone=config["backbone"], net=config["head"],
                 OS=config.get("output_stride", 16),
                 alpha=config.get("alpha", 1.0))
    net = net.to(device)
    H.load_into(net, weights)
    return net


def crf_config(config: dict, workload: dict):
    """The workload's CRF (``"crf": true`` takes the configuration's), or
    None."""
    if not workload.get("crf"):
        return None
    from deeplab_tpu_torch.crf import CrfConfig
    return CrfConfig(**config["crf"])


def predictor(config: dict, workload: dict, net, device):
    """The served pipeline; with ``"return_raw": true`` (a CRF workload)
    each call returns the model's labels beside the refined ones, from the
    same forward, so that both can be compared."""
    from deeplab_tpu_torch import Predictor
    return Predictor(net, crf=crf_config(config, workload),
                     compute_dtype=config["policy"], device=device,
                     return_raw=bool(workload.get("return_raw")))
