"""One-dataclass config for the whole framework (deeplab_tpu/config.py).

The reference's "config" is literals scattered through notebook cell 0 plus
SegModel class attributes; here everything is a typed dataclass serializable
to/from JSON so experiments are reproducible from one file.  The same
classes, fields, defaults and JSON as the JAX package's, so a file written
by either loads in the other; an unknown key raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    backbone: str = "mobilenetv2"        # 'mobilenetv2' | 'xception'
    net: str = "original"                # 'original' | 'subpixel'
    n_classes: int = 21
    image_size: Tuple[int, int] = (512, 512)
    OS: int = 16
    alpha: float = 1.0


@dataclasses.dataclass
class DataConfig:
    dataset: str = "VOCdevkit/VOC2012"
    validation_split: float = 0.15
    seed: int = 7
    blur: int = 5
    horizontal_flip: bool = True
    vertical_flip: bool = False
    brightness: float = 0.3
    rotation: float = 0.0
    zoom: float = 0.1
    do_ahisteq: bool = False
    crop_shape: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 10
    batch_size: int = 2
    lr: float = 7e-4
    epsilon: float = 1e-8
    decay: float = 1e-6
    freeze_before: Optional[str] = "concat_projection"
    monitor: str = "val_Jaccard"
    checkpoint_dir: str = "weights"
    state_checkpoint: Optional[str] = None
    reduce_lr_factor: float = 0.5
    reduce_lr_patience: int = 5
    min_lr: float = 1e-6
    early_stop_patience: int = 100
    spatial: bool = False
    # per-device data parallelism with local-BN batch statistics (the JAX
    # package's Trainer(ddp=True)); mutually exclusive with spatial
    ddp: bool = False
    seed: int = 0


@dataclasses.dataclass
class CrfTestConfig:
    enabled: bool = True
    sxy_gaussian: float = 3.0
    compat_gaussian: float = 3.0
    sxy_bilateral: float = 80.0
    srgb: float = 13.0
    compat_bilateral: float = 10.0
    n_iters: int = 5


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    crf: CrfTestConfig = dataclasses.field(default_factory=CrfTestConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)

        def build(dc_cls, d):
            fields = {f.name: f for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in d.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {dc_cls.__name__}.{k}")
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return dc_cls(**kwargs)

        return cls(model=build(ModelConfig, raw.get("model", {})),
                   data=build(DataConfig, raw.get("data", {})),
                   train=build(TrainConfig, raw.get("train", {})),
                   crf=build(CrfTestConfig, raw.get("crf", {})))

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())
