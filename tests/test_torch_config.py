"""The port's config (deeplab_tpu_torch/config.py) against the JAX one: the
same JSON byte for byte, files written by either load in the other, and an
unknown key raises."""

import dataclasses
import json

import pytest

from deeplab_tpu import config as JC
from deeplab_tpu_torch import config as TC


def test_default_json_equals_jax_byte_for_byte():
    assert TC.Config().to_json() == JC.Config().to_json()


@pytest.mark.parametrize("section,field,value", [
    ("model", "image_size", (256, 384)), ("model", "backbone", "xception"),
    ("data", "crop_shape", (320, 240)), ("data", "do_ahisteq", True),
    ("train", "freeze_before", None), ("train", "ddp", True),
    ("crf", "n_iters", 3), ("crf", "sxy_bilateral", 16.0)])
def test_jax_json_loads_in_the_port(section, field, value):
    jcfg = JC.Config()
    setattr(getattr(jcfg, section), field, value)
    text = jcfg.to_json()
    tcfg = TC.Config.from_json(text)
    assert getattr(getattr(tcfg, section), field) == value
    assert tcfg.to_json() == text
    assert dataclasses.asdict(JC.Config.from_json(tcfg.to_json())) == \
        dataclasses.asdict(jcfg)


def test_file_round_trip(tmp_path):
    cfg = TC.Config()
    cfg.model.n_classes = 5
    cfg.train.epochs = 3
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    back = TC.Config.load(path)
    assert back == cfg
    assert JC.Config.load(path).model.n_classes == 5


@pytest.mark.parametrize("section", ["model", "data", "train", "crf"])
def test_unknown_key_raises(section):
    raw = json.loads(TC.Config().to_json())
    raw[section]["no_such_key"] = 1
    with pytest.raises(KeyError, match="no_such_key"):
        TC.Config.from_json(json.dumps(raw))
