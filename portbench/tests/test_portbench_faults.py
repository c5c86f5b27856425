"""Runs of each cell on the CPU at a small size, the card check skipped,
with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, and true without one."""

import argparse
import json
import os

import pytest
import torch

from portbench import harness as H
from portbench import run as RUN

SERVE = {"batch": 2, "pool_batches": 2, "warmup_calls": 1,
         "sample_calls": 1, "trace_seconds": 0.5}
ONLINE = {"rate": 20, "pool_images": 4, "sample_requests": 3,
          "trace_seconds": 0.5, "clients": 8, "buckets": [1, 2],
          "warmup_seconds": 0.2}
# at this size bf16 training reads above the cell's limits (set at 512x512,
# B=16), so the training runs here take the float32 policy, whose steps
# follow the reference to round-off
TRAIN = {"batch": 4, "pool_batches": 3, "trace_steps": 1,
         "compute_dtype": "float32"}
CELLS = {"mnv2_crf_b16": SERVE, "xc16_serve_b16": SERVE,
         "mnv2_crf_online": ONLINE, "mnv2_train_b16": TRAIN}


def _root(tmp):
    """A checkout whose BENCHMARK.json also names the open-loop cell,
    whose traffic kind and files the benchmark keeps for a later PR."""
    bench = H.benchmark()
    bench["workloads"].append({
        "name": "mnv2_crf_online", "config": "deeplabv3p_mnv2_os8",
        "traffic": "mnv2_crf_online", "chips": 1, "why": "open loop"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(os.path.join(H.ROOT, "portbench"), tmp / "portbench")
    return str(tmp)


def _run(cell, tmp, seed=2 ** 31 + 21):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=1.0,
                              trace=0)
    result, _ = RUN.execute(args, device=torch.device("cpu"), size=(64, 64),
                            overrides=CELLS[cell], root=_root(tmp))
    return result


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, tmp_path):
    assert _run(cell, tmp_path)["correct"]


def _altered(call):
    """A Predictor call whose answers are altered where they are made:
    every label moved to the next class."""
    def wrapped(self, images):
        out = call(self, images)
        shift = lambda a: (a + 1) % self.n_classes
        if isinstance(out, tuple):
            return out[0], shift(out[1])
        return shift(out)
    return wrapped


@pytest.mark.parametrize("cell", ["mnv2_crf_b16", "xc16_serve_b16",
                                  "mnv2_crf_online"])
def test_altered_answer_is_caught(cell, monkeypatch, tmp_path):
    from deeplab_tpu_torch.predictor import Predictor
    monkeypatch.setattr(Predictor, "__call__",
                        _altered(Predictor.__call__))
    assert not _run(cell, tmp_path)["correct"]


def test_unchanged_state_is_caught(monkeypatch, tmp_path):
    """A step that returns its state unchanged: the optimizer never
    moves a weight."""
    from deeplab_tpu_torch.train.optimizer import KerasAdam
    monkeypatch.setattr(KerasAdam, "step", lambda self, lr_scale=1.0: None)
    assert not _run("mnv2_train_b16", tmp_path)["correct"]


def test_half_batch_is_caught(monkeypatch, tmp_path):
    """Half of each batch left out of the step, the mean taken over the
    rest."""
    from deeplab_tpu_torch.train.trainer import Trainer
    step = Trainer.train_step

    def half(self, X, Y, SW):
        n = len(X) // 2
        return step(self, X[:n], Y[:n], SW[:n])
    monkeypatch.setattr(Trainer, "train_step", half)
    assert not _run("mnv2_train_b16", tmp_path)["correct"]
