"""The shape of a run's last line, and the runs that must give none."""

import argparse
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness as H
from portbench import run as RUN

SMALL = {"batch": 2, "pool_batches": 2, "warmup_calls": 1,
         "sample_calls": 1, "trace_seconds": 0.5}


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape(trace):
    args = argparse.Namespace(workload="xc16_serve_b16", seed=2 ** 31 + 11,
                              seconds=1.2, trace=trace)
    result, checks = RUN.execute(args, device=torch.device("cpu"),
                                 size=(64, 64), overrides=SMALL)
    out, err = io.StringIO(), io.StringIO()
    RUN.emit(result, checks, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert ("busy_s" in line["device"]) == bool(trace)
    assert ("breakdown" in line) == bool(trace)
    bench = H.benchmark()
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in H.metrics_of(bench, "xc16_serve_b16",
                                             section)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["correct"] is True
    assert set(line["checks"]) == set(
        H.cell_files(bench, "xc16_serve_b16")[1]["limits"])
    last = err.getvalue().strip().splitlines()[-len(checks):]
    assert all(s.startswith("check ") and " limit " in s for s in last)


def test_no_card_no_result():
    """Without CUDA the run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "mnv2_crf_b16", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=H.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copytree(os.path.join(H.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(H.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "mnv2_crf_b16", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "deeplab_tpu_torch_extra", object())
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert H.forbidden_modules() == ["jax"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  H.benchmark()["workloads"]])
def test_cell_runs_on_card(cell):
    """Each cell, short, on the card: a result with ``correct`` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "3",
                        "--trace", "0"], cwd=H.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
