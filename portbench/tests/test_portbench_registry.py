"""The harness finds every piece of a cell by name, and a new cell and a
new per-layer metric are added by adding files and BENCHMARK.json
entries only."""

import argparse
import json
import os
import shutil

import pytest
import torch

from portbench import harness as H
from portbench import run as RUN

BENCH = H.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry, workload, config = H.cell_files(BENCH, cell)
    assert entry["config"] == config["name"]
    assert workload["config"] == config["name"]
    kind = H.load_module("traffic", workload["kind"])
    for fn in ("setup", "window", "end_to_end", "check"):
        assert callable(getattr(kind, fn))
    assert H.metrics_of(BENCH, cell, "end_to_end")
    assert H.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(H.load_module("metrics", metric).read)


def test_every_configuration_file_names_its_source():
    for c in BENCH["configs"]:
        config = H.load_json(os.path.join(H.ROOT, c["file"]))
        assert config["name"] == c["name"]
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"] == []


def test_new_cell_and_metric_by_adding_files(tmp_path):
    """A copy of the checkout gains a traffic mix, a cell and a per-layer
    metric through new files and entries only; the harness finds and runs
    them, and the new metric reaches the traced run's line."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(H.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    os.symlink(os.path.join(H.ROOT, "portbench", "data"),
               root / "portbench" / "data")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "xc16_serve_b4", "config": "deeplabv3p_xception_os16",
        "traffic": "xc16_serve_b4", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "calls_traced.extra", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "Serving API",
        "moves": "serve_img_s", "workloads": ["xc16_serve_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = H.load_json(os.path.join(H.ROOT, "portbench", "workloads",
                                  "xc16_serve_b16.json"))
    wl.update(batch=2, pool_batches=2, warmup_calls=1, sample_calls=1,
              trace_seconds=0.5)
    (root / "portbench" / "workloads" / "xc16_serve_b4.json").write_text(
        json.dumps(wl))
    (root / "portbench" / "metrics" / "calls_traced.extra.py").write_text(
        "def read(run):\n"
        "    return run.records.get('trace_images', 0) / "
        "run.records['batch']\n")
    args = argparse.Namespace(workload="xc16_serve_b4", seed=2 ** 31 + 5,
                              seconds=1.2, trace=1)
    result, _ = RUN.execute(args, device=torch.device("cpu"), size=(64, 64),
                            root=str(root))
    assert result["metrics"]["calls_traced.extra"]["value"] >= 1
    assert set(result["metrics"]) <= {m["name"] for m in bench["per_layer"]}
