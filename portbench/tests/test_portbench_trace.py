"""The frozen trace arithmetic and the readers on a synthetic trace."""

import json

import pytest

from portbench import readers as R
from portbench import trace as T


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace():
    """A forward under ``stem`` and ``mb02s1``, the backward of ``mb02s1``
    on the autograd thread, a label copy back, and two idle stretches."""
    ev = [
        _ev("stem", "user_annotation", 0, 20),
        _ev("aten::conv", "cpu_op", 1, 10, **{"Sequence number": 7}),
        _ev("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
        _ev("mb02s1", "user_annotation", 30, 20),
        _ev("aten::mul", "cpu_op", 31, 10, **{"Sequence number": 8}),
        _ev("cudaLaunchKernel", "cuda_runtime", 32, 1, correlation=2),
        _ev("autograd::engine::evaluate_function: MulBackward0", "cpu_op",
            60, 10, tid=2, **{"Sequence number": 8}),
        _ev("cudaLaunchKernel", "cuda_runtime", 61, 1, tid=2,
            correlation=3),
        _ev("aten::copy_", "cpu_op", 80, 5),
        _ev("cudaMemcpyAsync", "cuda_runtime", 81, 1, correlation=4),
        _ev("conv_kernel", "kernel", 100, 50, tid=9, correlation=1),
        _ev("mul_kernel", "kernel", 140, 30, tid=9, correlation=2),
        _ev("mul_bwd_kernel", "kernel", 200, 40, tid=9, correlation=3),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 260, 10,
            tid=9, correlation=4),
    ]
    return ev


def test_device_ops_scopes_and_backward(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    ops = T.device_ops(T.load(str(path)))
    by = {o[0]: o for o in ops}
    assert by["conv_kernel"][1] == "stem"
    assert by["mul_kernel"][1] == "mb02s1"
    assert by["mul_bwd_kernel"][1] == "bwd(mb02s1)"
    assert by["mul_bwd_kernel"][3]["backward"]
    assert by["Memcpy DtoH (Device -> Pageable)"][1] == ""
    assert by["conv_kernel"][3]["host"] == "aten::conv"


def test_busy_is_a_union_and_gaps_fill_the_rest():
    ops = T.device_ops(_trace())
    assert T.busy_us(ops) == pytest.approx(70 + 40 + 10)
    gaps = T.idle_gaps(ops)
    assert sum(g for _, g in gaps) == pytest.approx((270 - 100 - 120) / 1e6)
    assert gaps[0][0].startswith("MulBackward0".join(
        ["autograd::engine::evaluate_function: ", ""]))


def test_region_times():
    ops = T.device_ops(_trace())
    assert R.region_us(ops, R.MB_S1, backward=False) == 30
    assert R.region_us(ops, R.MB_S1) == 70
    assert R.memcpy_us(ops) == 10


def test_post_model_region():
    """Ops after a call's last model label count until the next call's
    input copy; the ops that prepare that input do not."""
    def op(name, scope, ts, dur):
        return (name, scope, dur, {"ts": ts, "backward": False})
    ops = [op("norm", "", 0, 1), op("k1", "stem", 2, 5),
           op("k2", "aspp", 8, 5), op("head", "", 14, 3),
           op("Memcpy HtoD (Pageable -> Device)", "", 18, 2),
           op("crf", "", 21, 10),
           op("Memcpy DtoH (Device -> Pageable)", "", 32, 4),
           op("Memcpy HtoD (Pageable -> Device)", "", 40, 6),
           op("norm", "", 47, 1), op("k1", "stem", 49, 5)]
    assert R.post_model_us(ops) == 3 + 10
