"""The port's trace regions against the JAX package's ``jax.named_scope``
labels, and the trace reader (``deeplab_tpu_torch/tools/trace.py``), on the
CPU at 32x32 on one torch thread.

- The labels, as names and in order of first appearance (the port's own
  spans, which JAX has no counterpart of, set apart): the JAX side read
  from each function's jaxpr name stacks (``transpose(jvp(...))`` and the
  other transformation wrappers stripped, sub-jaxprs walked in place), the
  port's from the ``record_function`` calls of one call under an active
  profiler.  The functions: ``SegNet`` with the original head,
  ``Deeplabv3``, the Xception ``SegNet`` at output stride 16 and 8, and the
  f32 train step (the JAX ``Trainer``'s jitted step; the port's
  ``Trainer.train_step``).
- With no profiler running a forward and a step create no
  ``record_function``; logits are the same bit for bit with and without
  one; an exported serving program holds no ``profiler`` operator, even when
  exported under an active profiler.
- ``trace.py`` on a hand-built Chrome trace (nested annotations, correlation
  ids, a backward node and a kernel no launch names) gives the expected
  table; on a real CPU trace of a 32x32 train step of ``Deeplabv3`` (whose
  head is labelled) every region of ``profile_train.RULES`` is above 0 and
  the rows sum to the total.
"""

import json
import re

import numpy as np
import pytest
import torch

from deeplab_tpu_torch.models.deeplabv3p import Deeplabv3
from deeplab_tpu_torch.models.seg_model import SegNet
from deeplab_tpu_torch.tools import profile_train as PT
from deeplab_tpu_torch.tools import trace as T
from deeplab_tpu_torch.train import Trainer

SZ, N = (32, 32), 3
LABEL = re.compile(r"^(stem|mb\d{2}s\d|aspp|head|xstem|xentry\d|xmid\d{2}"
                   r"|xexit\d|loss|optimizer|step_metrics)$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ JAX side ----

def _strip(tok: str) -> str:
    """``transpose(jvp(mb03s2))`` -> ``mb03s2``."""
    while True:
        m = re.match(r"^\w+\((.*)\)$", tok)
        if not m:
            return tok
        tok = m.group(1)


def _walk(jaxpr, prefix, seen):
    from jax.extend import core as jcore
    for eqn in jaxpr.eqns:
        here = prefix + [t for t in map(
            _strip, str(eqn.source_info.name_stack).split("/"))
            if LABEL.match(t)]
        for lab in here:
            if lab not in seen:
                seen.append(lab)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _walk(sub.jaxpr, here, seen)
                elif isinstance(sub, jcore.Jaxpr):
                    _walk(sub, here, seen)
    return seen


def jax_labels(fn, *args):
    import jax
    return _walk(jax.make_jaxpr(fn)(*args).jaxpr, [], [])


def _jax_case(case):
    import jax
    import jax.numpy as jnp
    from deeplab_tpu.models.deeplabv3p import Deeplabv3 as JDeeplabv3
    from deeplab_tpu.models.seg_model import SegNet as JSegNet
    from deeplab_tpu.parallel.mesh import get_mesh
    from deeplab_tpu.train.trainer import Trainer as JTrainer
    x = jnp.zeros((2,) + SZ + (3,), jnp.float32)
    if case == "deeplabv3":
        m = JDeeplabv3(input_shape=SZ + (3,), classes=N, alpha=0.35)
    else:
        m = JSegNet(SZ, N, *_NETS[case])
    p, s = m.init(jax.random.key(0))
    if case != "train_step":
        return jax_labels(lambda p, s, x: m.apply(p, s, x), p, s, x)
    jt = JTrainer(m, mesh=get_mesh(jax.devices()[:1]), verbose=0)
    train_jit, _, tx = jt._build_steps(frozenset())
    Y = jnp.zeros((2, SZ[0] * SZ[1], 1), jnp.float32)
    SW = jnp.ones((2, SZ[0] * SZ[1]), jnp.float32)
    return jax_labels(train_jit, p, s, tx.init(p), jnp.float32(1.0),
                      jax.random.key(0), x, Y, SW)


# ----------------------------------------------------------- port side ----

_NETS = {"segnet": ("mobilenetv2", "original", 16, 0.35),
         "xception_os16": ("xception", "original", 16),
         "xception_os8": ("xception", "original", 8),
         "train_step": ("mobilenetv2", "original", 16, 0.35)}


def _port_net(case):
    """The case's net, in eval mode (the Trainer sets its own)."""
    if case == "deeplabv3":
        return Deeplabv3(input_shape=SZ + (3,), classes=N, alpha=0.35)
    return SegNet(SZ, N, *_NETS[case]).eval()


class _Recorder:
    """Stands in for ``torch.profiler.record_function``: records the names
    and opens the real range."""

    def __init__(self, monkeypatch):
        self.names = []
        real = torch.profiler.record_function

        def rec(name, *a, **k):
            self.names.append(name)
            return real(name, *a, **k)
        monkeypatch.setattr(torch.profiler, "record_function", rec)

    def first_seen(self):
        out = []
        for n in self.names:
            if n not in out:
                out.append(n)
        return out


def _inputs():
    r = np.random.RandomState(0)
    X = (r.rand(2, *SZ, 3) * 255).astype(np.float32)
    Y = r.randint(0, N, (2, SZ[0] * SZ[1], 1))
    return X, Y, np.ones((2, SZ[0] * SZ[1]), np.float32)


def _port_call(case, net):
    X, Y, SW = _inputs()
    if case == "train_step":
        tr = Trainer(net, device="cpu", verbose=0)
        tr.setup(net)
        return lambda: tr.train_step(X, Y, SW)
    if case == "deeplabv3":
        return lambda: net.apply(torch.from_numpy(X))
    return lambda: net.logits(torch.from_numpy(X))


CASES = ("segnet", "deeplabv3", "xception_os16", "xception_os8",
         "train_step")


@pytest.mark.parametrize("case", CASES)
def test_labels_equal_jax(case, monkeypatch):
    want = _jax_case(case)
    net = _port_net(case)
    call = _port_call(case, net)
    rec = _Recorder(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        call()
    seen = rec.first_seen()
    got = [n for n in seen if LABEL.match(n)]
    assert got == want
    # the rest are the port's own spans at its layer boundaries, whose tree
    # tests/test_torch_spans.py holds
    assert [n for n in seen if not LABEL.match(n)] == (
        ["train_step", "train.put", "train.forward", "train.backward"]
        if case == "train_step" else [])


@pytest.mark.parametrize("case", ("segnet", "train_step"))
def test_no_record_function_without_a_profiler(case, monkeypatch):
    net = _port_net(case)
    call = _port_call(case, net)
    rec = _Recorder(monkeypatch)
    call()
    assert rec.names == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        call()
    assert len(rec.names) >= 19       # the stem, 17 blocks and ASPP


@pytest.mark.parametrize("case", ("segnet", "deeplabv3", "xception_os16"))
def test_logits_bit_for_bit_under_a_profiler(case):
    net = _port_net(case)
    X = torch.from_numpy(_inputs()[0])
    f = ((lambda: net.apply(X)) if case == "deeplabv3"
         else (lambda: net.logits(X, "mixed")))
    plain = f()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = f()
    assert torch.equal(plain, traced)


def test_train_step_bit_for_bit_under_a_profiler():
    X, Y, SW = _inputs()
    out = []
    for profiled in (False, True):
        net = _port_net("train_step")
        tr = Trainer(net, device="cpu", verbose=0)
        tr.setup(net)
        if profiled:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                m = tr.train_step(X, Y, SW)
        else:
            m = tr.train_step(X, Y, SW)
        out.append((m, [p.detach().clone() for p in net.parameters()]))
    (m0, p0), (m1, p1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_exported_program_holds_no_profiler_operator():
    """Exported under an active profiler (the labels' guard against a
    traced graph), the program holds no ``profiler`` operator and the
    kernels' nodes of an unlabelled one: at 32x32 block 0 and the one
    expand block whose map (8 rows) meets the gate's multiple of 8."""
    from deeplab_tpu_torch.export import export_serving, op_counts
    net = SegNet(SZ, N, alpha=0.35).eval()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ep = export_serving(net, device="cpu", batch=2)
    targets = [str(n.target) for n in ep.graph_module.graph.nodes
               if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t]
    assert op_counts(ep) == {"fused_dw_bn_relu6": 1, "fused_mbconv": 1}


# ------------------------------------------------------------ trace.py ----

def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _synthetic():
    """A forward on thread 1 (annotations ``outer/stem`` around a conv that
    makes autograd node 5, then ``mb01s2``), its backward on thread 2 (the
    engine's node 5 launching a kernel), an unlabelled launch, and a kernel
    whose correlation id names no launch."""
    ev = [
        _ev("user_annotation", "outer", 0, 100),
        _ev("user_annotation", "stem", 1, 40),
        _ev("cpu_op", "aten::conv2d", 2, 30, **{"Sequence number": 5}),
        _ev("cpu_op", "aten::convolution", 3, 20, **{"Sequence number": 5}),
        _ev("cuda_runtime", "cudaLaunchKernel", 4, 2, correlation=11),
        _ev("user_annotation", "mb01s2", 50, 40),
        _ev("cpu_op", "aten::add", 55, 10, **{"Sequence number": 6}),
        _ev("cuda_driver", "cuLaunchKernel", 56, 2, correlation=12),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 2, correlation=13),
        _ev("cpu_op", "autograd::engine::evaluate_function: "
            "ConvolutionBackward0", 200, 50, tid=2,
            **{"Sequence number": 5}),
        _ev("cpu_op", "ConvolutionBackward0", 201, 45, tid=2,
            **{"Sequence number": 5}),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 2, tid=2,
            correlation=14),
        _ev("kernel", "conv_fwd", 10, 7, tid=99, correlation=11),
        _ev("kernel", "add_kernel", 60, 3, tid=99, correlation=12),
        _ev("kernel", "copy_kernel", 130, 1, tid=99, correlation=13),
        _ev("kernel", "conv_bwd", 220, 9, tid=99, correlation=14),
        _ev("gpu_memcpy", "Memcpy HtoD", 300, 2, tid=99, correlation=77),
    ]
    return {"traceEvents": ev + [{"ph": "M", "name": "process_name"}]}


def test_trace_attributes_a_hand_built_trace(tmp_path):
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps(_synthetic()))
    assert T.newest_trace(str(tmp_path)) == str(path)
    ops = T.device_ops(T.load(str(path)))
    got = {name: (scope, info["backward"], info["launched"])
           for name, scope, _, info in ops}
    assert got == {"conv_fwd": ("outer/stem", False, True),
                   "add_kernel": ("outer/mb01s2", False, True),
                   "copy_kernel": ("", False, True),
                   "conv_bwd": ("bwd(outer/stem)", True, True),
                   "Memcpy HtoD": ("", False, False)}
    totals, tops = T.bucket(ops, PT.RULES)
    assert totals == pytest.approx({"stem": 0.016, "stride2_blocks": 0.003,
                                    "other": 0.003})
    assert tops["stem"][0] == ("conv_bwd [bwd(outer/stem)]",
                               pytest.approx(0.009))
    assert T.split(ops) == (10.0, 9.0, 3.0)
    assert T.busy_us(ops) == pytest.approx(22.0)
    assert T.print_table(totals) == pytest.approx(0.022)


def test_trace_busy_counts_overlaps_once():
    ops = [("a", "", 10.0, {"ts": 0.0}), ("b", "", 10.0, {"ts": 5.0}),
           ("c", "", 1.0, {"ts": 30.0})]
    assert T.busy_us(ops) == pytest.approx(16.0)


def test_cpu_train_step_trace_fills_every_region(tmp_path):
    net = Deeplabv3(input_shape=SZ + (3,), classes=N, alpha=0.35)
    path = PT.run(str(tmp_path), bs=2, size=SZ, n_classes=N, device="cpu",
                  compute_dtype=torch.float32, net=net)
    rec = PT.itemize(path, bs=2, quiet=True)
    regions = rec["regions"]
    for region, _ in PT.RULES:
        assert regions.get(region, 0.0) > 0.0, region
    ops = rec["_ops"]
    total = sum(o[2] for o in ops) / 1e3 / 3
    assert sum(regions.values()) == pytest.approx(total, rel=1e-3)
    assert rec["total_ms"] == pytest.approx(total, rel=1e-3)
    fwd, bwd, none = rec["split_ms"].values()
    assert fwd > 0 and bwd > 0
    assert fwd + bwd + none == pytest.approx(total, rel=1e-9)
    # the backward lands in the forward's blocks
    assert any(s.startswith("bwd(") and "mb" in s for _, s, _, _ in ops)
