"""The per-layer metrics that read the program's own spans and counters
(stages.read as ctx["stages"], the window's counters as ctx["counters"]),
the FLOP yardstick on fused attention, and a kernel op declared in a file
of its own under metrics/ops/ with its work function in another."""

import io
import json
import os
import shutil
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import readers, run, spec, stages, trace, work
from portbench.tests.test_portbench_readers import _trace
from portbench.tests.tiny_specs import tiny

torch.set_num_threads(2)

TRAIN_STAGES = ("features", "rpn", "proposals", "heads", "update")
SERVE_STAGES = ("features", "rpn", "proposals", "heads", "stitch")
NEW = {"step": [f"{s}_ms.train" for s in TRAIN_STAGES]
       + ["syncs_per_step.train", "fetch_wait_ms.train"],
       "frame": [f"{s}_ms.serve" for s in SERVE_STAGES]
       + ["syncs_per_frame.serve", "fetch_wait_ms.serve"]}


def _x(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def span_trace(path, unit, names, units=2):
    """`units` traced units of `livecell.<unit>`, each 1000 us: in the
    i-th stage of `names` one kernel of (i + 1) * 10 us, one sync inside
    the unit's span, and after the units a sync outside every span."""
    events = [_x(trace.UNIT, 0, 1000 * units + 100, cat="user_annotation")]
    corr = 0
    for u in range(units):
        t0 = 1000 * u
        events.append(_x(f"livecell.{unit}", t0, 900, cat="user_annotation"))
        for i, name in enumerate(names):
            s = t0 + 10 + 100 * i
            events.append(_x(f"livecell.{name}", s, 90,
                             cat="user_annotation"))
            events.append(_x("cudaLaunchKernel", s + 5, 3, cat="cuda_runtime",
                             correlation=corr))
            events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                           "ts": s + 20, "dur": (i + 1) * 10, "pid": 0,
                           "tid": 7, "args": {"correlation": corr}})
            corr += 1
        events.append(_x("cudaStreamSynchronize", t0 + 800, 20,
                         cat="cuda_runtime"))
    events.append(_x("cudaMemcpy", 1000 * units + 10, 20, cat="cuda_runtime"))
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _ctx(unit, by_span, counters=None):
    return {"unit": unit, "units": 2, "stages": by_span,
            "counters": counters or {}}


@pytest.mark.parametrize("unit", ["step", "frame"])
def test_stage_readers(tmp_path, unit):
    """Each stage's device ms a unit, the syncs inside the unit's span (not
    the one outside it), and the counters a unit by the program's count."""
    names = TRAIN_STAGES if unit == "step" else SERVE_STAGES
    by_span = stages.read(span_trace(tmp_path / "t.json", unit, names))
    assert by_span["unit_syncs"] == 1.0
    assert sum(by_span["syncs"].values()) == 1.5
    key = unit + "s"
    counters = {"units": 10, "seconds": 2.0,
                "counters": {key: 10, "wait_s": 0.05, "dispatch_s": 0.4}}
    ctx = _ctx(unit, by_span, counters)
    got = {m: trace.load_reader(m)(ctx) for m in NEW[unit]}
    suffix = ".train" if unit == "step" else ".serve"
    for i, name in enumerate(names):
        assert got[f"{name}_ms{suffix}"] == pytest.approx((i + 1) * 0.01)
    assert got[NEW[unit][-2]] == 1.0
    assert got[NEW[unit][-1]] == pytest.approx(5.0)
    # The other kind of unit reads nothing here.
    other = "frame" if unit == "step" else "step"
    assert all(trace.load_reader(m)(ctx) is None for m in NEW[other])


@pytest.mark.parametrize("unit", ["step", "frame"])
def test_nothing_to_read(tmp_path, unit):
    """A program without spans or counters: every new reader returns
    None (and the metric is left out of the line)."""
    assert stages.read(_trace(tmp_path)) == {}
    for ctx in (_ctx(unit, {}), {"unit": unit, "units": 2, "spans": {}}):
        assert all(trace.load_reader(m)(ctx) is None for m in NEW[unit])
    by_span = stages.read(span_trace(tmp_path / "t.json", unit, ["features"]))
    assert readers.stage_ms(_ctx(unit, by_span), unit, "heads") is None
    assert readers.counter_ms(_ctx(unit, by_span, {"counters": {}}), unit,
                              "wait_s") is None


def _recorded(monkeypatch, unit, names):
    """A CPU run's traced part with a recorded trace in place of the
    card's: the units run on the CPU, then the trace is written."""
    def profile(fn, path):
        fn()
        span_trace(Path(path), unit, names)

    monkeypatch.setattr(trace, "profile", profile)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("workload", ["transfer.train.b16",
                                      "transfer.serve.frame"])
def test_traced_run_reports_the_new_metrics(workload, monkeypatch):
    """A whole --trace 1 run on the CPU (the cells at the tests' size, a
    recorded trace standing in for the card's): the drivers hand the
    readers the trace's stages and the window's own counters, so each of
    the cell's new metrics is a number in the result line, and the
    recorded trace file is gone."""
    sp = tiny(workload)
    unit = "step" if sp["traffic"]["driver"] == "train" else "frame"
    _recorded(monkeypatch, unit,
              TRAIN_STAGES if unit == "step" else SERVE_STAGES)
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", workload, "--seed", "3000000019",
                         "--seconds", "0.5", "--trace", "1"],
                        device="cpu", spec=sp) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert not list(Path(tempfile.gettempdir()).glob(
        f"portbench_trace_{os.getpid()}.json"))
    names = {m["name"] for m in sp["per_layer"]}
    assert set(NEW[unit]) <= names
    for m in NEW[unit]:
        assert line["metrics"][m]["value"] >= 0, m
    assert line["metrics"][NEW[unit][-2]]["value"] == 1.0
    assert line["metrics"][NEW[unit][-1]]["value"] > 0
    assert line["correct"] is True


# -- fused attention in the FLOP yardstick -----------------------------------
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _attention(q, k, v, mask, explicit):
    if not explicit:
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=k.shape[1] != q.shape[1])
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    return (s if mask is None else s + mask).softmax(-1) @ v


def _count(shape, kv_heads, mask, grad, explicit, log=None):
    b, h, n, d = shape
    dev = "meta" if explicit else "cpu"
    q = torch.randn(b, h, n, d, device=dev, requires_grad=grad)
    k, v = (torch.randn(b, kv_heads, n, d, device=dev, requires_grad=grad)
            for _ in range(2))
    m = None if mask is None else torch.randn(mask, device=dev)
    counter = work.FlopCounter()
    with (torch.enable_grad() if grad else torch.inference_mode()), counter:
        with log if log is not None else torch.enable_grad():
            out = _attention(q, k, v, m, explicit)
            if grad:
                out.sum().backward()
    return counter.total


# ViTDet-B's attention at 1024x1024: 25 windows of 14x14 tokens an image
# (two images), and one global block over 4,096 tokens; 12 heads of 64.
SHAPES = {"windowed": ((50, 12, 196, 64), (50, 12, 196, 196)),
          "global": ((1, 12, 4096, 64), (4096, 4096))}


@pytest.mark.parametrize("grad", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_attention_counts_as_its_matmuls(shape, masked, grad):
    """F.scaled_dot_product_attention, forward and backward or under
    inference mode, with or without a float bias, is charged exactly
    what the same attention written as matrix products is: 2 B H Lq Lk
    (D + Dv) forward, twice that backward."""
    dims, mask = SHAPES[shape]
    mask = mask if masked else None
    log = _Ops()
    fused = _count(dims, dims[1], mask, grad, False, log)
    explicit = _count(dims, dims[1], mask, grad, True)
    b, h, n, d = dims
    assert fused == explicit == 2.0 * b * h * n * n * 2 * d * (
        3 if grad else 1)
    # The fused op reached the counter (inference mode hands it the
    # composite, which the counter decomposes into it).
    assert "_scaled_dot_product_flash_attention_for_cpu" in log.names or \
        "scaled_dot_product_attention" in log.names


def test_fused_attention_issue_shape():
    """B=2, H=12, N=196, D=64 with a float mask, forward and backward:
    708,083,712 FLOPs, fused or as matrix products."""
    dims, mask = (2, 12, 196, 64), (2, 12, 196, 196)
    assert _count(dims, 12, mask, True, False) == 708_083_712
    assert _count(dims, 12, mask, True, True) == 708_083_712


def test_grouped_kv_heads_count_as_the_query_heads():
    """Key and value with 4 heads under a query's 12 count as 12, as the
    same attention with the key and value repeated does."""
    dims = (2, 12, 196, 64)
    assert _count(dims, 4, None, True, False) == \
        _count(dims, 4, None, True, True) == 2.0 * 2 * 12 * 196 ** 2 * 128 * 3


# -- a kernel's roofline from new files only ----------------------------------
def scaled_add(x, y):
    """An op the models would look up here (the test's stand-in)."""
    return x + 2.0 * y


WORK_FILE = '''def work(args, kwargs):
    x = args[0]
    n = x.numel() * x.element_size()
    return {"fwd": (3.0 * n, 2.0 * x.numel()), "bwd": (0.0, 0.0)}
'''


def test_op_from_its_own_files(tmp_path, monkeypatch):
    """An op declared only in metrics/ops/<file>.json, its work function
    named by path in a file of its own: wrapped where it is looked up,
    charged to the FLOP counter, its least seconds counted, and its
    roofline read by op_roofline; kernel_roofline (K1-K6) leaves it
    out, and K1-K6's ops are the ones of ops.json, in its order."""
    import portbench.tests.test_portbench_layers as here

    ops_dir = tmp_path / "metrics" / "ops"
    ops_dir.mkdir(parents=True)
    shutil.copy(spec.HERE / "metrics" / "ops.json",
                tmp_path / "metrics" / "ops.json")
    (ops_dir / "scaled_add_work.py").write_text(WORK_FILE)
    (ops_dir / "scaled_add.json").write_text(json.dumps({"ops": [{
        "label": "scaled_add",
        "work": "metrics/ops/scaled_add_work.py:work",
        "at": [f"{here.__name__}:scaled_add"]}]}))
    k1_k6 = trace.op_list()
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert [o["label"] for o in trace.op_list()] == \
        [o["label"] for o in k1_k6] + ["scaled_add"]

    log = trace.OpLog()
    x = torch.ones(1000, dtype=torch.float32)
    original = here.scaled_add
    with trace.wrapped_ops(log):
        assert here.scaled_add is not original
        counter = work.FlopCounter()
        log.counter = counter
        with counter:
            torch.testing.assert_close(here.scaled_add(x, x), 3.0 * x)
        log.counter = None
    assert here.scaled_add is original
    assert counter.total == 2000.0
    least = trace.op_work(log)
    assert least == {trace.OP + "scaled_add": 12000 / work.HBM_BYTES_PER_S}

    events = [_x(trace.UNIT, 0, 1000, cat="user_annotation"),
              _x(trace.OP + "scaled_add", 100, 50, cat="user_annotation"),
              _x("cudaLaunchKernel", 110, 5, cat="cuda_runtime",
                 correlation=0),
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 8,
               "pid": 0, "tid": 7, "args": {"correlation": 0}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ctx = {"unit": "step", "units": 1, "trace": trace.read(str(path), least)}
    assert readers.op_roofline(ctx, "step", "scaled_add") == \
        pytest.approx(100 * least[trace.OP + "scaled_add"] / 8e-6)
    assert readers.op_roofline(ctx, "step", "roi_align") is None
    assert readers.op_roofline(ctx, "step", "no_such_op") is None
    assert readers.op_roofline(ctx, "frame", "scaled_add") is None
    assert readers.kernel_roofline(ctx, "step") is None


def test_work_names_stay_inside_the_benchmark():
    with pytest.raises(ValueError):
        trace.work_rule("../outside.py:work")
    with pytest.raises(ValueError):
        trace.work_rule("not_a_rule")
