"""trace.read and the per-layer readers on a small recorded trace: busy
and window time, launches, device time charged to the wrapped ops'
ranges and backward nodes by their launches' threads, idle gaps named by
the host op, and each reader's number."""

import json

import pytest

from portbench import readers, trace


def _trace(tmp_path):
    unit = {"ph": "X", "cat": "user_annotation", "name": trace.UNIT,
            "ts": 0, "dur": 1000, "pid": 1, "tid": 1}
    op = {"ph": "X", "cat": "user_annotation", "name": trace.OP + "roi_align",
          "ts": 100, "dur": 50, "pid": 1, "tid": 1}
    bwd = {"ph": "X", "cat": "cpu_op",
           "name": "autograd::engine::evaluate_function: "
                   "RoIAlignFunctionBackward",
           "ts": 600, "dur": 50, "pid": 1, "tid": 2}
    mm = {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 380,
          "dur": 200, "pid": 1, "tid": 1}
    events = [unit, op, bwd, mm]
    for corr, (launch_ts, tid, k_ts, dur) in enumerate(
            [(110, 1, 200, 100), (300, 1, 500, 200), (610, 2, 800, 100)]):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launch_ts, "dur": 5,
                       "pid": 1, "tid": tid, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel",
                       "name": f"void k{'abc'[corr]}<float>(int)", "ts": k_ts,
                       "dur": dur, "pid": 0, "tid": 7,
                       "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_read(tmp_path):
    least = {trace.OP + "roi_align": 50e-6,
             "RoIAlignFunctionBackward": 20e-6}
    t = trace.read(_trace(tmp_path), least)
    assert t["launches"] == 3
    assert t["busy_s"] == pytest.approx(400e-6)
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["op_device_s"] == pytest.approx(
        {trace.OP + "roi_align": 100e-6, "RoIAlignFunctionBackward": 100e-6})
    gaps = dict(t["idle_gaps"])
    # 0-200 and 700-800 fall between torch ops, 300-500 inside aten::mm;
    # 900-1000 after the last kernel.
    assert gaps["aten::mm"] == pytest.approx(200e-6)
    assert gaps["host: Python between torch ops"] == pytest.approx(400e-6)
    assert [k for k, _ in t["device_ops"]] == ["kb", "ka", "kc"]

    ctx = {"unit": "step", "units": 2, "trace": t, "flops_per_unit": 1e12,
           "window_units": 10, "window_s": 2.0, "peak": 989.4e12,
           "spans": {"dispatch_s": [0.01, 0.03]}}
    assert readers.launches(ctx, "step") == 1.5
    assert readers.device_ms(ctx, "step") == pytest.approx(0.2)
    assert readers.idle_share(ctx, "step") == pytest.approx(60.0)
    assert readers.kernel_roofline(ctx, "step") == pytest.approx(35.0)
    assert readers.mfu(ctx, "step") == pytest.approx(100 * 5e12 / 989.4e12)
    assert readers.span_ms(ctx, "dispatch_s") == pytest.approx(20.0)
    assert readers.launches(ctx, "frame") is None
    assert readers.mfu(dict(ctx, peak=None), "step") is None


def test_every_metric_has_a_reader():
    from portbench import spec

    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(trace.load_reader(m["name"]))


def test_every_cell_finds_its_modules():
    """Each cell's traffic names a driver, and its configuration's model
    has a part under that driver."""
    from portbench import spec

    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        sp = spec.load(w["name"])
        assert callable(spec.driver(sp).run)
        part = spec.model_part(sp)
        assert callable(part.program) and callable(part.reference)
