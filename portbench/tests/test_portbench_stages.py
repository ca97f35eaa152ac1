"""stages.read, the split of a traced run by the program's `livecell.*`
spans, on a small recorded trace and on a real CPU profile of a tiny
transfer step: device time charged to the innermost span of each launch,
backward nodes linked to their forward op's stage, launches, host and
self time, host-blocking calls, and idle gaps named by span, CUDA call
and host op."""

import json

import pytest

from portbench import stages, trace
from portbench.tests.test_portbench_readers import _trace


def _stage_trace(tmp_path):
    """One traced step: spans on thread 1, the backward's autograd nodes
    on thread 2, launches on both, a sync and a copy. Device busy 260 of
    the 1000 us window."""
    def x(name, ts, dur, tid=1, cat="cpu_op", **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid, "args": args}

    events = [x(trace.UNIT, 0, 1000, cat="user_annotation")]
    events += [x(n, ts, dur, cat="user_annotation") for n, ts, dur in (
        ("livecell.step", 0, 900), ("livecell.features", 10, 180),
        ("livecell.heads", 200, 150), ("livecell.backward", 400, 400))]
    # An op that makes no autograd node records the number of the next
    # one: the node's forward op is the last of its number.
    events += [x("aten::to", 5, 2, **{"Sequence number": 5}),
               x("aten::conv2d", 20, 50, **{"Sequence number": 5}),
               x("aten::mm", 210, 50, **{"Sequence number": 9}),
               x("aten::add", 360, 5, **{"Sequence number": 11})]
    bwd = stages.BACKWARD
    events += [x(bwd + "ConvolutionBackward0", 410, 40, 2,
                 **{"Sequence number": 5}),
               x(bwd + "MmBackward0", 460, 40, 2, **{"Sequence number": 9}),
               x(bwd + "AddBackward0", 510, 20, 2, **{"Sequence number": 11}),
               x(bwd + "torch::autograd::AccumulateGrad", 540, 20, 2)]
    launches = [  # (launch ts, thread, device ts, dur, category)
        (30, 1, 100, 50, "kernel"), (220, 1, 250, 50, "kernel"),
        (420, 2, 600, 50, "kernel"), (470, 2, 650, 50, "kernel"),
        (515, 2, 700, 20, "kernel"), (545, 2, 720, 10, "kernel"),
        (850, 1, 850, 20, "kernel"), (950, 1, 950, 10, "gpu_memcpy")]
    for corr, (lts, tid, dts, dur, cat) in enumerate(launches):
        # cuDNN and cuBLASLt launch through the driver API.
        call = ("cuLaunchKernelEx", "cuda_driver") if corr == 1 else \
            ("cudaLaunchKernel", "cuda_runtime")
        events.append(x(call[0], lts, 3, tid, call[1], correlation=corr))
        events.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": dts,
                       "dur": dur, "pid": 0, "tid": 7,
                       "args": {"correlation": corr}})
    events.append(x("cudaStreamSynchronize", 300, 310, 1, "cuda_runtime"))
    events.append(x("cudaMemcpyAsync", 940, 5, 1, "cuda_runtime"))
    path = tmp_path / "stages.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_stages_read(tmp_path):
    """Kernels charged by correlation (runtime or driver launches)
    across threads to the innermost span of their launch; a backward
    node's to the stage of its forward op, the loss sum's and
    AccumulateGrad's to `backward (unlinked)`; the sync under the span it
    fell in; idle time by the innermost span, the CUDA call and the host
    op running at each gap's middle."""
    t = stages.read(_stage_trace(tmp_path))
    assert (t["unit"], t["units"]) == ("step", 1)
    assert t["busy_ms"] == pytest.approx(0.26)
    assert t["device_ms"] == pytest.approx({
        "livecell.features": 0.1, "livecell.heads": 0.1,
        stages.BACKWARD_UNLINKED: 0.03, "livecell.step": 0.02,
        "none": 0.01})
    assert t["launches"] == {"livecell.features": 2, "livecell.heads": 2,
                             stages.BACKWARD_UNLINKED: 2, "livecell.step": 1,
                             "none": 0}
    assert t["host_ms"] == pytest.approx({
        "livecell.step": 0.9, "livecell.backward": 0.4,
        "livecell.features": 0.18, "livecell.heads": 0.15})
    assert t["self_ms"]["livecell.step"] == pytest.approx(0.17)
    assert t["syncs"] == {"livecell.heads": 1}
    assert t["sync_calls"] == {"cudaStreamSynchronize": 1}
    # Gaps 0-100 (features), 150-250 (heads), 300-600 and 730-850
    # (backward), 870-950 and 960-1000 (no span open).
    assert t["idle_ms"] == pytest.approx({
        "livecell.backward": 0.42, "livecell.features": 0.1,
        "livecell.heads": 0.1, "none": 0.12})
    assert t["idle_calls"] == pytest.approx({"none": 0.44,
                                             "cudaStreamSynchronize": 0.3})
    assert t["idle_ops"] == pytest.approx({
        "livecell.backward | " + stages.PYTHON: 0.42,
        "livecell.features | aten::conv2d": 0.1,
        "livecell.heads | " + stages.PYTHON: 0.1,
        "none | " + stages.PYTHON: 0.12})
    assert sum(t["device_ms"].values()) + sum(t["idle_ms"].values()) == \
        pytest.approx(1.0)


def test_stages_read_nothing_without_spans(tmp_path):
    """A trace of a program without the spans: no reading."""
    assert stages.read(_trace(tmp_path)) == {}


def test_backward_nodes_of_a_cpu_step(tmp_path):
    """A real CPU profile of a TINY transfer step: each backward node
    lands in the stage of its forward op (K5's backward in the heads,
    convolutions in the trunk, the RPN head and the heads), and only
    the loss sum and AccumulateGrad are unlinked."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from livecell_tpu_torch.config import TransferConfig
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.parallel.train_step import make_step_fn
    from portbench import draws
    from portbench.tests.tiny_specs import TRANSFER

    cfg = TransferConfig(**TRANSFER, compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    model = create_transfer_model(cfg, gen, device="cpu", train=True)
    step = make_step_fn(model, torch.optim.SGD(model.parameters(), 1e-3))
    images, targets = draws.train_split(2, cfg.tile_height, cfg.tile_width,
                                        cfg.max_instances, 4, 12, 30, gen,
                                        "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        step(images, targets, generator=gen)
    path = tmp_path / "step.json"
    p.export_chrome_trace(str(path))
    nodes = stages.backward_nodes(str(path))
    by_name = {}
    for name, stage in nodes:
        by_name.setdefault(name, set()).add(stage)
    assert by_name["MSRoIAlignFunctionBackward"] == {"livecell.heads"}
    assert by_name["ConvolutionBackward0"] == {
        "livecell.features", "livecell.rpn", "livecell.heads"}
    assert {n for n, s in nodes if s == stages.BACKWARD_UNLINKED} == {
        "AddBackward0", "torch::autograd::AccumulateGrad"}
    unlinked_adds = sum(s == stages.BACKWARD_UNLINKED
                        for n, s in nodes if n == "AddBackward0")
    assert unlinked_adds == 5   # 0 + the five losses
