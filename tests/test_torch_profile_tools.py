"""The port's profiling tools (livecell_tpu_torch/tools/trace_summary.py,
profile_step.py, profile_transfer.py, roofline.py) and the byte counter
(utils/flops.py:count_bytes) on the CPU, against the JAX package's
scripts/ imported by path where a script's output is a function of its
inputs.

  * trace_summary: the same synthetic device events, written once as an
    xprof vm.trace.json.gz for JAX's script and once as a torch.profiler
    Chrome trace for the port's, print equal totals, per-kind and top-op
    tables;
  * roofline: the TINY steps' analytic FLOPs against JAX's count of the
    same step (the number its analytic_mxu_tflops rounds), within the
    terms tests/test_torch_flops.py names;
  * count_bytes: exact on a matmul, a convolution, views and in-place
    ops, and a kernel wrapper charged its inputs and outputs once.

The models are TINY (64x96 input, f32): the port's configs are
monkeypatched in the tool modules, JAX's in its config module, never
edited."""

import functools
import gzip
import importlib.util
import json
import re
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import livecell_tpu.models.transfer as jax_transfer
from livecell_tpu.config import ModelConfig as JaxModelConfig
from livecell_tpu.utils.flops import count_flops as jax_count
from livecell_tpu_torch.config import ModelConfig, TransferConfig
from livecell_tpu_torch.ops import cuda_roi_align as cra
from livecell_tpu_torch.tools import (
    bench_conv1, bench_nms, bench_roi_blocks, bench_serve,
    bench_transfer_nms, check_torch_import, profile_step, profile_transfer,
    roofline, steps, trace_summary)
from livecell_tpu_torch.utils import profiling
from livecell_tpu_torch.utils.flops import (
    ByteCounter, count_bytes, count_flops, peak_bandwidth, tensor_bytes)
from tests.test_torch_flops import dead_levels, mask_subset, nms_sweeps

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-9
# The TINY custom model with room for the scripts' 40 boxes a tile.
TINY = dict(image_height=64, image_width=96, compute_dtype="float32",
            infer_pre_topk=64, infer_post_nms=16, max_detections=16,
            det_score_thresh=0.3, max_instances=48, train_pre_topk=64,
            train_num_samples=128)
# JAX charges its Pallas kernels as grid x body, the port's wrappers the
# same (utils/flops.py): JAX's step traced with its Pallas routes.
JAX_PALLAS = dict(roi_backend="pallas", match_backend="pallas",
                  roi_precision="default", topk_backend="exact")
TINY_TRANSFER = dict(tile_height=64, tile_width=96, image_height=128,
                     image_width=192, resized_width=192,
                     rpn_pre_topk_per_level=32, rpn_post_nms=32,
                     box_batch=32, mask_slots=8, max_detections=8,
                     max_instances=48, rpn_batch=32,
                     compute_dtype="float32")
FIXED = dict(heads_all_images=True, decode_proposals=True,
             mask_train_samples=64)


def jax_script(name: str) -> types.ModuleType:
    """scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run shares the cores among workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_port(monkeypatch):
    """The tools' ModelConfig and TransferConfig at TINY size, one traced
    step."""
    custom = functools.partial(ModelConfig, **TINY)
    monkeypatch.setattr(profile_step, "TRACE_STEPS", 1)
    monkeypatch.setattr(profile_transfer, "TRACE_STEPS", 1)
    monkeypatch.setattr(profile_step, "ModelConfig", custom)
    monkeypatch.setattr(roofline, "ModelConfig", custom)
    monkeypatch.setattr(roofline, "TransferConfig", functools.partial(
        TransferConfig, **TINY_TRANSFER))


# ---------------------------------------------------------------------------
# trace_summary.
# ---------------------------------------------------------------------------

# (name, µs, jax op, aten op): JAX-style names, which both tools bucket
# alike.
OPS = [("fusion.12", 120.0, "jit(step)/add", "aten::add"),
       ("convolution.4", 300.0, "jit(step)/conv_general_dilated",
        "aten::cudnn_convolution"),
       ("fusion.7", 80.5, "jit(step)/mul", "aten::mul"),
       ("custom-call.3", 55.25, "jit(step)/pallas_call", "aten::addmm"),
       ("loop_fusion.2", 10.0, "jit(step)/reduce_sum", "aten::sum"),
       ("convolution.9", 42.0, "jit(step)/conv_general_dilated",
        "aten::cudnn_convolution")]


def write_xprof(root: Path, ops) -> None:
    """JAX's layout: plugins/profile/<run>/<host>.trace.json.gz with the
    ops on the thread named 'XLA Ops', back to back."""
    events = [{"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
               "args": {"name": "XLA Ops"}},
              {"ph": "M", "pid": 1, "tid": 3, "name": "thread_name",
               "args": {"name": "Steps"}},
              {"ph": "X", "pid": 1, "tid": 3, "name": "step", "ts": 0.0,
               "dur": 1e4}]
    ts = 0.0
    for name, dur, tf_op, _ in ops:
        events.append({"ph": "X", "pid": 1, "tid": 2, "name": name,
                       "ts": ts, "dur": dur, "args": {"tf_op": tf_op}})
        ts += dur
    d = root / "plugins" / "profile" / "2026_01_01"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def write_torch_trace(path: Path, ops, gap: float = 0.0,
                      extra=()) -> None:
    """A torch.profiler Chrome trace: each op a cpu_op, its launch (a
    cuda_runtime event) and its kernel, linked by External id and
    correlation, kernels `gap` µs apart; plus a gpu_user_annotation
    range over all of them, which must not count."""
    events, ts = [], 0.0
    for i, (name, dur, _, aten) in enumerate(ops):
        events += [
            {"ph": "X", "cat": "cpu_op", "name": aten, "pid": 7, "tid": 7,
             "ts": ts, "dur": 5.0, "args": {"External id": 100 + i}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 7, "tid": 7, "ts": ts + 1.0, "dur": 3.0,
             "args": {"correlation": 500 + i, "External id": 100 + i}},
            {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
             "ts": ts + 10.0, "dur": dur,
             "args": {"correlation": 500 + i, "External id": 100 + i,
                      "grid": [1, 1, 1], "block": [128, 1, 1]}}]
        ts += dur + gap
    events.append({"ph": "X", "cat": "gpu_user_annotation",
                   "name": "Optimizer.step", "pid": 0, "tid": 7,
                   "ts": 0.0, "dur": ts + 100.0})
    events += list(extra)
    path.write_text(json.dumps({"traceEvents": events}))


def section(text: str, title: str) -> list:
    lines = text.splitlines()
    i = lines.index(f"== {title} ==")
    out = []
    for line in lines[i + 1:]:
        if not line.strip() or line.startswith("=="):
            break
        out.append(line)
    return out


def test_trace_summary_tables_equal_jax(tmp_path, capsys, monkeypatch):
    """Equal totals (to the printed 0.01 ms), per-kind and top-op tables
    (every printed line) from the same events in each tool's format."""
    write_xprof(tmp_path / "jax", OPS)
    (tmp_path / "port").mkdir()
    write_torch_trace(tmp_path / "port" / "trace_1_2.json", OPS)
    monkeypatch.setattr("sys.argv", ["trace_summary", str(tmp_path / "jax"),
                                     "--steps", "2"])
    jax_script("trace_summary").main()
    theirs = capsys.readouterr().out
    s = trace_summary.main([str(tmp_path / "port"), "--steps", "2"])
    ours = capsys.readouterr().out
    total = re.search(r"XLA Ops total: ([\d.]+) ms \(([\d.]+) ms/step",
                      theirs).groups()
    assert re.search(r"Device total: ([\d.]+) ms \(([\d.]+) ms/step",
                     ours).groups() == total
    assert s["device_total_ms"] == pytest.approx(
        sum(d for _, d, _, _ in OPS) / 1e3, rel=1e-12)
    for title in ("by op kind", "top individual ops", "by source line"):
        assert section(ours, title) == section(theirs, title), title
    assert [r[0] for r in s["by_kind"]] == [
        "convolution", "fusion", "custom-call", "loop_fusion"]
    # "by torch op" names the aten op of each kernel's External id.
    assert dict((k, v) for k, v in s["by_op"])["aten::cudnn_convolution"] \
        == 342.0


def test_trace_summary_busy_idle_and_annotations(tmp_path):
    """Kernels 20 µs apart: the window spans the gaps, busy time is the
    kernels' union, and the annotation range over them adds nothing."""
    ops = OPS[:3]
    write_torch_trace(tmp_path / "trace_1_1.json", ops, gap=20.0)
    s = trace_summary.summarize(str(tmp_path), steps=1)
    busy = sum(d for _, d, _, _ in ops)
    assert s["busy_ms"] == pytest.approx(busy / 1e3, rel=1e-12)
    assert s["device_total_ms"] == pytest.approx(busy / 1e3, rel=1e-12)
    assert s["window_ms"] == pytest.approx((busy + 40.0) / 1e3, rel=1e-12)
    assert s["idle_share"] == pytest.approx(40.0 / (busy + 40.0), rel=1e-9)
    assert s["launches"] == 3 and s["device_events"] == 3


def test_trace_summary_overlap_kinds_and_sources(tmp_path):
    """Two streams overlapping count once in busy time; a templated
    kernel name is bucketed by its bare name; a kernel's source line is
    the innermost Python frame outside torch around its launch (not a
    sibling frame that ended before it, nor a module annotation); a
    memcpy counts as a device event but not as a launch."""
    name = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >"
            "(int, at::native::FillFunctor<float>, "
            "at::detail::Array<char*, 1>)")
    frames = [("chip_smoke.py(10): <module>", -10.0, 1000.0, 1, None),
              ("torch/nn/modules/module.py(1): _call_impl", -9.0, 998.0, 2,
               1),
              ("livecell_tpu_torch/models/fpn.py(25): forward", -8.0, 990.0,
               3, 2),
              ("livecell_tpu_torch/ops/boxes.py(9): area", -7.5, 2.0, 5, 3),
              ("torch/nn/functional.py(5): interpolate", -7.0, 900.0, 4, 3),
              ("nn.Module: Upsample_1", -6.5, 800.0, 6, 4)]
    extra = [{"ph": "X", "cat": "python_function", "name": n, "pid": 7,
              "tid": 7, "ts": ts, "dur": dur,
              "args": {"Python id": i, "Python parent id": p}}
             for n, ts, dur, i, p in frames]
    extra.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
                  "pid": 0, "tid": 8, "ts": 15.0, "dur": 100.0, "args": {}})
    write_torch_trace(tmp_path / "trace_1_1.json",
                      [(name, 50.0, "", "aten::fill_")], extra=extra)
    s = trace_summary.summarize(str(tmp_path / "trace_1_1.json"), steps=1)
    assert s["by_kind"][0] == ["Memcpy HtoD", 100.0]
    assert s["by_kind"][1] == ["at::native::vectorized_elementwise_kernel",
                               50.0]
    assert s["top"][1][2] == "livecell_tpu_torch/models/fpn.py(25): forward"
    assert s["by_op"][1] == ["aten::fill_", 50.0]
    # Kernel 10-60 µs, memcpy 15-115 µs: busy 105 of a 105 µs window.
    assert s["busy_ms"] == pytest.approx(0.105) and s["idle_share"] == 0.0
    assert s["launches"] == 1 and s["device_events"] == 2
    assert trace_summary.kernel_kind(
        "void (anonymous namespace)::indexing_backward_kernel_stride_1"
        "<c10::BFloat16>(long const*, long, bool)") == \
        "indexing_backward_kernel_stride_"
    assert trace_summary.kernel_kind(
        "void at::native::(anonymous namespace)::cat_kernel<float>(int)") \
        == "at::native::cat_kernel"


def test_cpu_trace_has_frames_and_no_device_events(tmp_path):
    """profiling.trace(with_stack=True) records the Python frames; a trace
    taken without a card holds no device event and summarize refuses
    it."""
    a = torch.ones(16, 16)
    with profiling.trace(str(tmp_path), with_stack=True) as prof:
        (a @ a).sum()
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    assert any(e.get("cat") == "python_function" for e in events)
    assert trace_summary.newest_trace(str(tmp_path)) == prof.trace_path
    with pytest.raises(ValueError, match="no device events"):
        trace_summary.summarize(str(tmp_path))


@pytest.mark.parametrize("runs", [1, 3])
def test_per_call_ms_on_the_host(runs):
    """per_call_ms makes `warmup` calls, then `runs` runs of `calls`
    calls, and times them by the host clock off the card; sync without a
    card returns."""
    calls = []
    ms = profiling.per_call_ms(lambda: calls.append(time.sleep(1e-3)),
                               "cpu", calls=4, warmup=2, runs=runs)
    assert len(calls) == 2 + 4 * runs
    assert ms >= 1.0          # each call sleeps 1 ms
    profiling.sync("cpu")
    profiling.sync()


# ---------------------------------------------------------------------------
# count_bytes.
# ---------------------------------------------------------------------------

def test_count_bytes_exact():
    """Each aten op's inputs read and outputs written, views free; an op
    that overwrites without reading (copy_) is charged the write only."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert count_bytes(lambda: a @ b) == (8 * 16 + 16 * 4 + 8 * 4) * 4
    x, w = torch.ones(2, 5, 10, 10), torch.ones(7, 5, 3, 3)
    assert count_bytes(lambda: F.conv2d(x, w, padding=1)) == \
        (2 * 5 * 100 + 7 * 5 * 9 + 2 * 7 * 100) * 4
    assert count_bytes(lambda: (x.view(-1), x.permute(0, 2, 3, 1), a.t(),
                                x[:, :2])) == 0
    dst, src = torch.empty(4, 4), torch.ones(4, 4, dtype=torch.float64)
    assert count_bytes(lambda: dst.copy_(src)) == 16 * 8 + 16 * 4
    assert count_bytes(lambda: dst.add_(1.0)) == 2 * 16 * 4
    assert peak_bandwidth("cpu") is None


def test_count_bytes_charges_kernels_their_inputs_and_outputs():
    """K1 and K2's plain versions and their wrappers (which take the plain
    versions on the CPU) are each charged their inputs read once and
    outputs written once, whatever the plain version runs inside."""
    gen = torch.Generator().manual_seed(0)
    feat = torch.randn((2, 16, 24, 256), generator=gen)
    boxes = torch.rand((2, 5, 4), generator=gen) * 40
    boxes[..., 2:] += boxes[..., :2]
    wy, wx = cra.roi_weights_plain(boxes, (16, 24))
    out = cra.roi_align_fwd_plain(feat, wy, wx)
    want = tensor_bytes((feat, wy, wx, out))
    for fn in (cra.roi_align_fwd_plain, cra.roi_align_fwd):
        with ByteCounter() as c:
            fn(feat, wy, wx)
        assert c.total == want and dict(c.by_op) == {fn.__name__: want}
    with ByteCounter() as c:
        cra.roi_weights(boxes, (16, 24))
    assert c.total == tensor_bytes((boxes, wy, wx))


# ---------------------------------------------------------------------------
# roofline and profile_step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fixed", "transfer"])
def test_roofline_flops_match_jax(mode, tiny_port, monkeypatch):
    """The port's step FLOPs (what analytic_tensor_tflops rounds) equal
    JAX's count of its roofline.py step (what analytic_mxu_tflops
    rounds) to 1e-9 relative, once test_torch_flops.py's named terms are
    taken out: DEAD_LEVELS and MASK_SUBSET of the custom model,
    NMS_SWEEPS of the transfer model. (The quirk mode's step is counted
    against JAX's in test_torch_flops.py.)"""
    script = jax_script("roofline")
    if mode == "transfer":
        monkeypatch.setattr(jax_transfer, "TransferConfig", functools.partial(
            jax_transfer.TransferConfig, **TINY_TRANSFER,
            rpn_match_backend="pallas"))
        body, state, images, targets = script.build_transfer_step(
            1, roi_backend="pallas")
        parts = roofline.build_transfer_step(1, "cpu")
        terms = -nms_sweeps(parts[0], 1)
    else:
        body, state, images, targets = script.build_step(
            JaxModelConfig(**TINY, **JAX_PALLAS, **FIXED), 1)
        parts = roofline.build_step(ModelConfig(**TINY, **FIXED), 1, "cpu")
        terms = dead_levels(parts[0], 1) + mask_subset(parts[0].cfg, 1)
    want = jax_count(body, state, images, targets, jax.random.key(1))
    # The same draws in JAX's order.
    np.testing.assert_array_equal(parts[2].numpy(), np.asarray(images))
    np.testing.assert_array_equal(parts[3]["boxes"].numpy(),
                                  np.asarray(targets["boxes"]))
    got = count_flops(steps.copied_stepper(*parts))
    assert got == pytest.approx(want - terms, rel=REL)


def test_roofline_main_record(tiny_port, capsys):
    """The record's keys; the floor is the larger time; --stem_s2d is
    accepted and said to be ignored; the real model did not move."""
    rec = roofline.main(["--batch_size", "1", "--measure", "--steps", "1",
                         "--stem_s2d"], device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert set(rec) == {
        "mode", "batch_size", "analytic_tensor_tflops", "hbm_gbytes",
        "t_tensor_ms", "t_hbm_ms", "roofline_floor_ms", "bound", "card",
        "stem_s2d_ignored", "measured_ms_per_dispatch",
        "img_per_sec_per_dispatch", "floor_fraction"}
    assert rec["mode"] == "fixed" and rec["card"] == "the CPU"
    assert rec["roofline_floor_ms"] == max(rec["t_tensor_ms"],
                                           rec["t_hbm_ms"])
    assert rec["bound"] == ("tensor" if rec["t_tensor_ms"] >= rec["t_hbm_ms"]
                            else "hbm")
    assert rec["hbm_gbytes"] > 0 and rec["analytic_tensor_tflops"] > 0


def test_copied_stepper_leaves_the_state(tiny_port):
    """The counters run a step on a copy: the model's parameters and the
    optimizer's state stay as they were."""
    model, opt, images, targets = roofline.build_step(
        ModelConfig(**TINY), 1, "cpu")
    steps.stepper(model, opt, images, targets)()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [s["exp_avg"].clone() for s in opt.state.values()]
    run = steps.copied_stepper(model, opt, images, targets)
    assert count_bytes(run) > 0
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert all(torch.equal(s["exp_avg"], m)
               for s, m in zip(opt.state.values(), moments))


def test_profile_step_main(tiny_port, tmp_path, capsys):
    """JAX's keys and "card"; a trace with Python frames in --trace; no
    MFU on the CPU."""
    rec = profile_step.main(["--bs", "1", "--steps", "1", "--fixed",
                             "--mask_samples", "16", "--trace",
                             str(tmp_path)], device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert set(rec) == {"step_ms", "img_per_sec", "analytic_flops_per_step",
                        "mfu", "trace_dir", "card"}
    assert rec["mfu"] is None and rec["analytic_flops_per_step"] > 0
    events = json.loads(Path(trace_summary.newest_trace(str(tmp_path)))
                        .read_text())["traceEvents"]
    assert any(e.get("cat") == "python_function" for e in events)


def test_profile_step_draws_equal_jax():
    """profile_step's inputs are its JAX script's draws (boxes of all
    images at once), replayed here from the script's own lines."""
    cfg = ModelConfig(**TINY)
    images, targets = profile_step.draw_inputs(cfg, 3)
    rng = np.random.default_rng(0)
    b, h, w, i = 3, cfg.image_height, cfg.image_width, cfg.max_instances
    want_images = (rng.uniform(size=(b, h, w, 3)) * 255).astype(np.uint8)
    boxes = np.zeros((b, i, 4), np.float32)
    boxes[:, :40] = np.stack([
        rng.uniform(0, w - 60, (b, 40)), rng.uniform(0, h - 60, (b, 40)),
        rng.uniform(20, 55, (b, 40)), rng.uniform(20, 55, (b, 40))],
        axis=2)
    boxes[:, :40, 2:] += boxes[:, :40, :2]
    mask = (rng.uniform(size=(b, i, 28, 28)) > .5).astype(np.uint8) * 255
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(targets["boxes"], boxes)
    np.testing.assert_array_equal(targets["mask28"], mask)
    assert targets["valid"].sum() == 3 * 40


@pytest.mark.parametrize("scan", [False, True])
def test_profile_transfer_main(scan, tiny_port, tmp_path, capsys):
    argv = ["--bs", "1", "--steps", "1", "--trace",
            str(tmp_path) if scan else ""] + (["--scan"] if scan else [])
    rec = profile_transfer.main(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert set(rec) == {"step_ms", "img_per_sec", "analytic_flops_per_step",
                        "trace_dir", "card"}
    assert rec["analytic_flops_per_step"] > 0
    assert bool(list(tmp_path.glob("trace_*.json"))) == scan


def test_profile_transfer_refuses_jax_routes(tiny_port):
    with pytest.raises(ValueError, match="roi_backend"):
        profile_transfer.main(["--roi_backend", "pallas", "--trace", ""],
                              device="cpu")


# ---------------------------------------------------------------------------
# Every tool that runs on a device raises without one unless the caller
# asks for the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", [
    profile_step, profile_transfer, roofline, bench_serve, bench_nms,
    bench_conv1, bench_roi_blocks, bench_transfer_nms, check_torch_import])
def test_main_needs_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    argv = ["--weights", "none.pth"] if tool is check_torch_import else []
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tool.main(argv)
