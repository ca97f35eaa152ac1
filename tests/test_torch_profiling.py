"""The port's profiling helpers (livecell_tpu_torch/utils/profiling.py) on
the CPU, and the spans and counters of the hot path: a TINY training
step of each model and a TINY frame of each model through the frame
predictor under a CPU profiler, `train_epoch(stats=)` and the
predictor's `run.stats`."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from livecell_tpu_torch.config import ModelConfig, TileConfig, TransferConfig
from livecell_tpu_torch.data.device_data import DeviceDataset, train_epoch
from livecell_tpu_torch.models.mask_rcnn import create_model, create_train_model
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.parallel.train_step import build_optimizer
from livecell_tpu_torch.serve.stitch import make_frame_predictor
from livecell_tpu_torch.train.train_transfer import stage_optimizer
from livecell_tpu_torch.utils import profiling

TINY_CUSTOM = ModelConfig(
    image_height=64, image_width=96, max_instances=8, train_pre_topk=64,
    train_num_samples=16, rpn_pos_per_image=16, rpn_batch_per_image=32,
    infer_pre_topk=64, infer_post_nms=16, max_detections=16,
    heads_all_images=True, decode_proposals=True, mask_train_samples=8,
    compute_dtype="float32")
TINY_TRANSFER = TransferConfig(
    tile_height=64, tile_width=96, image_height=128, image_width=192,
    resized_width=192, rpn_pre_topk_per_level=32, rpn_post_nms=32,
    box_batch=32, mask_slots=8, max_detections=8, max_instances=8,
    rpn_batch=32, compute_dtype="float32")
# 25 tiles of 96x64 pixels (transfer) or zero-padded to the custom
# model's 96x64 input.
TINY_FRAME = TileConfig(frame_width=210, frame_height=140)
STAGES = {"livecell.features", "livecell.rpn", "livecell.proposals",
          "livecell.heads"}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run shares the cores among workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(32, 32)
    with profiling.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path))
    assert any(e.get("name") == "aten::mm" for e in events)


def test_time_fn_counts_every_call():
    calls = []
    out = profiling.time_fn(lambda x: calls.append(x), 1, warmup=2, iters=5)
    assert len(calls) == 7
    assert set(out) == {"mean_s", "median_s", "min_s"}
    assert 0 <= out["min_s"] <= out["median_s"]


def test_enable_nan_debug_switches_anomaly_detection():
    try:
        profiling.enable_nan_debug(True)
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()


def traced(fn, path):
    """Run `fn` under a CPU profiler that records inputs; the trace's
    complete events."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    p.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def spans_of(events):
    return sorted((e for e in events if e["name"].startswith("livecell.")),
                  key=lambda e: e["ts"])


def test_span_is_null_without_a_profiler():
    """One shared null context, whatever the name and arguments."""
    assert not torch.autograd._profiler_enabled()
    s = profiling.span("livecell.step", 3)
    assert s is profiling.span("livecell.frame")
    with s as entered:
        assert entered is None


def test_span_records_a_range_with_its_arguments(tmp_path):
    def fn():
        with profiling.span("livecell.step", 7):
            with profiling.span("livecell.update"):
                torch.ones(4).sum()

    outer, inner = spans_of(traced(fn, tmp_path / "t.json"))
    assert (outer["name"], outer["cat"]) == ("livecell.step",
                                              "user_annotation")
    assert outer["args"]["Concrete Inputs"] == ["7"]
    assert inner["name"] == "livecell.update"
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def within(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def tiny_pool(cfg, n=4, seed=0):
    """n tiles of uint8 noise at the model's input size, 5 GT boxes of
    20-40 px in the config's slots, uint8 mask targets."""
    h, w = (cfg.tile_height, cfg.tile_width) \
        if isinstance(cfg, TransferConfig) else (cfg.image_height,
                                                 cfg.image_width)
    rng = np.random.default_rng(seed)
    slots = cfg.max_instances
    boxes = np.zeros((n, slots, 4), np.float32)
    xy = rng.uniform(0, [w - 44, h - 44], (n, slots, 2))
    boxes[..., :2] = xy
    boxes[..., 2:] = xy + rng.uniform(20, 40, (n, slots, 2))
    valid = np.zeros((n, slots), bool)
    valid[:, :5] = True
    return DeviceDataset(
        rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
        {"boxes": boxes, "valid": valid, "labels": valid.astype(np.int32),
         "mask28": (rng.integers(0, 2, (n, slots, 28, 28)) * 255).astype(
             np.uint8)}, device="cpu")


def train_case(kind):
    """(model, optimizer, pool) of a TINY training step in f32."""
    gen = torch.Generator().manual_seed(0)
    if kind == "custom":
        model = create_train_model(TINY_CUSTOM, gen, device="cpu")
        return model, build_optimizer(model, 1e-3, 1e-4, 10), \
            tiny_pool(TINY_CUSTOM)
    model = create_transfer_model(TINY_TRANSFER, gen, device="cpu",
                                  train=True)
    return model, stage_optimizer(model, 1e-3, 0.9, 5e-4, freeze=False,
                                  clip_norm=10.0), tiny_pool(TINY_TRANSFER)


def frame_case(kind):
    """The frame predictor over a TINY serving model, and a frame's
    tiles."""
    gen = torch.Generator().manual_seed(0)
    model = create_model(TINY_CUSTOM, gen, device="cpu") if kind == "custom" \
        else create_transfer_model(TINY_TRANSFER, gen, device="cpu")
    run = make_frame_predictor(model, TINY_FRAME, score_threshold=0.0,
                               device="cpu")
    rng = np.random.default_rng(1)
    tiles = rng.integers(0, 256, (TINY_FRAME.num_tiles,
                                  TINY_FRAME.tile_height,
                                  TINY_FRAME.tile_width, 3), dtype=np.uint8)
    return run, tiles


@pytest.mark.parametrize("kind", ["custom", "transfer"])
def test_training_step_spans(kind, tmp_path):
    """Two steps of an epoch: livecell.step each, numbered, with the four
    model stages, livecell.backward and livecell.update inside it, none
    of the stages inside another; one livecell.fetch_metrics after the
    steps."""
    model, opt, pool = train_case(kind)
    gen = torch.Generator().manual_seed(2)
    events = traced(lambda: train_epoch(model, opt, pool,
                                        np.array([[0, 1], [2, 3]]), gen),
                    tmp_path / "t.json")
    spans = spans_of(events)
    steps = [e for e in spans if e["name"] == "livecell.step"]
    assert [e["args"]["Concrete Inputs"] for e in steps] == [["0"], ["1"]]
    assert {e["name"] for e in spans} == STAGES | {
        "livecell.step", "livecell.backward", "livecell.update",
        "livecell.fetch_metrics"}
    for step in steps:
        inside = [e for e in spans if e is not step and within(e, step)]
        assert {e["name"] for e in inside} == STAGES | {
            "livecell.backward", "livecell.update"}
        stages = [e for e in inside if e["name"] in STAGES]
        assert not any(within(a, b) for a in stages for b in stages
                       if a is not b)
        backward = next(e for e in inside if e["name"] == "livecell.backward")
        assert all(e["ts"] + e["dur"] <= backward["ts"] for e in stages)
    fetch, = [e for e in spans if e["name"] == "livecell.fetch_metrics"]
    assert fetch["ts"] >= steps[-1]["ts"] + steps[-1]["dur"]
    # The backward's autograd nodes run inside livecell.backward.
    nodes = [e for e in events if e["name"].startswith(
        "autograd::engine::evaluate_function:")]
    assert nodes and all(any(within(n, s) for s in spans
                             if s["name"] == "livecell.backward")
                         for n in nodes)


@pytest.mark.parametrize("kind", ["custom", "transfer"])
def test_frame_spans(kind, tmp_path):
    """Two frames through dispatch and fetch: livecell.frame each,
    numbered, holding livecell.stage_in, the four model stages and
    livecell.stitch (dispatch), livecell.wait then livecell.unpack
    (fetch), in that order."""
    run, tiles = frame_case(kind)
    events = traced(lambda: [run.fetch(run.dispatch(tiles))
                             for _ in range(2)], tmp_path / "t.json")
    spans = spans_of(events)
    frames = [e for e in spans if e["name"] == "livecell.frame"]
    assert [e["args"]["Concrete Inputs"] for e in frames] == [["0"], ["1"]]
    order = ["livecell.stage_in", "livecell.features", "livecell.rpn",
             "livecell.proposals", "livecell.heads", "livecell.stitch",
             "livecell.wait", "livecell.unpack"]
    for frame in frames:
        inside = [e["name"] for e in spans if e is not frame
                  and within(e, frame)]
        # stage_in opens in dispatch (padding, the copy) and in the
        # device function (the uint8 tiles to floats).
        assert inside == order[:1] + order


@pytest.mark.parametrize("kind", ["train", "frame"])
def test_counters(kind):
    """train_epoch(stats=) adds its steps, the seconds to enqueue them
    and those blocked in the metric fetch; run.stats its frames and the
    seconds in dispatch, waiting and unpacking, without a profiler."""
    if kind == "train":
        model, opt, pool = train_case("custom")
        stats = {}
        for rows in ([[0, 1], [2, 3]], [[1, 2]]):
            train_epoch(model, opt, pool, np.array(rows),
                        torch.Generator().manual_seed(2), stats=stats)
        assert stats["steps"] == 3
        keys = ("enqueue_s", "wait_s")
    else:
        run, tiles = frame_case("transfer")
        stats = run.stats
        assert stats == {"frames": 0, "dispatch_s": 0.0, "wait_s": 0.0,
                         "unpack_s": 0.0}
        run(tiles)
        handle = run.dispatch(tiles)
        assert stats["frames"] == 1
        run.fetch(handle)
        assert stats["frames"] == 2
        keys = ("dispatch_s", "wait_s", "unpack_s")
    assert all(stats[k] > 0 for k in keys)
