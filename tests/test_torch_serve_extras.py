"""The port's serve front ends (serve/stitch.py's frame helpers,
serve/pipeline.py, serve/render.py, serve/visualize.py,
serve/explain.py, serve/app.py's server, the transfer trainer's
prediction panels) against the JAX package's on the CPU, with the same
numpy inputs.

The custom model is tests/util_torch_port.py's (64x96 input, f32, the
JAX weights converted) on tests/test_torch_serve.py's 140x98 frames (25
tiles of 60x42), tiled by the port's tiler; the transfer model
tests/test_transfer.py's TINY geometry in f32 with weights from a seed,
on a 128x84 crop cut into 4 tiles of 96x63. The port runs with
device="cpu", where its kernel wrappers take their plain versions.
"""

import dataclasses
import io
import json
import os
import socket
import sys
import threading
import time
import urllib.request

import jax
import matplotlib.axes
import numpy as np
import pytest
import torch
from PIL import Image

import livecell_tpu.config as jconfig
import livecell_tpu.serve.app as japp
import livecell_tpu.serve.explain as jexp
import livecell_tpu.serve.render as jrender
import livecell_tpu.serve.stitch as jstitch
import livecell_tpu.serve.visualize as jvis
from livecell_tpu.config import model_config_to_dict as jax_config_to_dict
from livecell_tpu.train import checkpoint as jax_checkpoint
from livecell_tpu_torch.config import TileConfig
from livecell_tpu_torch.data.png import write_gray_png
from livecell_tpu_torch.data.tiling import tile_frame
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.serve import app, explain, render, stitch, visualize
from livecell_tpu_torch.serve.pipeline import run_pipelined
from livecell_tpu_torch.train import train_transfer
from tests import test_torch_transfer as ttr
from tests import util_torch_port as up
from tests.test_torch_serve import (
    MAX_MASK_MISMATCH, SCORE, TCFG, TOL, make_frame)
from tests.test_torch_train_cli import PORT_TTINY, write_split

JAX_TCFG = jconfig.TileConfig(frame_width=TCFG.frame_width,
                              frame_height=TCFG.frame_height)
T_TCFG = TileConfig(frame_width=128, frame_height=84, tiles_per_image=4)
FRAMES = 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the test run shares the
    CPU between several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def square(x, y, s):
    return [[x, y, x + s, y, x + s, y + s, x, y + s]]


def write_frames(root, frames, tcfg_grid: int = 7):
    """Tiles of each frame under root/tiles (the port's tiler), and the
    raw tree the CLI reads GT from: root/raw/test/images/<frame>.png and
    root/raw/annotations/livecell_coco_test.json (two square cells a
    frame). Returns (tile dir, raw dir, {frame name: annotations})."""
    img_dir = root / "raw" / "test" / "images"
    img_dir.mkdir(parents=True)
    (root / "raw" / "annotations").mkdir()
    images, anns, by_name = [], [], {}
    for i, frame in enumerate(frames):
        name = f"frame{i}.png"
        write_gray_png(img_dir / name, frame[..., 0])
        mine = [{"id": 10 * i + k, "image_id": i + 1, "category_id": 1,
                 "segmentation": square(10 + 30 * k, 12 + 20 * k, 16),
                 "bbox": [10 + 30 * k, 12 + 20 * k, 16, 16], "area": 256,
                 "iscrowd": 0} for k in range(2)]
        info = {"id": i + 1, "file_name": name, "width": frame.shape[1],
                "height": frame.shape[0]}
        tile_frame(frame, info, mine, root / "tiles", i * 25,
                   grid_size=tcfg_grid)
        images.append(info)
        anns += mine
        by_name[f"frame{i}"] = mine
    (root / "raw" / "annotations" / "livecell_coco_test.json").write_text(
        json.dumps({"images": images, "annotations": anns,
                    "categories": [{"id": 1, "name": "cell"}]}))
    return root / "tiles", root / "raw", by_name


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiled")
    frames = [make_frame(seed) for seed in range(FRAMES)]
    tiles, raw, anns = write_frames(root, frames)
    return dict(frames=frames, tiles=tiles, raw=raw, anns=anns)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(a JAX checkpoint of the test variables with its sidecar, the
    port's checkpoint of the same variables converted)."""
    root = tmp_path_factory.mktemp("ckpts")
    v = up.jax_variables()
    jpath = str(root / "jax_ckpt")
    jax_checkpoint.save(jpath, v["params"], v["batch_stats"],
                        model_config=jax_config_to_dict(up.JAX_CFG))
    ppath = str(root / "port_ckpt")
    app.save_model(up.port_model(), ppath)
    return jpath, ppath


@pytest.fixture(scope="module")
def transfer_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("transfer") / "ckpt")
    model = create_transfer_model(ttr.PCFG, torch.Generator().manual_seed(0),
                                  device="cpu")
    app.save_model(model, path)
    return path, model


def assert_masks_close(got, want):
    """Thresholded f32 probabilities: at most 0.1% of pixels flip."""
    assert got.shape == want.shape
    if got.size:
        assert np.mean(got != want) <= MAX_MASK_MISMATCH


def assert_dets_close(got, want):
    """Port vs JAX stitched detections of the same weights: f32 boxes and
    scores of the same selections within rtol/atol 1e-4, the same
    source tiles, masks within assert_masks_close."""
    assert len(got.scores) >= 2 and len(got.scores) == len(want.scores)
    np.testing.assert_allclose(got.boxes, want.boxes, **TOL)
    np.testing.assert_allclose(got.scores, want.scores, **TOL)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.tile_nums, want.tile_nums)
    assert_masks_close(got.masks, want.masks)


def assert_same_dets(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def png_pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


# ---------------------------------------------------------------------------
# Stitch helpers.
# ---------------------------------------------------------------------------

def test_stitch_helpers_match_jax(tiled):
    """group_tiles_by_image, load_tiles (the port's PNG decoder against
    PIL's convert("RGB")) and reconstruct_full_image equal JAX's bit for
    bit; the frame comes back where tiles cover it."""
    got = stitch.group_tiles_by_image(str(tiled["tiles"]))
    assert got == jstitch.group_tiles_by_image(str(tiled["tiles"]))
    assert sorted(got) == [f"frame{i}" for i in range(FRAMES)]
    assert stitch.group_tiles_by_image(str(tiled["tiles"] / "no")) == {}
    for i, name in enumerate(sorted(got)):
        info = got[name]
        assert [t["tile_num"] for t in info] == list(range(25))
        tiles = stitch.load_tiles(info, TCFG)
        np.testing.assert_array_equal(tiles,
                                      jstitch.load_tiles(info, JAX_TCFG))
        # A missing tile stays zero-filled in both.
        part = stitch.load_tiles(info[1:], TCFG)
        assert not part[0].any()
        np.testing.assert_array_equal(part,
                                      jstitch.load_tiles(info[1:], JAX_TCFG))
        full = stitch.reconstruct_full_image(tiles, TCFG)
        np.testing.assert_array_equal(
            full, jstitch.reconstruct_full_image(tiles, JAX_TCFG))
        frame = tiled["frames"][i]
        np.testing.assert_array_equal(full, frame.astype(np.float32) / 255.0)


# ---------------------------------------------------------------------------
# The pipeline: JAX's tests/test_pipeline.py replayed on the port's
# run_pipelined.
# ---------------------------------------------------------------------------

def case_order(tmp_path):
    seen = []
    stats = run_pipelined(list(range(7)), decode_fn=lambda i: i * 10,
                          predict_fn=lambda t: seen.append(t) or t + 1,
                          consume_fn=None)
    assert seen == [i * 10 for i in range(7)]
    assert stats.frames == 7 and not stats.errors


def case_consume_receives(tmp_path):
    got = []
    run_pipelined(["a", "b"], decode_fn=lambda i: i + "_tiles",
                  predict_fn=lambda t: t + "_dets",
                  consume_fn=lambda item, tiles, dets:
                  got.append((item, tiles, dets)))
    assert sorted(got) == [("a", "a_tiles", "a_tiles_dets"),
                           ("b", "b_tiles", "b_tiles_dets")]


def case_decode_error(tmp_path):
    def decode(i):
        if i == 1:
            raise ValueError("bad png")
        return i

    stats = run_pipelined([0, 1, 2], decode, lambda t: t, None)
    assert stats.frames == 2 and len(stats.errors) == 1
    assert stats.errors[0][0] == 1
    assert isinstance(stats.errors[0][1], ValueError)


def case_consume_error(tmp_path):
    def consume(item, tiles, dets):
        if item == 2:
            raise RuntimeError("figure failed")

    stats = run_pipelined([1, 2, 3], lambda i: i, lambda t: t, consume)
    assert stats.frames == 3 and [it for it, _ in stats.errors] == [2]


def case_overlap(tmp_path):
    """0.02 s a stage: serial is n * 0.06 s, the pipeline well under."""
    n, dt = 8, 0.02

    def sleep_stage(x):
        time.sleep(dt)
        return x

    t0 = time.perf_counter()
    stats = run_pipelined(list(range(n)), sleep_stage, sleep_stage,
                          lambda *a: time.sleep(dt))
    wall = time.perf_counter() - t0
    assert wall < n * 3 * dt * 0.75, wall
    assert stats.decode_s >= n * dt * 0.9
    assert stats.device_s >= n * dt * 0.9
    assert stats.overlay_s >= n * dt * 0.9
    d = stats.as_dict()
    assert d["frames"] == n and d["pipelined_fps"] > 0


def case_device_single_threaded(tmp_path):
    caller = threading.get_ident()
    threads = set()

    def predict(t):
        threads.add(threading.get_ident())
        return t

    run_pipelined(list(range(5)), lambda i: i, predict, None)
    assert threads == {caller}


def case_double_buffered_fetch(tmp_path):
    """dispatch(N+1) precedes fetch(N); every handle fetched once, in
    order."""
    events, got = [], []
    stats = run_pipelined(
        [0, 1, 2, 3], decode_fn=lambda i: i,
        predict_fn=lambda t: events.append(("dispatch", t)) or ("h", t),
        consume_fn=lambda item, tiles, dets: got.append((item, dets)),
        fetch_fn=lambda h: events.append(("fetch", h[1])) or h[1] * 100)
    assert stats.frames == 4 and not stats.errors
    assert sorted(got) == [(i, i * 100) for i in range(4)]
    for n in range(1, 4):
        assert events.index(("dispatch", n)) < events.index(("fetch", n - 1))
    assert [e for e in events if e[0] == "fetch"] == \
        [("fetch", i) for i in range(4)]


def case_overlay_figures_concurrently(tmp_path):
    """visualize_with_ground_truth (matplotlib's object-oriented figure)
    is safe on the overlay pool: four concurrent builds, four PNGs."""
    tcfg = TileConfig(frame_width=64, frame_height=48, tiles_per_image=4)
    tiles, dets = small_frame(visualize.StitchedDetections, tcfg)

    stats = run_pipelined(
        ["f0", "f1", "f2", "f3"], lambda n: n, lambda n: n,
        lambda item, t, d: visualize.visualize_with_ground_truth(
            item, None, [], [dets], [tiles], ["m"], save_dir=str(tmp_path),
            tile_cfg=tcfg, renderer="mpl"))
    assert not stats.errors, stats.errors
    for n in ("f0", "f1", "f2", "f3"):
        p = tmp_path / f"{n}_GT_VS_PREDICTIONS.png"
        assert p.exists() and p.stat().st_size > 1000


PIPELINE_CASES = {f.__name__[5:]: f for f in (
    case_order, case_consume_receives, case_decode_error, case_consume_error,
    case_overlap, case_device_single_threaded, case_double_buffered_fetch,
    case_overlay_figures_concurrently)}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_pipeline_contract(case, tmp_path):
    PIPELINE_CASES[case](tmp_path)


def test_frame_predictor_pipelined_equals_serial():
    """The TINY custom model's frame predictor through run_pipelined
    (frame N+1 dispatched before frame N is fetched) gives each frame's
    serial run() bit for bit; 4 tiles of 96x63 a 128x84 frame."""
    tcfg = T_TCFG
    run = stitch.make_frame_predictor(up.port_model(), tcfg,
                                      score_threshold=SCORE, device="cpu")
    frames = {seed: make_frame(seed)[:tcfg.frame_height, :tcfg.frame_width]
              for seed in range(3)}

    def cut(seed):
        frame = frames[seed]
        tiles = np.zeros((tcfg.num_tiles, tcfg.tile_height, tcfg.tile_width,
                          3), np.uint8)
        for t in range(tcfg.num_tiles):
            c0, r0 = stitch.tile_position(t, tcfg.tiles_per_row)
            x0, y0 = c0 * tcfg.mini_tile_width, r0 * tcfg.mini_tile_height
            patch = frame[y0:y0 + tcfg.tile_height, x0:x0 + tcfg.tile_width]
            tiles[t, :patch.shape[0], :patch.shape[1]] = patch
        return tiles

    got = {}
    stats = run_pipelined(
        list(frames), cut, run.dispatch,
        lambda seed, tiles, dets: got.setdefault(seed, dets),
        fetch_fn=run.fetch)
    assert stats.frames == len(frames) and not stats.errors
    for seed in frames:
        want = run(cut(seed))
        assert len(want.scores) >= 2
        assert_same_dets(got[seed], want)


# ---------------------------------------------------------------------------
# Rendering.
# ---------------------------------------------------------------------------

def small_frame(dets_type, tcfg):
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 255, (tcfg.num_tiles, tcfg.tile_height,
                                  tcfg.tile_width, 3), dtype=np.uint8)
    masks = np.zeros((2, tcfg.tile_height, tcfg.tile_width), bool)
    masks[0, 4:12, 4:12] = True
    masks[1, 2:9, 10:20] = True
    return tiles, dets_type(
        boxes=np.array([[4, 4, 12, 12], [36, 2, 46, 9]], np.float32),
        scores=np.array([0.9, 0.7], np.float32), masks=masks,
        offsets=np.array([[0, 0], [26, 0]], np.int64),
        tile_nums=np.array([0, 1], np.int64))


def test_composite_and_instance_overlay_match_jax():
    rng = np.random.default_rng(3)
    masks = [rng.uniform(size=(20, 30)) > 0.6 for _ in range(23)]
    offsets = rng.integers(-5, 60, (23, 2))
    for offs in (offsets, None):
        got = render.instance_overlay(masks, offs, (48, 70), alpha=0.4)
        np.testing.assert_array_equal(
            got, jrender.instance_overlay(masks, offs, (48, 70), alpha=0.4))
    base = rng.integers(0, 255, (48, 70, 3), dtype=np.uint8)
    for b in (base, base[..., 0]):
        np.testing.assert_array_equal(render.composite(b, got),
                                      jrender.composite(b, got))
    np.testing.assert_array_equal(render.TAB20, jrender.TAB20)


def test_render_panels_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    panels = [(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), "GT", []),
              (rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), "model",
               [(10.0, 12.0, "0.91"), (40.5, 30.0, "0.55")])]
    got = render.render_panels(panels, "title", str(tmp_path / "p.png"))
    want = jrender.render_panels(panels, "title", str(tmp_path / "j.png"))
    np.testing.assert_array_equal(png_pixels(got), png_pixels(want))


@pytest.mark.parametrize("renderer", ["fast", "mpl"])
def test_visualize_with_ground_truth_matches_jax(renderer, tmp_path):
    """Both renderers, with a raw frame and polygon GT: the same decoded
    pixels as JAX's."""
    tcfg = TileConfig(frame_width=64, frame_height=48, tiles_per_image=4)
    jtcfg = jconfig.TileConfig(frame_width=64, frame_height=48,
                               tiles_per_image=4)
    tiles, dets = small_frame(visualize.StitchedDetections, tcfg)
    _, jdets = small_frame(jstitch.StitchedDetections, tcfg)
    orig = np.random.default_rng(5).integers(0, 255, (48, 64, 3),
                                             dtype=np.uint8)
    anns = [{"segmentation": [[2.0, 2.0, 10.0, 2.0, 10.0, 10.0, 2.0, 10.0]]},
            {"segmentation": square(30, 20, 9)}]
    kw = dict(save_dir=str(tmp_path / "port"), tile_cfg=tcfg,
              renderer=renderer)
    got = visualize.visualize_with_ground_truth(
        "f", orig, anns, [dets, dets], [tiles, tiles], ["a", "b"], **kw)
    want = jvis.visualize_with_ground_truth(
        "f", orig, anns, [jdets, jdets], [tiles, tiles], ["a", "b"],
        **dict(kw, save_dir=str(tmp_path / "jax"), tile_cfg=jtcfg))
    assert got.endswith("f_GT_VS_PREDICTIONS.png")
    np.testing.assert_array_equal(png_pixels(got), png_pixels(want))
    blank = visualize.visualize_with_ground_truth(
        "g", None, [], [dets], [tiles], ["a"], **kw)
    jblank = jvis.visualize_with_ground_truth(
        "g", None, [], [jdets], [tiles], ["a"],
        **dict(kw, save_dir=str(tmp_path / "jax"), tile_cfg=jtcfg))
    np.testing.assert_array_equal(png_pixels(blank), png_pixels(jblank))


def test_gt_overlay_matches_jax():
    anns = [{"segmentation": square(3, 4, 12)},
            {"segmentation": {"size": [48, 64],
                              "counts": [100, 20, 400, 35, 2517]}},
            {"segmentation": None}]
    got, n = visualize.create_gt_mask_overlay(anns, (48, 64))
    want, jn = jvis.create_gt_mask_overlay(anns, (48, 64))
    assert n == jn == 2
    np.testing.assert_array_equal(got, want)


def test_prediction_panels_match_jax(tmp_path):
    """The same stats dict, exactly, and the same pixels."""
    rng = np.random.default_rng(6)
    image = rng.uniform(size=(42, 60, 3)).astype(np.float32)
    gt = np.array([[2, 3, 20, 25], [30, 5, 55, 30], [5, 30, 15, 40]],
                  np.float32)
    pred = gt[[0, 1, 1]] + rng.normal(0, 2, (3, 4)).astype(np.float32)
    scores = np.array([0.9, 0.6, 0.3], np.float32)
    for img in (image, (image * 255).astype(np.uint8)):
        got = visualize.prediction_panels(img, gt, pred, scores,
                                          str(tmp_path / "p.png"))
        want = jvis.prediction_panels(img, gt, pred, scores,
                                      str(tmp_path / "j.png"))
        assert got == want and got["pred_instances"] == 2
        np.testing.assert_array_equal(png_pixels(tmp_path / "p.png"),
                                      png_pixels(tmp_path / "j.png"))
    empty = visualize.prediction_panels(image, gt[:0], pred, scores,
                                        str(tmp_path / "e.png"))
    assert empty == jvis.prediction_panels(image, gt[:0], pred, scores,
                                           str(tmp_path / "f.png"))


def test_render_overlay_matches_jax():
    rng = np.random.default_rng(7)
    image = rng.integers(0, 255, (42, 60, 3), dtype=np.uint8)
    masks = rng.uniform(size=(3, 42, 60)) > 0.7
    masks[2] = False
    boxes = np.zeros((3, 4), np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    for n in (3, 0):
        got = app.render_overlay(image, boxes[:n], scores[:n], masks[:n])
        np.testing.assert_array_equal(
            got, japp.render_overlay(image, boxes[:n], scores[:n],
                                     masks[:n]))


# ---------------------------------------------------------------------------
# The visualize CLI.
# ---------------------------------------------------------------------------

def capture_consume(monkeypatch, module, into: dict):
    """The module's visualize_with_ground_truth, recording each frame's
    detections before drawing."""
    real = module.visualize_with_ground_truth

    def record(base_name, original_img, annotations, results, *a, **kw):
        into[base_name] = (results, original_img, annotations)
        return real(base_name, original_img, annotations, results, *a, **kw)

    monkeypatch.setattr(module, "visualize_with_ground_truth", record)


def test_visualize_main_matches_jax(tiled, ckpts, tmp_path, monkeypatch):
    """Both CLIs over the same tiled frames and raw tree with the same
    weights: per frame, the port's detections are JAX's, within
    assert_dets_close, and one panel PNG a frame is written."""
    jpath, ppath = ckpts
    argv = ["--test_dir", str(tiled["tiles"]), "--data_dir",
            str(tiled["raw"]), "--score_threshold", str(SCORE)]
    jgot, pgot = {}, {}
    real = jconfig.Config
    monkeypatch.setattr(jvis, "Config",
                        lambda: real(tile=JAX_TCFG, model=up.JAX_CFG))
    capture_consume(monkeypatch, jvis, jgot)
    capture_consume(monkeypatch, visualize, pgot)
    with jax.default_matmul_precision("highest"):
        jvis.main(argv + ["--model1_path", jpath, "--output_dir",
                          str(tmp_path / "jax")])
    stats = visualize.main(argv + ["--model1_path", ppath, "--output_dir",
                                   str(tmp_path / "port")],
                           tile_cfg=TCFG, device="cpu")
    assert stats.frames == FRAMES and not stats.errors
    assert sorted(pgot) == sorted(jgot) == sorted(tiled["anns"])
    for name, (results, raw, anns) in pgot.items():
        jresults, jraw, janns = jgot[name]
        assert len(results) == 1
        assert_dets_close(results[0], jresults[0])
        np.testing.assert_array_equal(raw, jraw)
        assert anns == janns == tiled["anns"][name]
        assert (tmp_path / "port" / f"{name}_GT_VS_PREDICTIONS.png").exists()
    assert len(list((tmp_path / "port").iterdir())) == FRAMES


def test_visualize_main_transfer_is_serial_predictor(transfer_ckpt,
                                                     tmp_path, monkeypatch):
    """The transfer model through the CLI's pipelined loop gives the
    port's serial frame predictor's detections bit for bit (JAX's
    predictor scales transfer boxes down, ROADMAP Queue 3)."""
    path, model = transfer_ckpt
    frame = np.ascontiguousarray(make_frame(0)[:T_TCFG.frame_height,
                                               :T_TCFG.frame_width])
    tiles_dir, raw, _ = write_frames(tmp_path, [frame], tcfg_grid=4)
    got = {}
    capture_consume(monkeypatch, visualize, got)
    stats = visualize.main(
        ["--model1_path", path, "--model1_type", "transfer", "--test_dir",
         str(tiles_dir), "--data_dir", str(raw), "--score_threshold", "0.0",
         "--output_dir", str(tmp_path / "out")], tile_cfg=T_TCFG,
        device="cpu")
    assert stats.frames == 1 and not stats.errors
    run = stitch.make_frame_predictor(model, T_TCFG, score_threshold=0.0,
                                      device="cpu")
    tiles = stitch.load_tiles(
        stitch.group_tiles_by_image(str(tiles_dir))["frame0"], T_TCFG)
    want = run(tiles)
    assert len(want.scores) >= 2
    assert_same_dets(got["frame0"][0][0], want)


def test_load_model_rules(ckpts, transfer_ckpt):
    """A custom checkpoint takes the dense flags over its stored config;
    a model_type that disagrees raises; so do dense flags on a transfer
    checkpoint."""
    _, ppath = ckpts
    tpath, _ = transfer_ckpt
    dense = visualize.apply_dense_flags(visualize.ModelConfig(), dets=8,
                                        infer_nms=0.6)
    model = visualize.load_model(ppath, "custom", mcfg=dense, device="cpu")
    assert model.cfg == dataclasses.replace(
        up.PORT_CFG, infer_pre_topk=40, infer_post_nms=8, max_detections=8,
        infer_nms_thresh=0.6)
    plain = visualize.load_model(ppath, "custom",
                                 mcfg=visualize.ModelConfig(), device="cpu")
    assert plain.cfg == up.PORT_CFG
    assert visualize.load_model(tpath, "transfer",
                                mcfg=visualize.ModelConfig(),
                                device="cpu").cfg == ttr.PCFG
    with pytest.raises(ValueError, match="model_type"):
        visualize.load_model(tpath, "custom", device="cpu")
    with pytest.raises(ValueError, match="custom model only"):
        visualize.load_model(tpath, "transfer", mcfg=dense, device="cpu")
    with pytest.raises(ValueError, match="Unknown model_type"):
        visualize.load_model(ppath, "unet", device="cpu")


# ---------------------------------------------------------------------------
# The explainer.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def explained(tmp_path_factory):
    """Both explain_image dashboards of one tile, with each side's
    capture_activations output and the metrics panel's text recorded."""
    root = tmp_path_factory.mktemp("explain")
    img = np.ascontiguousarray(make_frame(0)[:up.CFG_KW["image_height"],
                                             :up.CFG_KW["image_width"]])
    pmodel = up.port_model()
    jmodel = up.jax_model()
    # GT: two of the port's own detections (true positives) and one box
    # no detection reaches (a false negative).
    det, _ = explain.capture_activations(pmodel, img / np.float32(255.0))
    keep = det.valid[0] & (det.scores[0] > SCORE)
    assert keep.sum() >= 3
    gt = np.concatenate([det.boxes[0][keep][:2],
                         [[0.0, 0.0, 3.0, 3.0]]]).astype(np.float32)
    out = {"gt": gt}
    texts = []
    real_text = matplotlib.axes.Axes.text

    def text(self, x, y, s, *a, **kw):
        if str(s).startswith("TP:"):
            texts.append(s)
        return real_text(self, x, y, s, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matplotlib.axes.Axes, "text", text)
        for side, mod, call in (
                ("jax", jexp, lambda p: jexp.explain_image(
                    jmodel, up.jax_variables(), img, gt, p, SCORE)),
                ("port", explain, lambda p: explain.explain_image(
                    pmodel, img, gt, p, SCORE))):
            real = mod.capture_activations

            def record(*a, _real=real, _side=side):
                out[_side] = _real(*a)
                return out[_side]

            mp.setattr(mod, "capture_activations", record)
            with jax.default_matmul_precision("highest"):
                out[side + "_png"] = call(str(root / f"{side}.png"))
    out["texts"] = texts
    out["cfg"] = pmodel.cfg
    return out


def jax_acts(out):
    _, inter = out["jax"]
    inter = inter.get("intermediates", inter)
    return {name: jexp._fetch(inter, path) for name, path in jexp.STAGE_KEYS}


def test_capture_activations_match_jax(explained):
    """All twelve stages captured, NHWC, each within 1e-4 of its largest
    magnitude of JAX's capture_intermediates (f32); the detections
    too."""
    det, acts = explained["port"]
    want = jax_acts(explained)
    assert [k for k, _ in explain.STAGE_KEYS] == [k for k, _ in
                                                  jexp.STAGE_KEYS]
    assert all(v is not None for v in acts.values()) and len(acts) == 12
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        assert acts[name].shape == w.shape, name
        scale = float(np.abs(w).max())
        assert np.abs(acts[name] - w).max() <= 1e-4 * scale, name
    jdet, _ = explained["jax"]
    np.testing.assert_array_equal(det.valid, jdet.valid)
    np.testing.assert_allclose(det.boxes, jdet.boxes, **TOL)
    np.testing.assert_allclose(det.scores, jdet.scores, **TOL)


def test_importance_and_proposals_match_jax(explained):
    """Importance percentages within 1e-4 (points of percent), summing to
    100 within 1e-3; the top-50 RPN anchors the same boxes."""
    _, acts = explained["port"]
    want = jexp.importance_percentages(jax_acts(explained))
    got = explain.importance_percentages(acts)
    assert got.keys() == want.keys() and len(got) == 12
    assert abs(sum(got.values()) - 100.0) < 1e-3
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-4, k
    _, inter = explained["jax"]
    jprops = jexp.top_rpn_proposals(inter.get("intermediates", inter),
                                    up.JAX_CFG)
    # The 50th and 51st objectness values must not be within f32 noise.
    obj = np.sort(acts["rpn"].reshape(-1))[::-1]
    assert obj[49] - obj[50] > 1e-4 * np.abs(obj).max()
    props = explain.top_rpn_proposals(acts, explained["cfg"])
    assert props.shape == (50, 4)
    np.testing.assert_array_equal(props, jprops)


def test_explain_dashboard_and_counts_match_jax(explained):
    """The same TP/FP/FN panel text as JAX's (two TPs, one FN at IoU
    0.5, detections over score 0.3); the dashboard PNG is written (> 10
    kB, as tests/test_explain.py)."""
    jtext, ptext = explained["texts"]
    assert ptext == jtext
    assert ptext.startswith("TP: 2\n") and "FN: 1\n" in ptext
    for side in ("port", "jax"):
        assert os.path.getsize(explained[side + "_png"]) > 10000


def test_capture_activations_keeps_first_call_and_removes_hooks(
        monkeypatch):
    """A stage called twice in one pass keeps its first call's output.
    No hook outlives the call, also when the forward raises."""
    model = up.port_model()
    first = []
    handle = model.mask_head.register_forward_hook(
        lambda m, i, o: first.append(o.detach().clone()))
    real = model.inference_forward

    def twice(images):
        det = real(images)
        model.mask_head(torch.zeros((3, 7, 7, model.cfg.fpn_channels)))
        return det

    monkeypatch.setattr(model, "inference_forward", twice)
    img = up.images(12, 1)[0]
    _, acts = explain.capture_activations(model, img)
    handle.remove()
    assert len(first) == 2 and first[1].shape[0] == 3
    np.testing.assert_array_equal(acts["mask_head"], first[0].numpy())
    assert all(not m._forward_hooks for m in model.modules())
    with pytest.raises(RuntimeError):
        explain.capture_activations(model, img[:, :, :2])
    assert all(not m._forward_hooks for m in model.modules())


def test_explain_main_writes_three_dashboards(ckpts, tmp_path):
    """main: the first, middle and last tile of a split (PackedDataset),
    one dashboard each."""
    _, ppath = ckpts
    split = tmp_path / "split"
    frame = make_frame(2)
    records = tile_frame(frame, {"id": 1, "file_name": "f.png",
                                 "width": 140, "height": 98},
                         [{"id": 1, "image_id": 1, "category_id": 1,
                           "segmentation": square(10, 10, 14),
                           "bbox": [10, 10, 14, 14], "area": 196,
                           "iscrowd": 0}],
                         split / "test" / "images", 0)[:5]
    (split / "annotations").mkdir()
    (split / "annotations" / "livecell_coco_test.json").write_text(
        json.dumps({"images": [{k: r[k] for k in ("id", "file_name",
                                                  "width", "height")}
                               for r in records],
                    "annotations": [a for r in records
                                    for a in r["annotations"]],
                    "categories": [{"id": 1, "name": "cell"}]}))
    paths = explain.main(["--model_path", ppath, "--data_dir", str(split),
                          "--output_dir", str(tmp_path / "out")],
                         device="cpu")
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "explain_0000.png", "explain_0002.png", "explain_0004.png"]


# ---------------------------------------------------------------------------
# The server.
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_engine(monkeypatch):
    monkeypatch.setattr(app, "_ENGINE", None)
    monkeypatch.setattr(app, "_DENSE", {"dets": 0, "infer_nms": 0.0,
                                        "det_nms": 0.0, "device": "cpu"})
    monkeypatch.setattr(japp, "_ENGINE", None)


def test_predict_single_image_errors_match_jax(tmp_path, fresh_engine):
    """JAX's status strings: a missing path, and a load failure (a
    directory that holds no checkpoint); the input comes back."""
    image = np.zeros((8, 8, 3), np.uint8)
    missing = str(tmp_path / "nope")
    got = app.predict_single_image(image, missing, 0.5)
    want = japp.predict_single_image(image, missing, 0.5)
    assert got[1] == want[1] == f"Error: Model not found at {missing}"
    assert got[0] is image
    (tmp_path / "empty").mkdir()
    got = app.predict_single_image(image, str(tmp_path / "empty"), 0.5)
    want = japp.predict_single_image(image, str(tmp_path / "empty"), 0.5)
    assert got[0] is image
    assert got[1].startswith("Error loading model: ")
    assert want[1].startswith("Error loading model: ")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_http_serves_and_shuts_down(ckpts, fresh_engine):
    """GET / returns the form; POST /predict (multipart, threshold 0.3)
    returns a PNG whose X-Status count is InferenceEngine.predict's;
    POST /shutdown ends serve_forever."""
    _, ppath = ckpts
    port = free_port()
    server = threading.Thread(target=app.launch_http, args=(ppath, port),
                              daemon=True)
    server.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 30
    while True:
        try:
            with urllib.request.urlopen(base + "/", timeout=5) as r:
                form = r.read()
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    assert b"<form method=post" in form
    image = make_frame(3)[:60, :90]
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    body = (b"--XyZ\r\nContent-Disposition: form-data; name=image; "
            b"filename=a.png\r\nContent-Type: image/png\r\n\r\n"
            + buf.getvalue() + b"\r\n--XyZ--\r\n")
    req = urllib.request.Request(
        base + "/predict?threshold=0.3", data=body,
        headers={"Content-Type": "multipart/form-data; boundary=XyZ"})
    with urllib.request.urlopen(req, timeout=120) as r:
        status = r.headers["X-Status"]
        png = r.read()
    _, scores, _ = app.InferenceEngine(ppath, device="cpu").predict(image,
                                                                    0.3)
    assert len(scores) >= 2
    assert status == f"Detected {len(scores)} cells."
    with Image.open(io.BytesIO(png)) as im:
        assert im.format == "PNG" and im.size[0] > image.shape[1]
    req = urllib.request.Request(base + "/shutdown", data=b"")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.read() == b"shutting down"
    server.join(timeout=30)
    assert not server.is_alive()


def test_main_falls_back_to_http_without_gradio(monkeypatch, fresh_engine):
    calls = []
    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setattr(app, "launch_http",
                        lambda *a: calls.append(("http",) + a))
    monkeypatch.setattr(app, "launch_gradio",
                        lambda *a: calls.append(("gradio",) + a))
    app.main(["--model_path", "m", "--port", "1234", "--dets", "8"],
             device="cpu")
    assert calls == [("http", "m", 1234)]
    assert app._DENSE == {"dets": 8, "infer_nms": 0.0, "det_nms": 0.0,
                          "device": torch.device("cpu")}


# ---------------------------------------------------------------------------
# The transfer trainer's prediction panels.
# ---------------------------------------------------------------------------

def test_transfer_trainer_visualize_flags(tmp_path, monkeypatch, capsys):
    """--visualize_every 1 --visualize_samples 2: two panels after every
    epoch of each stage, under outputs/transfer_s{stage}e{epoch}_
    sample{k}.png, and a line per sample."""
    split = write_split(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    train_transfer.main(["--data_dir", str(split), "--batch_size", "4",
                         "--clip_grad_norm", "10", "--stage1_epochs", "1",
                         "--stage2_epochs", "1", "--visualize_every", "1",
                         "--visualize_samples", "2"],
                        transfer_cfg=PORT_TTINY, device="cpu")
    assert sorted(p.name for p in (tmp_path / "outputs").glob("transfer_*")
                  ) == [f"transfer_s{s}e1_sample{k}.png"
                        for s in (1, 2) for k in (1, 2)]
    assert capsys.readouterr().out.count("  viz sample ") == 4
    args = train_transfer.build_parser().parse_args([])
    assert (args.visualize_every, args.visualize_samples) == (0, 5)


def test_forward_constants_are_made_once_per_device():
    """The forwards' constants (box-coder weights, normalization,
    resize matrices) are made once per device and shared, usable by
    training after a serving call made them, so a frame's
    dispatch copies nothing from pageable host memory (a pageable copy
    waits for the card's queued work; chip_smoke.py phase 17 checks the
    dispatch on the card)."""
    from livecell_tpu_torch.device import constant
    from livecell_tpu_torch.ops import mask_ops
    from livecell_tpu_torch.ops.interp import resize_weight_matrix

    cpu = torch.device("cpu")
    # Made first under a serving call's inference mode, then saved for
    # backward by a training step.
    with torch.inference_mode():
        w = constant((10.0, 10.0, 5.0, 5.0), cpu)
        m = mask_ops._resize_matrix(14, 28, cpu)
    x = torch.ones(4, requires_grad=True)
    (x / w).sum().backward()
    y = torch.ones((14, 3, 1), requires_grad=True)
    torch.einsum("yh,hwc->ywc", m, y).sum().backward()
    assert not w.is_inference() and not m.is_inference()
    assert w is constant((10.0, 10.0, 5.0, 5.0), cpu)
    assert w.dtype == torch.float32 and w.tolist() == [10.0, 10.0, 5.0, 5.0]
    assert m is mask_ops._resize_matrix(14, 28, cpu)
    np.testing.assert_array_equal(m.numpy(), resize_weight_matrix(14, 28))
