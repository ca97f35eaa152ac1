"""The port's serving path vs the JAX package's: the frame predictor
(25 overlapping tiles, one batched forward, dedup stitch) and the
InferenceEngine's tile and frame requests, with the same weights on
the same frame. A small TileConfig (140x98 frame, 60x42 tiles) fits the
test model's 64x96 input.

Boxes and scores are f32 results of the same selections: rtol/atol 1e-4.
Binary masks come from thresholding interpolated probabilities at 0.5,
where f32 rounding can flip a pixel: at most 0.1% of pixels may differ.
"""

import json

import jax
import numpy as np
import pytest
import torch

from livecell_tpu.config import ModelConfig as JaxModelConfig
from livecell_tpu.config import TileConfig as JaxTileConfig
from livecell_tpu.config import model_config_to_dict as jax_config_to_dict
from livecell_tpu.ops.mask_ops import paste_masks as jax_paste_masks
from livecell_tpu.serve.stitch import (
    make_frame_predictor as jax_make_frame_predictor)
from livecell_tpu_torch.config import TileConfig
from livecell_tpu_torch.models.mask_rcnn import create_model
from livecell_tpu_torch.serve.app import (
    InferenceEngine, load_model, save_model)
from livecell_tpu_torch.serve.stitch import (
    claimed_regions, make_frame_predictor, tile_position)
from tests.util_torch_port import (
    CFG_KW, PORT_CFG, jax_model, jax_variables, port_model)

TCFG = TileConfig(frame_width=140, frame_height=98)
SCORE = 0.3
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_MASK_MISMATCH = 1e-3


def make_frame(seed=0):
    """Dim background with bright elliptic blobs, uint8 RGB."""
    rng = np.random.default_rng(seed)
    h, w = TCFG.frame_height, TCFG.frame_width
    img = rng.normal(50, 8, (h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(4, 10, 2)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] += 120
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


def cut_tiles(frame):
    tiles = np.zeros((TCFG.num_tiles, TCFG.tile_height, TCFG.tile_width, 3),
                     np.uint8)
    for t in range(TCFG.num_tiles):
        c0, r0 = tile_position(t, TCFG.tiles_per_row)
        x0, y0 = c0 * TCFG.mini_tile_width, r0 * TCFG.mini_tile_height
        patch = frame[y0:y0 + TCFG.tile_height, x0:x0 + TCFG.tile_width]
        tiles[t, :patch.shape[0], :patch.shape[1]] = patch
    return tiles


@pytest.fixture(scope="module")
def frame():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_frame()


@pytest.fixture(scope="module")
def jax_frame_dets(frame):
    """The JAX frame predictor at score threshold 0 (the engine's)."""
    run = jax_make_frame_predictor(
        jax_model(), jax_variables(),
        JaxTileConfig(frame_width=140, frame_height=98), score_threshold=0.0)
    with jax.default_matmul_precision("highest"):
        return run(cut_tiles(frame))


def assert_masks_close(got, want):
    assert got.shape == want.shape
    if got.size:
        assert (got != want).mean() <= MAX_MASK_MISMATCH


def test_claimed_regions_partition_small_frame():
    regions = claimed_regions(TCFG)
    assert regions.shape == (25, TCFG.tile_height, TCFG.tile_width)
    total = np.zeros((TCFG.frame_height, TCFG.frame_width), np.float32)
    for t in range(25):
        c0, r0 = tile_position(t, 5)
        x0, y0 = c0 * TCFG.mini_tile_width, r0 * TCFG.mini_tile_height
        total[y0:y0 + TCFG.tile_height, x0:x0 + TCFG.tile_width] += regions[t]
    grid = total[:TCFG.mini_tile_height * 7, :TCFG.mini_tile_width * 7]
    assert grid.min() == grid.max() == 1.0


@pytest.mark.parametrize("score_threshold", [0.0, SCORE])
def test_frame_predictor_matches_jax(frame, jax_frame_dets, score_threshold):
    want = jax_frame_dets
    if score_threshold:
        keep = want.scores > score_threshold
        want = want._replace(**{f: getattr(want, f)[keep]
                                for f in want._fields})
    run = make_frame_predictor(port_model(), TCFG,
                               score_threshold=score_threshold,
                               device="cpu")
    assert run.n_pad_tiles == 25
    got = run(cut_tiles(frame))
    assert len(want.scores) >= 3
    np.testing.assert_array_equal(got.tile_nums, want.tile_nums)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_allclose(got.boxes, want.boxes, **TOL)
    np.testing.assert_allclose(got.scores, want.scores, **TOL)
    assert_masks_close(got.masks, want.masks)


def test_engine_frame_request_matches_jax(frame, jax_frame_dets):
    eng = InferenceEngine(model=port_model(), tile_cfg=TCFG, device="cpu")
    boxes, scores, masks = eng.predict(frame, score_threshold=SCORE)
    # The JAX engine's assembly of its frame predictor's output.
    d = jax_frame_dets
    keep = d.scores > SCORE
    h, w = frame.shape[:2]
    want = np.zeros((int(keep.sum()), h, w), bool)
    for i, k in enumerate(np.nonzero(keep)[0]):
        ox, oy = d.offsets[k].astype(int)
        m = d.masks[k]
        y1, x1 = min(oy + m.shape[0], h), min(ox + m.shape[1], w)
        want[i, oy:y1, ox:x1] = m[:y1 - oy, :x1 - ox]
    assert keep.sum() >= 3
    np.testing.assert_allclose(boxes, d.boxes[keep], **TOL)
    np.testing.assert_allclose(scores, d.scores[keep], **TOL)
    assert_masks_close(masks, want)


def test_engine_tile_request_matches_jax(frame):
    tile = frame[:TCFG.tile_height, :TCFG.tile_width]
    eng = InferenceEngine(model=port_model(), tile_cfg=TCFG, device="cpu")
    boxes, scores, masks = eng.predict(tile, score_threshold=SCORE)

    h, w = tile.shape[:2]
    canvas = np.zeros((1, CFG_KW["image_height"], CFG_KW["image_width"], 3),
                      np.float32)
    canvas[0, :h, :w] = tile / 255.0
    jm = jax_model()

    def jax_tile(v, x):
        det = jm.apply(v, x, train=False)
        keep = det.valid[0] & (det.scores[0] > SCORE)
        full = jax_paste_masks(det.mask_probs[0], det.boxes[0],
                               (CFG_KW["image_height"], CFG_KW["image_width"]),
                               valid=keep)
        return det.boxes[0], det.scores[0], keep, full

    with jax.default_matmul_precision("highest"):
        jb, js, jk, jfull = jax.tree.map(
            np.asarray, jax.jit(jax_tile)(jax_variables(), canvas))
    assert jk.sum() >= 2
    np.testing.assert_allclose(boxes, jb[jk], **TOL)
    np.testing.assert_allclose(scores, js[jk], **TOL)
    assert_masks_close(masks, jfull[jk][:, :h, :w] > 0)


def test_engine_from_checkpoint(tmp_path, frame):
    model = port_model()
    save_model(model, str(tmp_path / "ckpt"))
    loaded = load_model(str(tmp_path / "ckpt"), device="cpu")
    assert loaded.cfg == PORT_CFG
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              loaded.state_dict().items()):
        assert torch.equal(a, b), k
    eng = InferenceEngine(str(tmp_path / "ckpt"), tile_cfg=TCFG,
                          device="cpu", dets=8)
    assert eng.model.cfg.max_detections == 8 == eng.cfg.model.infer_post_nms
    ref = InferenceEngine(model=port_model(), tile_cfg=TCFG, device="cpu",
                          dets=8)
    for a, b in zip(eng.predict(frame, SCORE), ref.predict(frame, SCORE)):
        np.testing.assert_array_equal(a, b)


def test_jax_sidecar_route_names_load_and_serve(tmp_path, frame):
    """A JAX checkpoint's sidecar names the JAX routes (written by
    train_custom.py --roi_backend pallas and the like); the port maps
    them onto its own ("auto", exact top-k) and serves."""
    jcfg = JaxModelConfig(**CFG_KW, roi_backend="pallas",
                          match_backend="pallas", topk_backend="approx")
    path = tmp_path / "jax_ckpt"
    save_model(port_model(), str(path))
    (path / "model_config.json").write_text(
        json.dumps(jax_config_to_dict(jcfg)))
    model = load_model(str(path), device="cpu")
    assert (model.cfg.roi_backend, model.cfg.match_backend,
            model.cfg.topk_backend) == ("auto", "auto", "exact")
    tile = frame[:TCFG.tile_height, :TCFG.tile_width]
    got = InferenceEngine(model=model, tile_cfg=TCFG,
                          device="cpu").predict(tile, SCORE)
    want = InferenceEngine(model=port_model(), tile_cfg=TCFG,
                           device="cpu").predict(tile, SCORE)
    assert len(got[1]) >= 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_entry_points_raise_without_cuda(monkeypatch):
    model = port_model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(PORT_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model=model, tile_cfg=TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_frame_predictor(model, TCFG)
