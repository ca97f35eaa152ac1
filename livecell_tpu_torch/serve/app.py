"""Single-image inference engine (counterpart of livecell_tpu/serve/app.py:
InferenceEngine, and of serve/visualize.py:load_model).

Tile-sized inputs run one forward; frame-sized inputs are cut into the
standard 5x5 overlapping tiles, run as one batch and stitched. A port
checkpoint is a directory holding `model.pt` (a `torch.save`d state
dict) and the `model_config.json` sidecar, the JAX package's format.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from livecell_tpu_torch.config import (
    Config, TileConfig, apply_dense_flags, model_config_from_dict,
    model_config_to_dict)
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.mask_rcnn import CustomMaskRCNN, create_model
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.serve.stitch import make_frame_predictor, tile_position


def save_model(model: CustomMaskRCNN, path: str) -> None:
    """Write a port checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(model_config_to_dict(model.cfg), f, indent=1)


def load_model(path: str, device=None) -> CustomMaskRCNN:
    """Load a port checkpoint directory onto `device` (the card unless
    the caller passes "cpu")."""
    dev = resolve_device(device)
    with open(os.path.join(path, "model_config.json")) as f:
        cfg = model_config_from_dict(json.load(f))
    model = create_model(cfg, device=dev)
    sd = torch.load(os.path.join(path, "model.pt"), map_location=dev,
                    weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model


class InferenceEngine:
    """A model and its frame predictor, held for many requests.

    Pass a checkpoint directory (`model_path`) or a built `model`; the
    engine owns the model and applies the dense-scene flags to its
    detection settings. Runs on the card unless `device="cpu"`."""

    def __init__(self, model_path: Optional[str] = None, *,
                 model: Optional[CustomMaskRCNN] = None, dets: int = 0,
                 infer_nms: float = 0.0, det_nms: float = 0.0,
                 tile_cfg: Optional[TileConfig] = None, device=None):
        if (model_path is None) == (model is None):
            raise ValueError("pass exactly one of model_path and model")
        self.device = resolve_device(device)
        if model is None:
            model = load_model(model_path, self.device)
        model = model.to(self.device).eval()
        model.cfg = apply_dense_flags(model.cfg, dets, infer_nms, det_nms)
        self.model = model
        self.cfg = Config(model=model.cfg, tile=tile_cfg or TileConfig())
        # score_threshold 0 here: each request filters with its own.
        self._frame_predict = make_frame_predictor(
            model, self.cfg.tile, score_threshold=0.0, mask_threshold=0.4,
            max_frame_dets=max(256, 4 * dets), device=self.device)

    @torch.inference_mode()
    def predict(self, image: np.ndarray, score_threshold: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """image uint8 [H, W, 3] -> (boxes, scores, masks [N, H, W] bool)."""
        tcfg, mcfg = self.cfg.tile, self.cfg.model
        h, w = image.shape[:2]

        if h >= tcfg.frame_height * 0.9 and w >= tcfg.frame_width * 0.9:
            # Frame-sized: overlapping tiles + dedup stitch.
            tiles = np.zeros((tcfg.num_tiles, tcfg.tile_height,
                              tcfg.tile_width, 3), np.uint8)
            for t in range(tcfg.num_tiles):
                c0, r0 = tile_position(t, tcfg.tiles_per_row)
                x0 = c0 * tcfg.mini_tile_width
                y0 = r0 * tcfg.mini_tile_height
                patch = image[y0:y0 + tcfg.tile_height,
                              x0:x0 + tcfg.tile_width]
                tiles[t, :patch.shape[0], :patch.shape[1]] = patch
            dets = self._frame_predict(tiles)
            keep = dets.scores > score_threshold
            masks = np.zeros((int(keep.sum()), h, w), bool)
            for i, k in enumerate(np.nonzero(keep)[0]):
                ox, oy = dets.offsets[k].astype(int)
                m = dets.masks[k]
                y1 = min(oy + m.shape[0], h)
                x1 = min(ox + m.shape[1], w)
                masks[i, oy:y1, ox:x1] = m[:y1 - oy, :x1 - ox]
            return dets.boxes[keep], dets.scores[keep], masks

        # Tile-sized: pad/crop into the static input and run one forward.
        canvas = np.zeros((mcfg.image_height, mcfg.image_width, 3),
                          np.float32)
        ch = min(h, mcfg.image_height)
        cw = min(w, mcfg.image_width)
        canvas[:ch, :cw] = image[:ch, :cw].astype(np.float32) / 255.0
        det = self.model.inference_forward(
            torch.from_numpy(canvas)[None].to(self.device))
        keep = det.valid[0] & (det.scores[0] > score_threshold)
        masks_full = paste_masks(
            det.mask_probs[0], det.boxes[0],
            (mcfg.image_height, mcfg.image_width), valid=keep)
        keep_np = keep.cpu().numpy()
        masks = masks_full.cpu().numpy()[keep_np][:, :h, :w] > 0
        return (det.boxes[0].cpu().numpy()[keep_np],
                det.scores[0].cpu().numpy()[keep_np], masks)
