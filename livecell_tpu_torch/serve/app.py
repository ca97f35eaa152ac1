"""Single-image inference engine (counterpart of livecell_tpu/serve/app.py:
InferenceEngine, and of serve/visualize.py:load_model).

Tile-sized inputs run one forward; frame-sized inputs are cut into the
standard 5x5 overlapping tiles, run as one batch and stitched. Either
model is served: the custom Mask R-CNN or the transfer R50-FPN, as the
checkpoint records. A port checkpoint is a directory holding `model.pt`
(a `torch.save`d state dict) and the `model_config.json` sidecar with
its `model_type` (train/checkpoint.py writes both, with the optimizer's
state beside them in a training checkpoint).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from livecell_tpu_torch.config import Config, TileConfig, apply_dense_flags
from livecell_tpu_torch.config import model_type as type_of
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.mask_rcnn import create_model
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.serve.stitch import (
    input_tile, make_frame_predictor, tile_position)
from livecell_tpu_torch.train import checkpoint


def save_model(model: nn.Module, path: str) -> None:
    """Write a port checkpoint directory (the model only) of either
    model."""
    checkpoint.save(path, model)


def load_model(path: str, device=None) -> nn.Module:
    """Load a port checkpoint directory onto `device` (the card unless
    the caller passes "cpu") as the serving model of the type it
    records."""
    kind, cfg, sd = checkpoint.load_model_state(path, device)
    build = create_model if kind == "custom" else create_transfer_model
    model = build(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    return model


class InferenceEngine:
    """A model and its frame predictor, held for many requests.

    Pass a checkpoint directory (`model_path`) or a built `model` of
    either type; a `model_type` that disagrees with it raises. The dense
    flags (`dets`, `infer_nms`, `det_nms`) change a custom model's
    detection settings; a transfer model has none of them, so non-zero
    values raise. Runs on the card unless `device="cpu"`."""

    def __init__(self, model_path: Optional[str] = None, *,
                 model_type: Optional[str] = None,
                 model: Optional[nn.Module] = None, dets: int = 0,
                 infer_nms: float = 0.0, det_nms: float = 0.0,
                 tile_cfg: Optional[TileConfig] = None, device=None):
        if (model_path is None) == (model is None):
            raise ValueError("pass exactly one of model_path and model")
        self.device = resolve_device(device)
        if model is None:
            model = load_model(model_path, self.device)
        kind = type_of(model.cfg)
        if model_type is not None and model_type != kind:
            raise ValueError(f"model_type {model_type!r}, but the model is "
                             f"{kind!r}")
        self.model_type = kind
        model = model.to(self.device).eval()
        if kind == "custom":
            model.cfg = apply_dense_flags(model.cfg, dets, infer_nms,
                                          det_nms)
        elif dets or infer_nms or det_nms:
            raise ValueError("dets, infer_nms and det_nms apply to the "
                             "custom model only")
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
        tcfg = self.cfg.tile
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

        # Tile-sized: pad/crop into the model's input tile and run one
        # forward.
        ih, iw = input_tile(self.cfg.model)
        canvas = np.zeros((ih, iw, 3), np.float32)
        ch, cw = min(h, ih), min(w, iw)
        canvas[:ch, :cw] = image[:ch, :cw].astype(np.float32) / 255.0
        det = self.model.inference_forward(
            torch.from_numpy(canvas)[None].to(self.device))
        keep = det.valid[0] & (det.scores[0] > score_threshold)
        masks_full = paste_masks(det.mask_probs[0], det.boxes[0], (ih, iw),
                                 valid=keep)
        keep_np = keep.cpu().numpy()
        masks = masks_full.cpu().numpy()[keep_np][:, :h, :w] > 0
        return (det.boxes[0].cpu().numpy()[keep_np],
                det.scores[0].cpu().numpy()[keep_np], masks)
