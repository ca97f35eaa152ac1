"""Full-frame tiled inference with overlap-dedup stitching (counterpart
of livecell_tpu/serve/stitch.py: tile_position, claimed_regions,
make_frame_predictor).

All tiles of a frame go through one batched forward. The dedup rule is
precomputed into static per-tile "newly claimed mini-tile" masks:

  * tile t owns its center mini-tile plus any grid-border mini-tiles of
    its 3x3 window; tiles claim in ascending order, first claim wins;
  * a detection is kept iff the fraction of its mask area inside its
    tile's claimed region exceeds mask_threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from livecell_tpu_torch.config import TileConfig, TransferConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.ops.proposals import top_k_stable


def tile_position(tile_num: int, tiles_per_row: int) -> tuple[int, int]:
    """(col_start, row_start) in mini-tile units."""
    return tile_num % tiles_per_row, tile_num // tiles_per_row


def claimed_regions(cfg: TileConfig) -> np.ndarray:
    """float32 [num_tiles, tile_h, tile_w]: 1 where a pixel of tile t
    (tile-local coordinates) lies in a mini-tile that t claims first."""
    g, w = cfg.grid_size, cfg.window_size
    mini_w, mini_h = cfg.mini_tile_width, cfg.mini_tile_height
    tpr = cfg.tiles_per_row

    processed = set()
    regions = np.zeros((cfg.num_tiles, cfg.tile_height, cfg.tile_width),
                       np.float32)
    for t in range(cfg.num_tiles):
        col0, row0 = tile_position(t, tpr)
        for lr in range(w):
            for lc in range(w):
                mc, mr = col0 + lc, row0 + lr
                is_center = (lc == 1 and lr == 1)
                is_border = (mc == 0 or mc == g - 1 or mr == 0 or
                             mr == g - 1)
                if not (is_center or is_border) or (mc, mr) in processed:
                    continue
                processed.add((mc, mr))
                y0, x0 = lr * mini_h, lc * mini_w
                regions[t, y0:y0 + mini_h, x0:x0 + mini_w] = 1.0
    return regions


class StitchedDetections(NamedTuple):
    boxes: np.ndarray      # [N, 4] global frame coords
    scores: np.ndarray     # [N]
    masks: np.ndarray      # [N, tile_h, tile_w] bool, tile-local
    offsets: np.ndarray    # [N, 2] (x_offset, y_offset) of the source tile
    tile_nums: np.ndarray  # [N]


def input_tile(mcfg) -> tuple[int, int]:
    """(height, width) of the model's input tile, which a frame's tiles
    are zero-padded to: the custom model's image_height x image_width,
    the transfer model's tile_height x tile_width (it resizes the tile to
    its canvas itself)."""
    if isinstance(mcfg, TransferConfig):
        return mcfg.tile_height, mcfg.tile_width
    return mcfg.image_height, mcfg.image_width


def make_frame_predictor(model, tile_cfg: TileConfig,
                         score_threshold: float = 0.5,
                         mask_threshold: float = 0.4,
                         max_frame_dets: int = 256, device=None):
    """Build the frame predictor for `model` (a CustomMaskRCNN or a
    TransferMaskRCNN already on `device`, the card unless the caller
    passes "cpu"). Each tile is zero-padded to the model's input tile
    (`input_tile`) and its masks are pasted on that grid.

    Returns run(tiles_u8 [T, th, tw, 3] numpy) -> StitchedDetections,
    with run.dispatch (enqueue a frame, returns device tensors without
    waiting), run.fetch (wait and unpack), run.device_fn (the device
    computation on a uint8 tile tensor) and run.n_pad_tiles.
    """
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"model is on {param_dev}, predictor on {dev}")
    mcfg = model.cfg
    ih, iw = input_tile(mcfg)
    th, tw = tile_cfg.tile_height, tile_cfg.tile_width
    tpr = tile_cfg.tiles_per_row
    t_idx = np.arange(tile_cfg.num_tiles)
    offs = np.stack([(t_idx % tpr) * tile_cfg.mini_tile_width,
                     (t_idx // tpr) * tile_cfg.mini_tile_height],
                    axis=1).astype(np.float32)          # [T, 2] (x, y)
    regions = torch.from_numpy(claimed_regions(tile_cfg)).to(dev) > 0
    n_tiles = tile_cfg.num_tiles
    tw_pad = ((tw + 7) // 8) * 8
    max_frame_dets = min(max_frame_dets, n_tiles * mcfg.max_detections)
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                        device=dev)

    @torch.inference_mode()
    def predict(tiles_u8: torch.Tensor):
        images = tiles_u8.float() / 255.0
        images = F.pad(images, (0, 0, 0, iw - tw, 0, ih - th))
        det = model.inference_forward(images)

        masks = paste_masks(det.mask_probs, det.boxes, (ih, iw),
                            valid=det.valid)[:, :, :th, :tw] > 0
        area = masks.sum(dim=(2, 3)).float()            # [T, D]
        inside = (masks & regions[:, None]).sum(dim=(2, 3)).float()
        frac = torch.where(area > 0, inside / area.clamp(min=1.0),
                           torch.zeros_like(area))
        keep = det.valid & (det.scores > score_threshold) & \
            (frac > mask_threshold)

        # Global compaction to max_frame_dets slots + bit-packed masks
        # (8 px per byte), so little crosses back to the host.
        t_total, d = keep.shape
        pri = torch.where(keep, det.scores + 1.0,
                          torch.zeros_like(det.scores)).reshape(-1)
        top, idx = top_k_stable(pri, max_frame_dets)
        sel_masks = F.pad(masks.reshape(t_total * d, th, tw)[idx],
                          (0, tw_pad - tw))
        packed = (sel_masks.reshape(max_frame_dets, th, tw_pad // 8, 8)
                  .to(torch.uint8) * bits).sum(dim=-1).to(torch.uint8)
        return (det.boxes.reshape(-1, 4)[idx], det.scores.reshape(-1)[idx],
                packed, idx, top > 0.5)

    def dispatch(tiles_u8: np.ndarray):
        """Enqueue one frame; returns device tensors without waiting."""
        if len(tiles_u8) < n_tiles:
            tiles_u8 = np.concatenate(
                [tiles_u8, np.zeros((n_tiles - len(tiles_u8), th, tw, 3),
                                    np.uint8)])
        return predict(torch.from_numpy(np.ascontiguousarray(tiles_u8))
                       .to(dev))

    def fetch(handle) -> StitchedDetections:
        """Wait for a dispatch() handle and unpack to host detections."""
        boxes, scores, packed, idx, sel_valid = (
            t.cpu().numpy() for t in handle)
        masks = np.unpackbits(packed[sel_valid], axis=-1)[:, :, :tw] \
            .astype(bool)
        # idx is flat over [T, D], D the detection slot count.
        t_ids = idx[sel_valid] // mcfg.max_detections
        sel_off = offs[t_ids]
        return StitchedDetections(
            boxes=boxes[sel_valid] + np.concatenate([sel_off, sel_off],
                                                    axis=1),
            scores=scores[sel_valid], masks=masks, offsets=sel_off,
            tile_nums=t_ids)

    def run(tiles_u8: np.ndarray) -> StitchedDetections:
        return fetch(dispatch(tiles_u8))

    run.device_fn = predict
    run.n_pad_tiles = n_tiles
    run.dispatch = dispatch
    run.fetch = fetch
    return run
