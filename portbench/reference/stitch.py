"""The frame predictor's stitch (a frozen copy of the port's
livecell_tpu_torch/serve/stitch.py: claimed_regions, the part of
make_frame_predictor's `predict` after the model, and `fetch`), on one
card without a mesh: each tile's detections pasted onto its input tile,
kept where valid, over the score threshold and with more than
mask_threshold of the mask in the tile's claimed region, compacted to
the frame's best max_frame_dets, masks bit-packed and unpacked."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.mask_ops import paste_masks
from portbench.reference.proposals import top_k_stable


def tile_position(tile_num: int, tiles_per_row: int):
    return tile_num % tiles_per_row, tile_num // tiles_per_row


def claimed_regions(cfg) -> np.ndarray:
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


@torch.no_grad()
def stitch(det, tile_cfg, input_hw, max_dets_per_tile: int,
           score_threshold: float = 0.5, mask_threshold: float = 0.4,
           max_frame_dets: int = 256) -> Dict[str, np.ndarray]:
    """det (boxes [T, D, 4] in tile coordinates, scores, valid,
    mask_probs [T, D, m, m]) -> {boxes (frame coordinates), scores,
    masks [N, th, tw] bool, offsets, tile_nums}."""
    dev = det.boxes.device
    ih, iw = input_hw
    th, tw = tile_cfg.tile_height, tile_cfg.tile_width
    tpr = tile_cfg.tiles_per_row
    t_idx = np.arange(tile_cfg.num_tiles)
    offs = np.stack([(t_idx % tpr) * tile_cfg.mini_tile_width,
                     (t_idx // tpr) * tile_cfg.mini_tile_height],
                    axis=1).astype(np.float32)
    regions = torch.from_numpy(claimed_regions(tile_cfg)).to(dev) > 0
    n_tiles = tile_cfg.num_tiles
    tw_pad = ((tw + 7) // 8) * 8
    max_frame_dets = min(max_frame_dets, n_tiles * max_dets_per_tile)
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                        device=dev)
    masks = paste_masks(det.mask_probs, det.boxes, (ih, iw),
                        valid=det.valid)[:, :, :th, :tw] > 0
    area = masks.sum(dim=(2, 3)).float()
    inside = (masks & regions[:, None]).sum(dim=(2, 3)).float()
    frac = torch.where(area > 0, inside / area.clamp(min=1.0),
                       torch.zeros_like(area))
    keep = det.valid & (det.scores > score_threshold) & \
        (frac > mask_threshold)
    d = keep.shape[1]
    pri = torch.where(keep, det.scores + 1.0,
                      torch.zeros_like(det.scores)).reshape(-1)
    top, idx = top_k_stable(pri, max_frame_dets)
    sel_masks = masks.reshape(-1, th, tw)[idx]
    packed = (F.pad(sel_masks, (0, tw_pad - tw))
              .reshape(max_frame_dets, th, tw_pad // 8, 8)
              .to(torch.uint8) * bits).sum(dim=-1).to(torch.uint8)
    boxes = det.boxes.reshape(-1, 4)[idx].cpu().numpy()
    scores = det.scores.reshape(-1)[idx].cpu().numpy()
    packed, idx = packed.cpu().numpy(), idx.cpu().numpy()
    sel_valid = (top > 0.5).cpu().numpy()
    out_masks = np.unpackbits(packed[sel_valid], axis=-1)[:, :, :tw] \
        .astype(bool)
    t_ids = idx[sel_valid] // d
    sel_off = offs[t_ids]
    return {"boxes": boxes[sel_valid] + np.concatenate([sel_off, sel_off],
                                                       axis=1),
            "scores": scores[sel_valid], "masks": out_masks,
            "offsets": sel_off, "tile_nums": t_ids}
