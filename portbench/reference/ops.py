"""The plain forms of the port's hand-written kernels: RoIAlign (K1-K3),
the anchor matcher (K4) and MultiScaleRoIAlign (K5/K6), in float32.

RoIAlign is torchvision's (aligned=False): `sampling_ratio` samples a
bin at offsets (s + 0.5) / ratio, box sides floored at 1, a sample
outside [-1, size] adds zero, one inside is clamped to [0, size - 1]
and read bilinearly. Here that read is `F.grid_sample` (bilinear,
border padding, align_corners=True: the clamp), taken over blocks of
images, so its backward is PyTorch's own."""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.boxes import box_iou, encode_boxes
from portbench.reference.proposals import take_rows

# Samples a block of images holds at once: [b, C, K * n, n] f32.
_BLOCK_ELEMS = 1 << 28


@functools.lru_cache(maxsize=64)
def _constant(values: Tuple[float, ...], device: torch.device
              ) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def constant(values, device) -> torch.Tensor:
    return _constant(tuple(values), torch.device(device))


def _axis(lo, hi, size: int, out_size: int, ratio: int, scale: float):
    n = out_size * ratio
    s = torch.arange(n, dtype=torch.float32, device=lo.device)
    pos = torch.floor(s / ratio) + (s % ratio + 0.5) / ratio
    start = lo * scale
    length = (hi * scale - start).clamp(min=1.0)
    coords = start[..., None] + pos * (length / out_size)[..., None]
    valid = (coords >= -1.0) & (coords <= float(size))
    c = coords.clamp(0.0, float(size - 1))
    g = 2.0 * c / max(size - 1, 1) - 1.0
    return g, valid


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              out_size: int = 7, spatial_scale: float = 0.25,
              sampling_ratio: int = 2) -> torch.Tensor:
    """features [B, H, W, C], boxes [B, K, 4] xyxy in image coordinates
    -> [B, K, out_size, out_size, C] float32; differentiable in the
    features, not in the boxes."""
    b, h, w, c = features.shape
    k = boxes.shape[1]
    n = out_size * sampling_ratio
    bx = boxes.detach().float()
    gy, vy = _axis(bx[..., 1], bx[..., 3], h, out_size, sampling_ratio,
                   spatial_scale)
    gx, vx = _axis(bx[..., 0], bx[..., 2], w, out_size, sampling_ratio,
                   spatial_scale)
    grid = torch.stack([gx[:, :, None, :].expand(b, k, n, n),
                        gy[:, :, :, None].expand(b, k, n, n)], dim=-1)
    grid = grid.reshape(b, k * n, n, 2)
    keep = (vy[:, :, :, None] & vx[:, :, None, :]).float()   # [B, K, n, n]
    x = features.float().permute(0, 3, 1, 2)
    step = max(1, _BLOCK_ELEMS // max(c * k * n * n, 1))
    outs = []
    for i in range(0, b, step):
        s = slice(i, min(i + step, b))
        o = F.grid_sample(x[s], grid[s], mode="bilinear",
                          padding_mode="border", align_corners=True)
        o = o.reshape(-1, c, k, n, n) * keep[s, None]
        o = o.reshape(-1, c, k, out_size, sampling_ratio, out_size,
                      sampling_ratio).mean(dim=(4, 6))
        outs.append(o.permute(0, 2, 3, 4, 1))
    return torch.cat(outs)


def assign_levels(boxes: torch.Tensor, canonical_size: float = 224.0,
                  canonical_level: int = 4) -> torch.Tensor:
    """torchvision LevelMapper, 0-based over P2..P5: [..., K] int64."""
    b = boxes.float()
    area = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp(
        min=1e-12)
    lvl = torch.floor(canonical_level + torch.log2(
        area.sqrt() / torch.full_like(area, canonical_size) + 1e-6))
    return (lvl.clamp(2, 5) - 2).long()


def ms_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                 out_size: int = 7, sampling_ratio: int = 2
                 ) -> torch.Tensor:
    """torchvision MultiScaleRoIAlign over P2..P5 (maps [B, H_l, W_l, C],
    strides 4..32), boxes [B, K, 4] -> [B, K, s, s, C] float32: each ROI
    pooled from its own level."""
    levels = assign_levels(boxes.detach())
    out = None
    for lvl, f in enumerate(feats):
        o = roi_align(f, boxes, out_size, 0.25 / 2 ** lvl, sampling_ratio)
        o = torch.where((levels == lvl)[..., None, None, None], o,
                        torch.zeros_like(o))
        out = o if out is None else out + o
    return out


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, full: bool = True):
    """Each anchor's largest IoU over the valid GT (-1 with none); with
    `full` also the encoded targets of its first best GT [B, 4, N] and
    each GT's first best anchor [B, I]. Taken over blocks of anchors."""
    anchors, gt = anchors.float(), gt_boxes.float()
    b, i = gt_valid.shape
    step = max(1, (1 << 26) // max(b * i, 1))
    maxes, args = [], []
    for s in range(0, anchors.shape[0], step):
        ious = box_iou(anchors[s:s + step], gt)               # [B, n, I]
        ious = torch.where(gt_valid[:, None, :], ious,
                           torch.full_like(ious, -1.0))
        maxes.append(ious.amax(dim=-1))
        args.append(ious.argmax(dim=-1))
        if full:
            col = ious.amax(dim=1)
            pos = ious.argmax(dim=1) + s
            if s == 0:
                best, best_at = col, pos
            else:
                better = col > best
                best = torch.where(better, col, best)
                best_at = torch.where(better, pos, best_at)
    max_iou = torch.cat(maxes, 1)
    if not full:
        return max_iou
    matched = take_rows(gt, torch.cat(args, 1))                # [B, N, 4]
    tgt = encode_boxes(matched, anchors).transpose(1, 2).contiguous()
    return max_iou, tgt, best_at
