"""Box geometry ops (counterpart of livecell_tpu/ops/boxes.py).

All functions take boxes as [..., 4] xyxy and broadcast over leading
dimensions, so a batch of images is one call.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N, 4] x [..., M, 4] -> [..., N, M]
    (torchvision.ops.box_iou); a zero-area union gives IoU 0."""
    area_a = box_area(boxes_a)
    area_b = box_area(boxes_b)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Boxes relative to anchors as (dx, dy, dw, dh), with the reference
    encoder's min-size 1.0 clamps."""
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=1.0)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=1.0)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    bw = (boxes[..., 2] - boxes[..., 0]).clamp(min=1.0)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp(min=1.0)
    bx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    by = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 clip_log: float = 4.135) -> torch.Tensor:
    """Inverse of `encode_boxes`, with dw/dh clamped at `clip_log`."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    dw = deltas[..., 2].clamp(max=clip_log)
    dh = deltas[..., 3].clamp(max=clip_log)
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip xyxy boxes to [0, w] x [0, h]; image_size is (h, w)."""
    h, w = image_size
    x = boxes[..., 0::2].clamp(0.0, float(w))
    y = boxes[..., 1::2].clamp(0.0, float(h))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Keep-mask for boxes with both sides >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)
