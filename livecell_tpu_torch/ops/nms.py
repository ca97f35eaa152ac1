"""Fixed-shape greedy NMS, batched over images (counterpart of
livecell_tpu/ops/nms.py:nms_fixed).

Exactly `max_keep` greedy steps; each picks the highest-scoring live
candidate (first index among equal scores, as `argmax`) and kills every
live candidate whose IoU with it is strictly greater than the
threshold. The picks fill `max_keep` fixed slots plus a validity mask.
The loop reads no tensor on the host, so it never waits for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from livecell_tpu_torch.ops.boxes import box_iou

_NEG = -1e9


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float,
    max_keep: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over [..., N] candidates.

    Args:
      boxes: [..., N, 4] xyxy; scores: [..., N]; valid: optional
        [..., N] bool (invalid rows are never picked).

    Returns:
      keep_idx [..., max_keep] int64 in pick order; slots past the
      survivors repeat the argmax of a fully suppressed row, so mask
      them with keep_valid [..., max_keep] bool.
    """
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    iou = box_iou(boxes, boxes).reshape(-1, n, n)          # [M, N, N]
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, _NEG))
    live = live.reshape(-1, n)
    m = live.shape[0]
    ar = torch.arange(n, device=live.device)
    rows = torch.arange(m, device=live.device)
    keep_idx = torch.zeros((m, max_keep), dtype=torch.int64,
                           device=live.device)
    keep_val = torch.zeros((m, max_keep), dtype=torch.bool,
                           device=live.device)
    neg = torch.full_like(live, _NEG)
    for step in range(max_keep):
        masked = torch.where(live > _NEG / 2, live, neg)
        pick = masked.argmax(dim=1)                          # [M]
        ok = masked[rows, pick] > _NEG / 2
        keep_idx[:, step] = pick
        keep_val[:, step] = ok
        suppress = (iou[rows, pick] > iou_thresh) | (ar == pick[:, None])
        live = torch.where(ok[:, None] & suppress, neg, live)
    return (keep_idx.reshape(lead + (max_keep,)),
            keep_val.reshape(lead + (max_keep,)))
