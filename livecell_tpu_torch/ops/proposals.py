"""Static-shape inference proposals, batched over images (counterpart of
livecell_tpu/ops/proposals.py:inference_proposals).

top-k -> score > thresh -> clip -> min-size -> greedy NMS -> top
post_nms, each stage keeping its fixed slot count plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from livecell_tpu_torch.ops.boxes import (
    clip_boxes, decode_boxes, small_box_mask)
from livecell_tpu_torch.ops.nms import nms_fixed


class Proposals(NamedTuple):
    boxes: torch.Tensor   # [..., K, 4]
    scores: torch.Tensor  # [..., K]
    valid: torch.Tensor   # [..., K] bool


def top_k_stable(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, the
    lowest index first among equal values (`jax.lax.top_k`'s order,
    which `torch.topk` does not promise on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, D] gathered at idx [..., K] -> [..., K, D]."""
    return torch.gather(x, -2, idx[..., None].expand(
        idx.shape + x.shape[-1:]))


def inference_proposals(
    objectness: torch.Tensor,
    anchors: torch.Tensor,
    image_size: Tuple[int, int],
    pre_topk: int = 250,
    score_thresh: float = 0.3,
    nms_thresh: float = 0.4,
    post_nms: int = 50,
    min_size: float = 10.0,
    deltas: Optional[torch.Tensor] = None,
) -> Proposals:
    """objectness [B, A] logits in (y, x, anchor) order, anchors [A, 4],
    optional deltas [B, A, 4]: when given, the proposals are the decoded
    anchors, decoded after the top-k (selection depends on scores only).
    Returns Proposals with [B, post_nms] slots."""
    scores = torch.sigmoid(objectness.float())
    top_scores, top_idx = top_k_stable(scores, pre_topk)     # [B, k]
    boxes = anchors[top_idx]                                  # [B, k, 4]
    if deltas is not None:
        boxes = decode_boxes(take_rows(deltas, top_idx).float(), boxes)
    valid = top_scores > score_thresh
    boxes = clip_boxes(boxes, image_size)
    valid = valid & small_box_mask(boxes, min_size)

    keep_idx, keep_valid = nms_fixed(boxes, top_scores, nms_thresh,
                                     post_nms, valid)
    return Proposals(take_rows(boxes, keep_idx),
                     torch.gather(top_scores, -1, keep_idx), keep_valid)
