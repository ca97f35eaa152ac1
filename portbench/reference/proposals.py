"""Static-shape proposals, batched over images (counterpart of
livecell_tpu/ops/proposals.py: sample_rows, training_proposals,
inference_proposals).

Inference: top-k -> score > thresh -> clip -> min-size -> greedy NMS ->
top post_nms. Training: top-k -> score > thresh -> clip -> min-size ->
a uniform sample of the valid rows. Each stage keeps its fixed slot
count plus a validity mask. The training sample's uniforms come in as a
tensor: `jax.random` cannot be reproduced in PyTorch, so a caller draws
them from a `torch.Generator`, and a test hands over JAX's own draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.boxes import (
    clip_boxes, decode_boxes, small_box_mask)
from portbench.reference.nms import nms_fixed


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


def sample_rows(u: torch.Tensor, valid: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniformly sample up to k True rows of `valid` [..., n] with the
    uniforms `u` (same shape) as priorities: ([..., k] int64 indices,
    [..., k] bool mask). Invalid rows get priority 0.0 and come last,
    lowest index first (jax.lax.top_k's order among ties)."""
    n = valid.shape[-1]
    pri = torch.where(valid, u + 1.0, torch.zeros_like(u))
    top, idx = top_k_stable(pri, min(k, n))
    if k > n:
        pad = idx.new_zeros(idx.shape[:-1] + (k - n,))
        idx = torch.cat([idx, pad], dim=-1)
        top = torch.cat([top, pad.to(top.dtype)], dim=-1)
    return idx, top > 0.5


def training_proposals(
    objectness: torch.Tensor,
    anchors: torch.Tensor,
    image_size: Tuple[int, int],
    u: torch.Tensor,
    pre_topk: int = 500,
    score_thresh: float = 0.01,
    min_size: float = 5.0,
    num_samples: int = 128,
    deltas: Optional[torch.Tensor] = None,
) -> Proposals:
    """objectness [..., A] logits in (y, x, anchor) order, anchors [A, 4],
    u [..., min(pre_topk, A)] uniforms for the sample, optional deltas
    [..., A, 4]: when given, the proposals are the decoded anchors,
    decoded after the top-k and detached (selection depends on scores
    only). Returns Proposals with [..., num_samples] slots; no gradient
    reaches the boxes."""
    scores = torch.sigmoid(objectness.float())
    top_scores, top_idx = top_k_stable(scores, pre_topk)
    boxes = anchors[top_idx]
    if deltas is not None:
        boxes = decode_boxes(take_rows(deltas, top_idx).float(),
                             boxes).detach()
    valid = top_scores > score_thresh
    boxes = clip_boxes(boxes, image_size)
    valid = valid & small_box_mask(boxes, min_size)
    sel, sel_valid = sample_rows(u, valid, num_samples)
    return Proposals(take_rows(boxes, sel), torch.gather(top_scores, -1, sel),
                     sel_valid)


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
