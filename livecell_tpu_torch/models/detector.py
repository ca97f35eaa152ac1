"""Detection losses and detector outputs (counterpart of
livecell_tpu/models/detector.py: bce_with_logits, smooth_l1, _select_top,
rpn_loss_single, rpn_reg_loss_from_match, HeadTargets,
match_head_targets, box_losses, mask_loss, mask_loss_on, Detections).

Each per-image function of the JAX package takes leading batch
dimensions here where the JAX model vmaps it over images, and reduces
over the trailing axes only. The reference's quirks are kept as the JAX
package keeps them (the image-0 RPN and head losses live in
models/mask_rcnn.py). Sampling takes its uniforms as tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.ops.boxes import box_iou, encode_boxes
from livecell_tpu_torch.ops.proposals import take_rows, top_k_stable


class Detections(NamedTuple):
    boxes: torch.Tensor       # [B, D, 4]
    scores: torch.Tensor      # [B, D]
    labels: torch.Tensor      # [B, D] (1 = cell)
    valid: torch.Tensor       # [B, D] bool
    mask_probs: torch.Tensor  # [B, D, 28, 28] class-1 probabilities


def _select_top(mask: torch.Tensor, pri: torch.Tensor, kmax: int,
                count: torch.Tensor) -> torch.Tensor:
    """mask & (pri among the `count` largest masked priorities), in the
    JAX package's threshold form: the count-th largest masked priority
    is the threshold. mask/pri [..., N], count [...]."""
    kmax = min(kmax, pri.shape[-1])
    masked = torch.where(mask, pri, torch.full_like(pri, -torch.inf))
    vals = top_k_stable(masked, kmax)[0]
    pos = (count.clamp(min=1).clamp(max=kmax) - 1).long()
    thr = torch.gather(vals, -1, pos[..., None])
    return mask & (pri >= thr) & (count > 0)[..., None]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    return logits.clamp(min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))


def smooth_l1(x: torch.Tensor, y, beta: float = 1.0) -> torch.Tensor:
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def rpn_sample(max_iou: torch.Tensor, u_pos: torch.Tensor,
               u_neg: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RPN loss's balanced sample: anchors at IoU >= rpn_pos_iou and
    in [0, rpn_neg_iou), each set capped by ranking its uniforms.
    max_iou, u_pos, u_neg [..., N] -> (chosen_pos, chosen_neg [..., N],
    whether any anchor was sampled [...])."""
    pos = max_iou >= cfg.rpn_pos_iou
    neg = (max_iou < cfg.rpn_neg_iou) & (max_iou >= 0.0)
    num_pos = pos.sum(-1).clamp(max=cfg.rpn_pos_per_image)
    num_neg = torch.minimum(neg.sum(-1),
                            cfg.rpn_batch_per_image - num_pos)
    return (_select_top(pos, u_pos, cfg.rpn_pos_per_image, num_pos),
            _select_top(neg, u_neg, cfg.rpn_batch_per_image, num_neg),
            (num_pos + num_neg) > 0)


def rpn_loss_single(scores: torch.Tensor, valid_all: torch.Tensor,
                    max_iou: torch.Tensor, u_pos: torch.Tensor,
                    u_neg: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Balanced-sample objectness BCE (reference rpn.py:42-121).

    scores [..., N] f32 logits, valid_all [..., M] GT validity, max_iou
    [..., N] each anchor's max IoU over the valid GT (-1 with none, K4's
    output), u_pos/u_neg [..., N] the uniforms that rank the positive
    and negative candidates. Returns the loss per leading index."""
    chosen_pos, chosen_neg, has_sample = rpn_sample(max_iou, u_pos, u_neg,
                                                    cfg)
    labels = chosen_pos.float()
    w = (chosen_pos | chosen_neg).float()
    denom = w.sum(-1).clamp(min=1.0)
    loss = (bce_with_logits(scores, labels) * w).sum(-1) / denom
    has_gt = valid_all.any(-1)
    # No GT at all -> 0.1 (rpn.py:64); matching failed -> 0.1*mean
    # (rpn.py:120).
    fallback = torch.where(has_sample, loss, 0.1 * scores.mean(-1))
    return torch.where(has_gt, fallback, torch.full_like(loss, 0.1))


def rpn_reg_loss_from_match(deltas: torch.Tensor, max_iou: torch.Tensor,
                            reg_targets: torch.Tensor,
                            best_anchor: Optional[torch.Tensor],
                            gt_valid: torch.Tensor, cfg: ModelConfig
                            ) -> torch.Tensor:
    """Smooth-L1 RPN delta regression on positive anchors, on K4's
    outputs: deltas [..., N*4] or [..., N, 4], max_iou [..., N],
    reg_targets [..., 4, N] planar, best_anchor [..., M] each GT's first
    best anchor, gt_valid [..., M]. With rpn_force_best_anchor every
    valid GT's best anchor is positive; two GT may share one, so the
    update is a scatter with max."""
    n = max_iou.shape[-1]
    pos = max_iou >= cfg.rpn_pos_iou
    if cfg.rpn_force_best_anchor:
        forced = torch.zeros_like(max_iou, dtype=torch.int32).scatter_reduce(
            -1, best_anchor, gt_valid.to(torch.int32), "amax")
        pos = pos | (forced > 0)
    pos = pos.float()
    d4 = deltas.reshape(deltas.shape[:max_iou.dim() - 1] + (n, 4)) \
        .transpose(-1, -2).float()                           # [..., 4, N]
    reg = smooth_l1(d4 - reg_targets, 0.0).sum(-2)           # [..., N]
    loss = (reg * pos).sum(-1) / (4.0 * pos.sum(-1).clamp(min=1.0))
    return torch.where(gt_valid.any(-1), loss, torch.zeros_like(loss))


class HeadTargets(NamedTuple):
    cls_labels: torch.Tensor    # [..., K] int64 (0 bg / 1 fg)
    cls_weight: torch.Tensor    # [..., K] f32 (proposal validity)
    reg_targets: torch.Tensor   # [..., K, 4]
    reg_weight: torch.Tensor    # [..., K] (box-fg mask)
    mask_targets: torch.Tensor  # [..., K, 28, 28]
    mask_weight: torch.Tensor   # [..., K] (mask-fg mask)


def _first_argmax_iou(proposals: torch.Tensor, gt: torch.Tensor,
                      valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    ious = box_iou(proposals, gt)
    ious = torch.where(valid[..., None, :], ious, torch.full_like(ious, -1.0))
    return ious.amax(-1), ious.argmax(-1)


def match_head_targets(
    proposals: torch.Tensor,    # [..., K, 4]
    prop_valid: torch.Tensor,   # [..., K]
    gt_boxes: torch.Tensor,     # [..., I, 4]
    gt_valid: torch.Tensor,     # [..., I]
    gt_mask28: torch.Tensor,    # [..., I, 28, 28]
    cfg: ModelConfig,
    mask_gt: Optional[tuple] = None,
) -> HeadTargets:
    """IoU-match proposals to GT for the box and mask heads.

    mask_gt: optional (boxes [..., J, 4], valid [..., J], mask28
    [..., J, 28, 28]) used for mask matching only: the reference's quirk
    re-matches mask targets against the whole batch's GT
    (mask_utils.py:88-108)."""
    max_iou, matched = _first_argmax_iou(proposals, gt_boxes, gt_valid)
    fg_box = (max_iou >= cfg.box_fg_iou) & prop_valid
    reg_targets = encode_boxes(take_rows(gt_boxes, matched), proposals)
    if cfg.decode_proposals:
        reg_targets = reg_targets * torch.tensor(
            cfg.box_reg_weights, dtype=reg_targets.dtype,
            device=reg_targets.device)
    if mask_gt is not None:
        mgtb, mgtv, mgtm = mask_gt
        m_max, m_arg = _first_argmax_iou(proposals, mgtb, mgtv)
    else:
        m_max, m_arg, mgtm = max_iou, matched, gt_mask28
    fg_mask = fg_box & (m_max > cfg.mask_fg_iou)
    mflat = mgtm.reshape(mgtm.shape[:-2] + (-1,))
    mask_targets = take_rows(mflat, m_arg).reshape(
        m_arg.shape + mgtm.shape[-2:])
    has_gt = gt_valid.any(-1)[..., None]
    return HeadTargets(
        cls_labels=fg_box.long(),
        cls_weight=(prop_valid & has_gt).float(),
        reg_targets=reg_targets,
        reg_weight=(fg_box & has_gt).float(),
        mask_targets=mask_targets,
        mask_weight=(fg_mask & has_gt).float())


def box_losses(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
               t: HeadTargets) -> Dict[str, torch.Tensor]:
    """CE over all (valid) proposals + smooth-L1 on the class-1 deltas
    over box-fg proposals, on flat [K] targets (reference
    custom_maskrcnn.py:221-240)."""
    logp = F.log_softmax(cls_logits.float(), dim=-1)
    ce = -torch.gather(logp, 1, t.cls_labels[:, None])[:, 0]
    cls_loss = (ce * t.cls_weight).sum() / t.cls_weight.sum().clamp(min=1.0)
    fg_deltas = box_deltas[:, 4:8].float()
    reg = smooth_l1(fg_deltas, t.reg_targets).mean(dim=1)
    reg_sum = t.reg_weight.sum()
    reg_loss = (reg * t.reg_weight).sum() / reg_sum.clamp(min=1.0)
    reg_loss = torch.where(reg_sum > 0, reg_loss, torch.zeros_like(reg_loss))
    return {"loss_box_cls": cls_loss, "loss_box_reg": reg_loss}


def mask_loss_on(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                 mask_weight: torch.Tensor) -> torch.Tensor:
    """BCE on the class-1 mask logits [K, 28, 28, nc] against targets
    [K, 28, 28], weighted per row by mask_weight [K]."""
    logits1 = mask_logits[..., 1].float()
    per = bce_with_logits(logits1, mask_targets).mean(dim=(1, 2))
    wsum = mask_weight.sum()
    loss = (per * mask_weight).sum() / wsum.clamp(min=1.0)
    return torch.where(wsum > 0, loss, torch.zeros_like(loss))


def mask_loss(mask_logits: torch.Tensor, t: HeadTargets) -> torch.Tensor:
    """BCE over mask-fg proposals (reference mask_utils.py:117-126)."""
    return mask_loss_on(mask_logits, t.mask_targets, t.mask_weight)
