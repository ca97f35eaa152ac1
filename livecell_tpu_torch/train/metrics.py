"""Evaluation metrics: box IoU, precision, recall, F1 (counterpart of
livecell_tpu/train/metrics.py).

The reference's definitions: detections above a 0.5 score threshold are
matched to GT by box IoU; a detection is a true positive when its best
IoU exceeds the IoU threshold; precision and recall are averaged per
image over the images that have both predictions and GT; F1 combines
the two means. The per-batch reduction runs on the batch's device over
all images at once; only the ten partial sums cross to the host, in one
copy per batch.
"""

from __future__ import annotations

from typing import Dict

import torch

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.detector import Detections
from livecell_tpu_torch.ops.boxes import box_iou

STAT_KEYS = ("conf_sum", "conf_cnt", "iou_sum", "iou_cnt", "prec_sum",
             "rec_sum", "pr_cnt", "gt_cnt", "pred_cnt", "tp_cnt")


def batch_eval_stats(det: Detections, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, batch_valid: torch.Tensor,
                     score_thresh: float = 0.5, iou_thresh: float = 0.5
                     ) -> Dict[str, torch.Tensor]:
    """Per-batch metric partial sums, 0-dim tensors on the batch's device.

    det: fixed-slot Detections [B, D, ...]; gt_boxes [B, I, 4]; gt_valid
    [B, I]; batch_valid [B] (False for the padded images of a final
    batch).
    """
    dvalid = det.valid & batch_valid[:, None]
    gtv = gt_valid & batch_valid[:, None]
    scores = det.scores.float()
    conf_sum = (scores * dvalid).sum(1)
    conf_cnt = dvalid.sum(1)

    keep = dvalid & (scores > score_thresh)
    n_pred = keep.sum(1)
    n_gt = gtv.sum(1)

    iou = box_iou(det.boxes.float(), gt_boxes.float())          # [B, D, I]
    iou = torch.where(gtv[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou = torch.where(keep, iou.max(dim=2).values,
                          torch.zeros_like(scores))

    both = (n_pred > 0) & (n_gt > 0)
    # The reference's rule: every prediction whose best IoU clears the
    # threshold is a true positive, so several can match one GT and
    # per-image recall (and F1) can exceed 1 on duplicate predictions.
    # COCO AP (train/coco_eval.py) is the matched metric.
    tp = ((max_iou > iou_thresh) & keep).sum(1) * both
    iou_sum = (max_iou.clamp(min=0.0) * keep).sum(1) * both
    iou_cnt = n_pred * both
    zero = torch.zeros_like(conf_sum)
    precision = torch.where(both, tp / n_pred.clamp(min=1), zero)
    recall = torch.where(both, tp / n_gt.clamp(min=1), zero)
    stats = (conf_sum, conf_cnt, iou_sum, iou_cnt, precision, recall,
             both.int(), n_gt, n_pred, tp)
    return {k: v.sum() for k, v in zip(STAT_KEYS, stats)}


class MetricAccumulator:
    """Host-side accumulator with the reference's metric dict keys."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    def update(self, stats: Dict[str, torch.Tensor]):
        """Adds one batch's partial sums (batch_eval_stats' tensors),
        fetched from their device in one copy."""
        vals = torch.stack([v.double() for v in stats.values()]).cpu()
        for k, v in zip(stats, vals.tolist()):
            self.totals[k] = self.totals.get(k, 0.0) + v

    def summary(self) -> Dict[str, float]:
        t = self.totals

        def div(a, b):
            return t.get(a, 0.0) / t[b] if t.get(b, 0) else 0.0

        mean_p = div("prec_sum", "pr_cnt")
        mean_r = div("rec_sum", "pr_cnt")
        f1 = (2 * mean_p * mean_r / (mean_p + mean_r)
              if (mean_p + mean_r) > 0 else 0.0)
        return {
            "mean_iou": div("iou_sum", "iou_cnt"),
            "mean_precision": mean_p,
            "mean_recall": mean_r,
            "f1_score": f1,
            "mean_confidence": div("conf_sum", "conf_cnt"),
            "total_gt_instances": int(t.get("gt_cnt", 0)),
            "total_pred_instances": int(t.get("pred_cnt", 0)),
            "total_true_positives": int(t.get("tp_cnt", 0)),
        }


def batch_stats_of(det: Detections, targets: Dict, bvalid, device,
                   score_thresh: float, iou_thresh: float
                   ) -> Dict[str, torch.Tensor]:
    """batch_eval_stats of one host batch from PackedDataset.batches,
    its GT sent to `device`."""
    return batch_eval_stats(
        det, torch.as_tensor(targets["boxes"], device=device),
        torch.as_tensor(targets["valid"], device=device),
        torch.as_tensor(bvalid, device=device),
        score_thresh=score_thresh, iou_thresh=iou_thresh)


def evaluate(eval_step, dataset, batch_size: int,
             score_thresh: float = 0.5, iou_thresh: float = 0.5,
             device=None) -> Dict[str, float]:
    """Full-split evaluation (the reference's evaluate): `eval_step`
    (parallel/train_step.py:make_eval_step) over dataset.batches, the
    sums on `device` (the card unless the caller passes "cpu")."""
    dev = resolve_device(device)
    acc = MetricAccumulator()
    for images, targets, bvalid in dataset.batches(batch_size):
        det = eval_step(images)
        acc.update(batch_stats_of(det, targets, bvalid, dev, score_thresh,
                                  iou_thresh))
    return acc.summary()
