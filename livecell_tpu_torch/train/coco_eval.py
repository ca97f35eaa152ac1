"""COCO-style mask and box AP (counterpart of
livecell_tpu/train/coco_eval.py).

The reference computes no AP (its evaluate() is box P/R/F1), and
pycocotools is not a dependency, so this module implements the COCO
protocol itself:

  * per image, an IoU matrix between detections and GT: mask IoU from
    one matrix product of the pasted masks on the device, or box IoU;
  * greedy score-ordered matching per IoU threshold, on the host;
  * 101-point interpolated AP averaged over thresholds .50:.05:.95.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from livecell_tpu_torch.data.coco import CocoIndex, ann_to_mask
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.ops.boxes import box_iou
from livecell_tpu_torch.ops.mask_ops import paste_masks, true_f32
from livecell_tpu_torch.train.metrics import MetricAccumulator, batch_stats_of

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def mask_iou_matrix(det_masks: torch.Tensor, gt_masks: torch.Tensor
                    ) -> torch.Tensor:
    """[D, H, W] x [G, H, W] binary -> [D, G] IoU via one matrix product
    (exact: 0/1 operands, also in TF32 or bf16, summed in f32 below 2^24
    pixels)."""
    d = det_masks.reshape(det_masks.shape[0], -1).float()
    g = gt_masks.reshape(gt_masks.shape[0], -1).float()
    inter = d @ g.T
    area_d = d.sum(dim=1)[:, None]
    area_g = g.sum(dim=1)[None, :]
    union = area_d + area_g - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-9),
                       torch.zeros_like(union))


def greedy_match(scores: np.ndarray, iou: np.ndarray, n_gt: int,
                 thresh: float) -> np.ndarray:
    """COCO per-image matching: detections in descending score order
    claim the highest-IoU unmatched GT above thresh. Returns tp flags."""
    return greedy_match_all(scores, iou, n_gt,
                            np.asarray([thresh]))[0]


def greedy_match_all(scores: np.ndarray, iou: np.ndarray, n_gt: int,
                     threshs: np.ndarray) -> np.ndarray:
    """Vectorized greedy matching for ALL thresholds in one detection
    sweep: per detection, a [T, G] candidate matrix picks each
    threshold's best unmatched GT (ties resolved to the last GT index,
    matching the original scalar loop's `>=` update rule).

    Returns tp flags [T, D].
    """
    order = np.argsort(-scores, kind="stable")
    t = len(threshs)
    d_n = len(scores)
    tp = np.zeros((t, d_n), bool)
    if n_gt == 0 or d_n == 0:
        return tp
    taken = np.zeros((t, n_gt), bool)
    iou_m = np.asarray(iou)[:, :n_gt]
    tcol = np.asarray(threshs)
    rows = np.arange(t)
    for d in order:
        cand = np.where(taken, -1.0, iou_m[d][None, :])   # [T, G]
        gi = n_gt - 1 - np.argmax(cand[:, ::-1], axis=1)  # last max
        ok = cand[rows, gi] >= tcol
        taken[ok, gi[ok]] = True
        tp[ok, d] = True
    return tp


def average_precision(all_scores: np.ndarray, all_tp: np.ndarray,
                      total_gt: int) -> float:
    """101-point interpolated AP."""
    if total_gt == 0 or len(all_scores) == 0:
        return 0.0
    order = np.argsort(-all_scores, kind="stable")
    tp = all_tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(
        idx, len(precision) - 1)], 0.0)
    prec_at[idx >= len(precision)] = 0.0
    return float(prec_at.mean())


def compute_ap(per_image: List[Tuple[np.ndarray, np.ndarray, int]]
               ) -> Dict[str, float]:
    """per_image: list of (scores [D], iou [D, n_gt], n_gt).

    Returns AP (mean over thresholds), AP50, AP75.
    """
    total_gt = sum(n_gt for _, _, n_gt in per_image)
    scores_all = [s for s, _, _ in per_image if len(s)]
    tp_rows = [greedy_match_all(scores, iou, n_gt, IOU_THRESHOLDS)
               for scores, iou, n_gt in per_image if len(scores)]

    aps = {}
    for ti, t in enumerate(IOU_THRESHOLDS):
        if scores_all:
            ap = average_precision(
                np.concatenate(scores_all),
                np.concatenate([tp[ti] for tp in tp_rows]), total_gt)
        else:
            ap = 0.0
        aps[round(float(t), 2)] = ap
    return {
        "AP": float(np.mean(list(aps.values()))),
        "AP50": aps[0.5],
        "AP75": aps[0.75],
    }


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def evaluate_coco(eval_step, dataset, batch_size: int,
                  iou_type: str = "segm", max_dets: int = 100,
                  device=None) -> Dict[str, float]:
    """Single-type wrapper over :func:`evaluate_coco_multi`."""
    return evaluate_coco_multi(eval_step, dataset, batch_size,
                               iou_types=(iou_type,), max_dets=max_dets,
                               device=device)[iou_type]


def unpack_gt(gpacked: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[G, th, ceil(tw/8)] uint8 in np.packbits order (MSB first) ->
    [G, th, tw] uint8 0/1, on gpacked's device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=gpacked.device)
    bits = (gpacked[..., None] >> shifts) & 1
    return bits.reshape(gpacked.shape[0], th, -1)[:, :, :tw]


def fused_mask_iou(probs: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, gpacked: torch.Tensor,
                   image_hw: Tuple[int, int], th: int, tw: int
                   ) -> torch.Tensor:
    """One tile's [D, G] mask IoU on the device: the bit-packed GT
    unpacked there, the detections' masks pasted at image_hw, both
    cropped to the shared th x tw region."""
    gmasks = unpack_gt(gpacked, th, tw)
    with true_f32(probs.device.type):
        full = paste_masks(probs, boxes, image_hw, valid=valid)
    return mask_iou_matrix(full[:, :th, :tw] > 0, gmasks)


def _gt_packed(dataset, coco: CocoIndex, tile_idx: int, th: int, tw: int
               ) -> np.ndarray:
    """The tile's non-crowd GT masks rasterized at th x tw and bit-packed,
    cached on the dataset by (tile, th, tw): a split is evaluated again
    every epoch, and one dataset may be evaluated at other input
    sizes."""
    gcache = getattr(dataset, "_gt_mask_cache", None)
    if gcache is None:
        gcache = {}
        dataset._gt_mask_cache = gcache
    ckey = (tile_idx, th, tw)
    if ckey not in gcache:
        img_id = int(dataset.image_ids[tile_idx])
        gmasks = np.stack([ann_to_mask(a, th, tw)
                           for a in coco.get_anns(img_id)
                           if not a.get("iscrowd", 0)])
        gcache[ckey] = np.packbits(gmasks.astype(np.uint8), axis=-1)
    return gcache[ckey]


def evaluate_coco_multi(eval_step, dataset, batch_size: int,
                        iou_types=("segm", "bbox"), max_dets: int = 100,
                        box_metrics: bool = False,
                        score_thresh: float = 0.5, iou_thresh: float = 0.5,
                        device=None) -> Dict[str, Dict[str, float]]:
    """Run the detector once over a split and compute COCO AP for every
    requested IoU type ('segm': pasted masks and mask IoU; 'bbox': box
    IoU), the IoU matrices on `device` (the card unless the caller
    passes "cpu").

    GT masks go to the device bit-packed (8x smaller) and are unpacked
    there; paste -> IoU is one call per tile whose only fetch is the
    [D, G] IoU matrix (the pasted masks never leave the device); GT
    counts are padded to multiples of 32. The ranking and the matching
    run on the host in numpy.

    With ``box_metrics=True`` the same detector pass also accumulates
    the reference's box IoU/P/R/F1 (train/metrics.py), returned under
    key ``"box_metrics"``.
    """
    dev = resolve_device(device)
    mcfg = dataset.cfg
    image_hw = (mcfg.image_height, mcfg.image_width)
    # Evaluate in the region both frames share: detections live on the
    # model-input grid (image_height/width, to which gather pads or crops
    # the stored tiles), GT annotations on the stored-tile grid.
    th = min(dataset.tile_hw[0], mcfg.image_height)
    tw = min(dataset.tile_hw[1], mcfg.image_width)
    coco = CocoIndex(dataset.ann_file) if "segm" in iou_types else None
    acc = MetricAccumulator() if box_metrics else None

    per_image = {t: [] for t in iou_types}
    idx_cursor = 0
    for images, targets, bvalid in dataset.batches(batch_size):
        det = eval_step(images)
        if box_metrics:
            acc.update(batch_stats_of(det, targets, bvalid, dev,
                                      score_thresh, iou_thresh))
        h_scores = det.scores.float().cpu().numpy()
        h_valid = det.valid.cpu().numpy()
        for bi in range(images.shape[0]):
            if not bvalid[bi]:
                continue
            tile_idx = idx_cursor
            idx_cursor += 1
            valid = h_valid[bi]
            scores = h_scores[bi][valid]
            lo, hi = dataset.offsets[tile_idx], dataset.offsets[tile_idx + 1]
            n_gt = int(hi - lo)
            if len(scores) == 0 or n_gt == 0:
                for t in iou_types:
                    per_image[t].append(
                        (scores, np.zeros((len(scores), n_gt)), n_gt))
                continue
            order = np.argsort(-scores)[:max_dets]
            gpad = _round_up(n_gt, 32)
            if "bbox" in iou_types:
                gboxes = np.zeros((gpad, 4), np.float32)
                gboxes[:n_gt] = dataset.boxes[lo:hi]
                iou = box_iou(det.boxes[bi].float(),
                              torch.from_numpy(gboxes).to(dev))
                iou = iou.cpu().numpy()[valid][:, :n_gt]
                per_image["bbox"].append((scores[order], iou[order], n_gt))
            if "segm" in iou_types:
                packed = _gt_packed(dataset, coco, tile_idx, th, tw)
                gpacked = np.zeros((gpad,) + packed.shape[1:], np.uint8)
                gpacked[:n_gt] = packed
                iou = fused_mask_iou(
                    det.mask_probs[bi], det.boxes[bi], det.valid[bi],
                    torch.from_numpy(gpacked).to(dev), image_hw, th, tw)
                iou = iou.cpu().numpy()[valid][:, :n_gt]
                per_image["segm"].append((scores[order], iou[order], n_gt))
    out = {t: compute_ap(per_image[t]) for t in iou_types}
    if box_metrics:
        out["box_metrics"] = acc.summary()
    return out
