"""The model-free COCO AP ceiling of a split at given detection caps
(counterpart of scripts/gt_bound.py).

The split's own ground truth goes through the inference pipeline's
structural stages: confidence ordering (seeded uniform scores),
class-agnostic greedy NMS at `--det_nms` and the `--dets` cap, and is
scored by train/coco_eval.py:compute_ap, the AP code of evaluation. No
detector can beat this number on the split at these caps: every loss
comes from GT instances suppressing each other under NMS or falling off
the detection budget. The 28x28 mask quantization is left out (the
oracle probe's arm A bounds it, tools/oracle_probe.py).

    python -m livecell_tpu_torch.tools.gt_bound --data_dir /tmp/dense/split \\
        --dets 256 --det_nms 0.6 [--seeds 3] [--no_segm] [--out FILE]

Numpy only: it touches no device and runs beside a job on the card.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from livecell_tpu_torch.data.coco import CocoIndex, ann_to_mask
from livecell_tpu_torch.train.coco_eval import compute_ap


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of xyxy boxes, [n, m] float32."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def mask_iou_np(masks: np.ndarray) -> np.ndarray:
    """Pairwise IoU of binary masks [G, H, W] -> [G, G]."""
    m = masks.reshape(masks.shape[0], -1).astype(np.float32)
    inter = m @ m.T
    areas = m.sum(axis=1)
    union = areas[:, None] + areas[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def greedy_nms(iou: np.ndarray, order: np.ndarray, thr: float) -> np.ndarray:
    """Indices (in `order` sequence) surviving greedy NMS at `thr`."""
    keep = []
    alive = np.ones(len(order), bool)
    for pos, i in enumerate(order):
        if not alive[pos]:
            continue
        keep.append(i)
        alive &= iou[i][order] <= thr
        alive[pos] = False
    return np.asarray(keep, dtype=np.int64)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--dets", type=int, default=256)
    p.add_argument("--det_nms", type=float, default=0.6)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--no_segm", action="store_true",
                   help="skip the mask-IoU arm (bbox only; much faster)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    ann = Path(args.data_dir) / "annotations" / \
        f"livecell_coco_{args.split}.json"
    coco = CocoIndex(str(ann))

    # Each tile's GT once; the seeds reuse it.
    tiles = []
    for img_id in coco.get_img_ids():
        anns = [a for a in coco.get_anns(img_id)
                if not a.get("iscrowd", 0)]
        if not anns:
            continue
        img = coco.imgs[img_id]
        h, w = int(img["height"]), int(img["width"])
        boxes = np.asarray([a["bbox"] for a in anns], np.float32)
        boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
        biou = box_iou_np(boxes, boxes)
        miou = None
        if not args.no_segm:
            masks = np.stack([ann_to_mask(a, h, w) for a in anns])
            miou = mask_iou_np(masks)
        tiles.append((boxes.shape[0], biou, miou))

    res = {"bbox": [], "segm": []}
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        per_image = {"bbox": [], "segm": []}
        for n_gt, biou, miou in tiles:
            scores = rng.uniform(0.5, 1.0, n_gt).astype(np.float32)
            order = np.argsort(-scores)
            keep = greedy_nms(biou, order, args.det_nms)[:args.dets]
            s = scores[keep]
            per_image["bbox"].append((s, biou[keep], n_gt))
            if miou is not None:
                per_image["segm"].append((s, miou[keep], n_gt))
        res["bbox"].append(compute_ap(per_image["bbox"]))
        if not args.no_segm:
            res["segm"].append(compute_ap(per_image["segm"]))

    out = {"data_dir": args.data_dir, "split": args.split,
           "dets": args.dets, "det_nms": args.det_nms,
           "seeds": args.seeds, "n_tiles": len(tiles),
           "n_gt_total": int(sum(t[0] for t in tiles))}
    for t in ("bbox", "segm"):
        if res[t]:
            for k in ("AP", "AP50", "AP75"):
                vals = np.asarray([r[k] for r in res[t]])
                out[f"{t}_{k}"] = round(float(vals.mean()), 4)
                out[f"{t}_{k}_spread"] = round(float(np.ptp(vals)), 4)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
