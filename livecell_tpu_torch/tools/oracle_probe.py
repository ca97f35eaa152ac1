"""Oracle-box mask diagnosis (counterpart of scripts/oracle_probe.py).

Separates the causes of a low mask AP75 with the GT boxes as the
oracle:

  arm A (quantization ceiling, model-free): the dataset's stored 28x28
      GT mask targets pasted back at their own GT boxes, IoU against the
      rasterized GT. Bounds every mask head at this mask resolution and
      paste binarization.
  arm B (oracle-box masks): RoIAlign at the GT boxes -> mask head ->
      paste at the GT boxes -> IoU against the GT. The mask head alone,
      with perfect boxes.
  arm C (detections): the real inference path; each GT's best box IoU
      and best mask IoU. The gap between B and C is box localization
      and recall, not mask quality.

Each arm reports its IoU distribution binned by sqrt(GT box area), and
the fractions >= 0.75 (what AP75 needs) and >= 0.5.

    python -m livecell_tpu_torch.tools.oracle_probe \\
        --ckpt outputs/sweep/lc/a12_s0/models/custom_maskrcnn_10epochs.ckpt \\
        --data_dir /tmp/dense/split [--max_images 16] [--out FILE]

The instance slots are sized to the probed split alone. Runs on the
card; `main([...], device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from livecell_tpu_torch.config import Config, apply_dense_flags
from livecell_tpu_torch.data.coco import CocoIndex, ann_to_mask
from livecell_tpu_torch.data.dataset import get_datasets, instance_slots
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.ops.boxes import box_iou
from livecell_tpu_torch.ops.mask_ops import paste_masks, true_f32
from livecell_tpu_torch.parallel.train_step import (
    make_eval_step, normalize_batch)
from livecell_tpu_torch.tools.eval_ckpt import build_model, load_custom_model
from livecell_tpu_torch.train.coco_eval import mask_iou_matrix

BIN_EDGES = [0, 12, 16, 20, 24, 32, 1e9]
ARMS = ("quant_ceiling", "oracle_mask", "det_box", "det_mask")


def summarize(sizes: np.ndarray, ious: np.ndarray) -> dict:
    out = {"n": int(len(ious))}
    if len(ious):
        out.update(
            mean=round(float(ious.mean()), 4),
            p10=round(float(np.percentile(ious, 10)), 4),
            p50=round(float(np.percentile(ious, 50)), 4),
            p90=round(float(np.percentile(ious, 90)), 4),
            frac_ge_50=round(float((ious >= 0.5).mean()), 4),
            frac_ge_75=round(float((ious >= 0.75).mean()), 4))
    bins = {}
    for lo, hi in zip(BIN_EDGES[:-1], BIN_EDGES[1:]):
        sel = (sizes >= lo) & (sizes < hi)
        if sel.any():
            bins[f"{lo}-{'inf' if hi > 1e8 else hi}px"] = {
                "n": int(sel.sum()),
                "mean": round(float(ious[sel].mean()), 4),
                "frac_ge_75": round(float((ious[sel] >= 0.75).mean()), 4),
            }
    out["by_size"] = bins
    return out


def oracle_mask_probs(model, images: torch.Tensor, boxes: torch.Tensor
                      ) -> torch.Tensor:
    """Arm B: the mask head's foreground probabilities [B, K, m, m] at
    the boxes [B, K, 4], from the FPN's stride-4 map of the images
    (uint8 or [0, 1]), in the model's compute dtype."""
    x, _ = normalize_batch(images, None)
    with torch.inference_mode():
        feats = model.extract_features(x, levels=1)
        rois = model._roi_align(feats[0], boxes)
        logits = model.mask_head(rois.reshape((-1,) + rois.shape[2:]))
        m = model.cfg.mask_size
        return torch.sigmoid(logits[..., 1].reshape(boxes.shape[:2] + (m, m)))


def main(argv=None, device=None):
    """Returns the report as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data_dir", default="split")
    parser.add_argument("--split", default="test")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--paste_thresh", type=float, default=0.5)
    parser.add_argument("--max_images", type=int, default=0)
    parser.add_argument("--out", default=None)
    # The inference caps (as tools/eval_ckpt.py): arm C on dense scenes
    # is bound by the reference's 50-detection budget.
    parser.add_argument("--dets", type=int, default=0)
    parser.add_argument("--infer_nms", type=float, default=0.0)
    parser.add_argument("--det_nms", type=float, default=0.0)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    mcfg, sd = load_custom_model(args.ckpt, dataclasses.replace(
        Config().model, heads_all_images=True, decode_proposals=True), dev)
    mcfg = apply_dense_flags(mcfg, args.dets, args.infer_nms, args.det_nms)

    ds = get_datasets(args.data_dir, mcfg, device=dev)[args.split]
    observed = int(ds.instance_counts().max()) if len(ds) else 0
    auto_i = instance_slots(observed)
    if auto_i != mcfg.max_instances:
        mcfg = dataclasses.replace(mcfg, max_instances=auto_i)
        ds.cfg = mcfg

    model = build_model(mcfg, sd, dev)
    eval_step = make_eval_step(model, device=dev)
    ms = mcfg.mask_size
    image_hw = (mcfg.image_height, mcfg.image_width)
    th = min(ds.tile_hw[0], mcfg.image_height)
    tw = min(ds.tile_hw[1], mcfg.image_width)
    coco = CocoIndex(ds.ann_file)

    def paste_iou(probs, boxes, valid, gmasks):
        """[K, G] IoU of the masks pasted at `boxes` against the GT, in
        the region both share."""
        with true_f32(dev.type):
            full = paste_masks(probs.float(), boxes.float(), image_hw,
                               threshold=args.paste_thresh, valid=valid)
        return mask_iou_matrix(full[:, :th, :tw] > 0, gmasks).cpu().numpy()

    arms = {k: {"sizes": [], "ious": []} for k in ARMS}
    idx_cursor = 0
    n_done = 0
    for images, targets, bvalid in ds.batches(args.batch_size):
        gt_boxes = torch.as_tensor(targets["boxes"], device=dev)
        gt_valid = torch.as_tensor(targets["valid"], device=dev)
        probs_b = oracle_mask_probs(model, torch.as_tensor(images,
                                                           device=dev),
                                    gt_boxes)
        # Divided on the host as the stored targets are everywhere.
        quant_b = torch.as_tensor(np.asarray(targets["mask28"], np.float32)
                                  / 255.0, device=dev)
        det = eval_step(images)
        for bi in range(images.shape[0]):
            if not bvalid[bi]:
                continue
            tile_idx = idx_cursor
            idx_cursor += 1
            lo, hi = ds.offsets[tile_idx], ds.offsets[tile_idx + 1]
            n_gt = int(hi - lo)
            if n_gt == 0:
                continue
            n_done += 1
            img_id = int(ds.image_ids[tile_idx])
            gmasks = np.stack([ann_to_mask(a, th, tw)
                               for a in coco.get_anns(img_id)
                               if not a.get("iscrowd", 0)])
            g_t = torch.from_numpy(gmasks).to(dev)
            gb = ds.boxes[lo:hi]
            sizes = np.sqrt(np.maximum(
                (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]), 0))

            # Arms A and B: pasted at the GT boxes; each GT's best IoU
            # over the pasted masks.
            for arm, probs in (("quant_ceiling", quant_b[bi]),
                               ("oracle_mask", probs_b[bi])):
                m = paste_iou(probs, gt_boxes[bi], gt_valid[bi], g_t)
                per_gt = m[:n_gt].max(axis=0) if len(m) else \
                    np.zeros(gmasks.shape[0])
                arms[arm]["sizes"].append(sizes[:len(per_gt)])
                arms[arm]["ious"].append(per_gt[:len(sizes)])

            # Arm C: the detections; each GT's best box and mask IoU.
            valid = det.valid[bi]
            if bool(valid.any()):
                biou = box_iou(det.boxes[bi][valid].float(),
                               torch.from_numpy(gb).to(dev)).cpu().numpy()
                miou = paste_iou(det.mask_probs[bi], det.boxes[bi], valid,
                                 g_t)[valid.cpu().numpy()]
                arms["det_box"]["sizes"].append(sizes)
                arms["det_box"]["ious"].append(biou.max(axis=0))
                arms["det_mask"]["sizes"].append(sizes[:miou.shape[1]])
                arms["det_mask"]["ious"].append(miou.max(axis=0)[:len(sizes)])
        if args.max_images and n_done >= args.max_images:
            break

    report = {"ckpt": args.ckpt, "split": args.split,
              "data_dir": args.data_dir, "images": n_done,
              "paste_thresh": args.paste_thresh, "mask_size": ms}
    for arm, d in arms.items():
        if d["ious"]:
            report[arm] = summarize(np.concatenate(d["sizes"]),
                                    np.concatenate(d["ious"]))
    print(json.dumps(report, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
