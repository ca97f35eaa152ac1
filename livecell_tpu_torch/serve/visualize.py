"""GT-vs-prediction full-frame visualization CLI (counterpart of
livecell_tpu/serve/visualize.py).

    python -m livecell_tpu_torch.serve.visualize \
        --model1_path models/custom_maskrcnn_5epochs.ckpt \
        --model1_type custom --test_dir data_split/test/images

Per base frame: its tiles decoded (data/png.py), one batched forward of
each model with the fused dedup (serve/stitch.py), frame
reconstruction, colored instance mask overlays for predictions and
ground truth (RLE or polygon), and a side-by-side PNG per frame. The
frames run through serve/pipeline.py. Runs on the card; `main([...],
device="cpu")` runs on the CPU. PIL and matplotlib are imported only
where a panel is drawn (or a raw frame read), so every other stage runs
where they are missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from livecell_tpu_torch.config import (
    Config, ModelConfig, TileConfig, add_dense_flags, apply_dense_flags)
from livecell_tpu_torch.config import model_type as type_of
from livecell_tpu_torch.data.coco import polygons_to_mask, rle_decode
from livecell_tpu_torch.data.tiling import read_frame
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.ops.boxes import box_iou
from livecell_tpu_torch.serve import app
from livecell_tpu_torch.serve.pipeline import PipelineStats, run_pipelined
from livecell_tpu_torch.serve.render import (
    composite, instance_overlay, render_panels)
from livecell_tpu_torch.serve.stitch import (
    StitchedDetections, group_tiles_by_image, load_tiles,
    make_frame_predictor, reconstruct_full_image)


def load_model(model_path: str, model_type: str = "custom", mcfg=None,
               device=None):
    """Load a checkpoint directory, the port's or the JAX package's
    (serve/app.py:load_model), onto `device` (the card unless the caller
    passes "cpu").

    The checkpoint's stored config is the base. Fields the caller's
    `mcfg` explicitly changed from ModelConfig()'s defaults (the dense
    flags of apply_dense_flags) overlay a custom model's; a transfer
    model has none of those settings, so such changes raise. A
    `model_type` that disagrees with the checkpoint raises."""
    if model_type not in ("custom", "transfer"):
        raise ValueError(f"Unknown model_type: {model_type}")
    print(f"Loading {model_type} model from {model_path}...")
    model = app.load_model(model_path, device, model_type)
    kind = type_of(model.cfg)
    if kind != model_type:
        raise ValueError(f"model_type {model_type!r}, but {model_path} "
                         f"holds a {kind!r} model")
    if mcfg is not None:
        base = ModelConfig()
        diff = {f.name: getattr(mcfg, f.name)
                for f in dataclasses.fields(mcfg)
                if getattr(mcfg, f.name) != getattr(base, f.name)}
        if diff and kind == "transfer":
            raise ValueError(f"{sorted(diff)} apply to the custom model "
                             f"only")
        if diff:
            model.cfg = dataclasses.replace(model.cfg, **diff)
    return model


def load_coco_annotations(json_path: str):
    """filename -> annotations map, and the id -> filename map."""
    with open(json_path) as f:
        data = json.load(f)
    images = {img["id"]: img["file_name"] for img in data["images"]}
    by_image = defaultdict(list)
    for ann in data["annotations"]:
        if ann["image_id"] in images:
            by_image[images[ann["image_id"]]].append(ann)
    return dict(by_image), images


def create_mask_overlay(dets: StitchedDetections, frame_hw) -> np.ndarray:
    """RGBA overlay of predicted instance masks, tab20-colored."""
    return instance_overlay(list(dets.masks), dets.offsets, frame_hw)


def decode_gt_masks(annotations: List[Dict], frame_hw) -> List[np.ndarray]:
    """Full-frame boolean masks from RLE or polygon segmentations."""
    h, w = frame_hw
    masks = []
    for ann in annotations:
        seg = ann.get("segmentation")
        if isinstance(seg, dict):
            masks.append(rle_decode(seg, (h, w)) > 0)
        elif isinstance(seg, list):
            masks.append(polygons_to_mask(seg, h, w) > 0)
    return masks


def create_gt_mask_overlay(annotations: List[Dict], frame_hw):
    """RGBA overlay of GT masks from RLE or polygons, and their count."""
    masks = decode_gt_masks(annotations, frame_hw)
    return instance_overlay(masks, None, frame_hw), len(masks)


def prediction_panels(image: np.ndarray, gt_boxes: np.ndarray,
                      pred_boxes: np.ndarray, pred_scores: np.ndarray,
                      path: str, score_thresh: float = 0.5) -> Dict:
    """3-panel training-progress figure: original / GT boxes (green) /
    predictions over `score_thresh` (red, score + best-IoU labels).
    `image` is HxWx3 float [0,1] or uint8; boxes are xyxy. Returns the
    summary stats (instance counts, mean confidence/IoU)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = np.clip(img, 0, 1)

    keep = pred_scores > score_thresh
    pb, ps = pred_boxes[keep], pred_scores[keep]
    if len(gt_boxes) and len(pb):
        ious = box_iou(torch.as_tensor(np.asarray(pb, np.float32)),
                       torch.as_tensor(np.asarray(gt_boxes, np.float32))
                       ).numpy().max(axis=1)
    else:
        ious = np.zeros(len(pb), np.float32)

    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    axes[0].imshow(img)
    axes[0].set_title("Original Image")
    axes[1].imshow(img)
    axes[1].set_title(f"Ground Truth ({len(gt_boxes)} instances)")
    for box in gt_boxes:
        x1, y1, x2, y2 = box
        axes[1].add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, linewidth=2,
            edgecolor="green", facecolor="none"))
    axes[2].imshow(img)
    axes[2].set_title(f"Predictions ({len(pb)} instances, "
                      f"score > {score_thresh})")
    for box, score, iou in zip(pb, ps, ious):
        x1, y1, x2, y2 = box
        axes[2].add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, linewidth=2,
            edgecolor="red", facecolor="none"))
        axes[2].text(x1, y1 - 5, f"{score:.2f} (IoU:{iou:.2f})",
                     color="red", fontsize=8, weight="bold",
                     bbox=dict(facecolor="white", alpha=0.7,
                               edgecolor="none"))
    for ax in axes:
        ax.axis("off")
    plt.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return {"gt_instances": int(len(gt_boxes)),
            "pred_instances": int(len(pb)),
            "mean_confidence": float(ps.mean()) if len(ps) else 0.0,
            "mean_iou": float(ious.mean()) if len(ious) else 0.0}


def visualize_with_ground_truth(base_name: str,
                                original_img: Optional[np.ndarray],
                                annotations: List[Dict],
                                results_list: List[StitchedDetections],
                                tiles_list: List[np.ndarray],
                                model_names: List[str],
                                save_dir: str = "outputs",
                                score_threshold: float = 0.5,
                                mask_threshold: float = 0.4,
                                tile_cfg=None,
                                renderer: str = "fast"):
    """Side-by-side GT / per-model prediction panel, written to
    `save_dir/<base_name>_GT_VS_PREDICTIONS.png`.

    renderer="fast" (default) composites with numpy + PIL at native
    frame resolution (serve/render.py); renderer="mpl" draws a
    matplotlib figure (object-oriented Figure + Agg, safe on the
    pipeline's overlay threads)."""
    tile_cfg = tile_cfg or TileConfig()
    frame_hw = (tile_cfg.frame_height, tile_cfg.frame_width)
    os.makedirs(save_dir, exist_ok=True)
    num_plots = 1 + len(results_list)
    full_canvas = reconstruct_full_image(tiles_list[0], tile_cfg)

    if renderer == "fast":
        panels = []
        if original_img is not None:
            base = np.asarray(original_img)
            if base.shape[:2] != frame_hw:
                from PIL import Image

                base = np.asarray(Image.fromarray(base).resize(
                    (frame_hw[1], frame_hw[0])))
            gt_overlay, gt_count = create_gt_mask_overlay(
                annotations, frame_hw)
            panels.append((composite(base, gt_overlay),
                           f"Ground Truth: {base_name} | "
                           f"Instances: {gt_count}", []))
        else:
            blank = np.full((*frame_hw, 3), 235, np.uint8)
            panels.append((blank, f"Ground Truth: {base_name} "
                           "(GT Not Available)", []))
        canvas_u8 = (np.clip(full_canvas, 0, 1) * 255).astype(np.uint8)
        for dets, name in zip(results_list, model_names):
            overlay = create_mask_overlay(dets, frame_hw)
            labels = []
            for k in range(len(dets.scores)):
                mask = dets.masks[k]
                if mask.any():
                    ys, xs = np.nonzero(mask)
                    labels.append((float(xs.mean() + dets.offsets[k, 0]),
                                   float(ys.mean() + dets.offsets[k, 1]),
                                   f"{dets.scores[k]:.2f}"))
            panels.append((composite(canvas_u8, overlay),
                           f"{name}: {base_name} | "
                           f"Instances: {len(dets.scores)}", labels))
        save_path = os.path.join(save_dir,
                                 f"{base_name}_GT_VS_PREDICTIONS.png")
        render_panels(
            panels, f"Ground Truth vs Predictions | "
            f"Score>{score_threshold} | "
            f"Mask>{mask_threshold * 100:.0f}%", save_path)
        print(f"Saved GT vs Predictions: {save_path}")
        return save_path

    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(10 * num_plots, 10))
    FigureCanvasAgg(fig)
    axes = np.atleast_1d(fig.subplots(1, num_plots))

    if original_img is not None:
        axes[0].imshow(original_img)
        gt_overlay, gt_count = create_gt_mask_overlay(annotations, frame_hw)
        axes[0].imshow(gt_overlay)
        axes[0].set_title(f"Ground Truth: {base_name}\n"
                          f"Instances: {gt_count}", fontsize=12)
    else:
        axes[0].text(0.5, 0.5, "GT Not Available", ha="center", va="center")
        axes[0].set_title(f"Ground Truth: {base_name}", fontsize=12)
    axes[0].axis("off")

    for i, (dets, name) in enumerate(zip(results_list, model_names)):
        ax = axes[i + 1]
        ax.imshow(full_canvas)
        ax.imshow(create_mask_overlay(dets, frame_hw))
        for k in range(len(dets.scores)):
            mask = dets.masks[k]
            if mask.any():
                ys, xs = np.nonzero(mask)
                ax.text(xs.mean() + dets.offsets[k, 0],
                        ys.mean() + dets.offsets[k, 1],
                        f"{dets.scores[k]:.2f}", color="white", fontsize=6,
                        weight="bold", ha="center", va="center",
                        bbox=dict(facecolor="black", alpha=0.7,
                                  edgecolor="none", pad=1))
        ax.set_title(f"{name}: {base_name}\nInstances: {len(dets.scores)}",
                     fontsize=12)
        ax.axis("off")

    fig.suptitle(f"Ground Truth vs Predictions | Score>{score_threshold} | "
                 f"Mask>{mask_threshold * 100:.0f}%", fontsize=14, y=0.98)
    fig.tight_layout()
    save_path = os.path.join(save_dir, f"{base_name}_GT_VS_PREDICTIONS.png")
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    print(f"Saved GT vs Predictions: {save_path}")
    return save_path


def index_raw_frames(data_dir: str):
    """(filename -> annotations, filename -> image directory) over the raw
    (untiled) LIVECell tree's test, train and val splits, where their
    annotation files exist."""
    ann_by_image: Dict[str, List] = {}
    filename_to_dir: Dict[str, str] = {}
    for split in ("test", "train", "val"):
        ann_path = os.path.join(data_dir, "annotations",
                                f"livecell_coco_{split}.json")
        img_dir = os.path.join(data_dir, split, "images")
        if os.path.exists(ann_path):
            anns, imgs = load_coco_annotations(ann_path)
            ann_by_image.update(anns)
            for fname in imgs.values():
                filename_to_dir[fname] = img_dir
    return ann_by_image, filename_to_dir


class FrameStages(NamedTuple):
    """The stages of the pipelined frame loop (serve/pipeline.py)."""

    decode: Callable    # (base_name, tiles_info) -> (tiles, raw, anns)
    dispatch: Callable  # decoded -> one device handle per predictor
    fetch: Callable     # handles -> [StitchedDetections] per predictor
    consume: Callable   # (item, decoded, results) -> PNG panel


def frame_stages(predictors: List, names: List[str], tile_cfg: TileConfig,
                 ann_by_image: Dict[str, List],
                 filename_to_dir: Dict[str, str], save_dir: str = "outputs",
                 score_threshold: float = 0.5, mask_threshold: float = 0.4,
                 renderer: str = "fast") -> FrameStages:
    """The decode, dispatch, fetch and consume stages of the CLI's frame
    loop over `predictors` (make_frame_predictor's, one per model).
    Decode reads the tiles and, where the raw tree holds the frame, the
    raw frame (data/tiling.py:read_frame) and its annotations; dispatch
    and fetch run every predictor; consume draws the panel."""
    def decode(item):
        base_name, tiles_info = item
        tiles = load_tiles(tiles_info, tile_cfg)
        original_img = None
        annotations = []
        for fname, d in filename_to_dir.items():
            if os.path.splitext(fname)[0] == base_name or fname == base_name:
                p = os.path.join(d, fname)
                if os.path.exists(p):
                    original_img = read_frame(p)
                    annotations = ann_by_image.get(fname, [])
                break
        return tiles, original_img, annotations

    def dispatch(decoded):
        tiles, _, _ = decoded
        return [predict.dispatch(tiles) for predict in predictors]

    def fetch(handles):
        return [predict.fetch(h) for predict, h in zip(predictors, handles)]

    def consume(item, decoded, results):
        base_name, _ = item
        tiles, original_img, annotations = decoded
        visualize_with_ground_truth(
            base_name, original_img, annotations, results,
            [tiles] * len(results), names, save_dir=save_dir,
            score_threshold=score_threshold, mask_threshold=mask_threshold,
            tile_cfg=tile_cfg, renderer=renderer)

    return FrameStages(decode, dispatch, fetch, consume)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Mask R-CNN dual model inference with tiled images")
    parser.add_argument("--model1_path", type=str,
                        default="models/custom_maskrcnn_5epochs.ckpt")
    parser.add_argument("--model1_type", type=str, default="custom",
                        choices=["custom", "transfer"])
    parser.add_argument("--model1_name", type=str, default="Custom Model")
    parser.add_argument("--model2_path", type=str, default=None)
    parser.add_argument("--model2_type", type=str, default="transfer",
                        choices=["custom", "transfer"])
    parser.add_argument("--model2_name", type=str,
                        default="Transfer Learning Model")
    parser.add_argument("--test_dir", type=str,
                        default="data_split/test/images")
    parser.add_argument("--data_dir", type=str, default="data",
                        help="Raw (untiled) LIVECell tree for GT frames")
    parser.add_argument("--output_dir", type=str, default="outputs")
    parser.add_argument("--score_threshold", type=float, default=0.5)
    parser.add_argument("--mask_threshold", type=float, default=0.4)
    parser.add_argument("--renderer", type=str, default="fast",
                        choices=["fast", "mpl"],
                        help="fast: numpy+PIL native-resolution panels; "
                        "mpl: reference-style matplotlib figure")
    add_dense_flags(parser)
    return parser


def main(argv=None, tile_cfg: Optional[TileConfig] = None,
         device=None) -> PipelineStats:
    """Run the CLI on the flags in `argv` over frames of `tile_cfg`
    (TileConfig() by default), on `device` (the card unless the caller
    passes "cpu"). Returns the pipeline's stats."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    cfg = Config()
    mcfg = apply_dense_flags(cfg.model, args.dets, args.infer_nms,
                             args.det_nms)
    tile_cfg = tile_cfg or cfg.tile

    ann_by_image, filename_to_dir = index_raw_frames(args.data_dir)
    tiles_by_image = group_tiles_by_image(args.test_dir)
    print(f"Processing {len(tiles_by_image)} image sets from "
          f"{args.test_dir}")

    predictors = []
    names = []
    for path, mtype, name in [
            (args.model1_path, args.model1_type, args.model1_name),
            (args.model2_path, args.model2_type, args.model2_name)]:
        if path:
            model = load_model(path, mtype, mcfg=mcfg, device=dev)
            predictors.append(make_frame_predictor(
                model, tile_cfg, args.score_threshold, args.mask_threshold,
                device=dev))
            names.append(name)

    st = frame_stages(predictors, names, tile_cfg, ann_by_image,
                      filename_to_dir, args.output_dir, args.score_threshold,
                      args.mask_threshold, args.renderer)
    stats = run_pipelined(list(tiles_by_image.items()), st.decode,
                          st.dispatch, st.consume, fetch_fn=st.fetch)
    for item, err in stats.errors:
        print(f"ERROR on {item[0]}: {err!r}")
    print(f"\nFinished {stats.frames} frames "
          f"({json.dumps(stats.as_dict())}).\n"
          f"Visualizations saved to {args.output_dir}")
    return stats


if __name__ == "__main__":
    main()
