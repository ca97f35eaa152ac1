"""Pipeline interpretability dashboards (counterpart of
livecell_tpu/serve/explain.py).

Forward hooks on the twelve stages (layer1-4, cbam1-4, fpn, rpn,
box_head, mask_head) record one inference pass, where the JAX package
uses flax's capture_intermediates; then feature-map images,
activation-magnitude "importance" percentages, the top RPN anchors and
a TP/FP/FN panel make a 3x4 matplotlib dashboard per image.

    python -m livecell_tpu_torch.serve.explain --model_path <ckpt> \
        --data_dir data_split

Runs on the card; `main([...], device="cpu")` runs on the CPU. The
activations are captured wherever the model runs; matplotlib is
imported only where the dashboard is drawn.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.detector import Detections
from livecell_tpu_torch.ops.anchors import generate_anchors
from livecell_tpu_torch.ops.boxes import box_iou
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.serve.stitch import input_tile

# The twelve hook points: (stage, submodule of the model).
STAGE_KEYS = [
    ("layer1", "backbone.layer1_1"),
    ("layer2", "backbone.layer2_1"),
    ("layer3", "backbone.layer3_1"),
    ("layer4", "backbone.layer4_1"),
    ("cbam1", "cbam1"),
    ("cbam2", "cbam2"),
    ("cbam3", "cbam3"),
    ("cbam4", "cbam4"),
    ("fpn", "fpn"),
    ("rpn", "rpn"),
    ("box_head", "box_head"),
    ("mask_head", "mask_head"),
]
# Stages whose maps the port keeps NCHW; they are handed on NHWC, the
# layout of the JAX package's activations (feature_map_image averages
# the last axis). The RPN's class logits are NHWC already.
NCHW_STAGES = ("layer1", "layer2", "layer3", "layer4", "cbam1", "cbam2",
               "cbam3", "cbam4", "fpn")


def _first_leaf(out):
    """A module's output, or the first leaf of a (nested) tuple of
    per-level outputs (level 0)."""
    while isinstance(out, (tuple, list)):
        if not out:
            return None
        out = out[0]
    return out


def feature_map_image(act: np.ndarray) -> np.ndarray:
    """Channel-mean (last axis) -> minmax-normalize."""
    if act.ndim == 4:
        act = act[0]
    fm = act.astype(np.float32).mean(axis=-1)
    lo, hi = fm.min(), fm.max()
    return (fm - lo) / (hi - lo + 1e-8)


def importance_percentages(acts: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Mean |activation| per stage, normalized to percentages."""
    raw = {k: float(np.abs(v).mean()) for k, v in acts.items()
           if v is not None}
    total = sum(raw.values()) or 1.0
    return {k: 100.0 * v / total for k, v in raw.items()}


def capture_activations(model, image_f32: np.ndarray):
    """One inference pass of `model` over one image (float [H, W, 3] at
    the model's input size), with a forward hook on each stage of
    STAGE_KEYS that the model has. Returns (Detections as numpy arrays,
    {stage: activation as float32 numpy, NHWC, or None}).

    Each stage keeps its first call's output (the flagship's second mask
    pass calls the heads again), and of a tuple its first leaf: P2 for
    the FPN, the level-0 class logits for the RPN, the class logits for
    the box head. Every hook is removed before returning, also on
    error."""
    dev = next(model.parameters()).device
    captured: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(module, inputs, output):
            if name not in captured:
                leaf = _first_leaf(output)
                if leaf is not None:
                    captured[name] = leaf.detach().clone()
        return record

    modules = dict(model.named_modules())
    handles = []
    try:
        for name, path in STAGE_KEYS:
            if path in modules:
                handles.append(modules[path].register_forward_hook(
                    hook(name)))
        det = model.inference_forward(
            torch.as_tensor(np.asarray(image_f32, np.float32),
                            device=dev)[None])
    finally:
        for h in handles:
            h.remove()

    acts: Dict[str, Optional[np.ndarray]] = {}
    for name, _ in STAGE_KEYS:
        t = captured.get(name)
        if t is not None and name in NCHW_STAGES and t.ndim == 4:
            t = t.permute(0, 2, 3, 1)
        acts[name] = None if t is None else t.float().cpu().numpy()
    det = Detections(*(t.float().cpu().numpy() if t.is_floating_point()
                       else t.cpu().numpy() for t in det))
    return det, acts


def top_rpn_proposals(acts: Dict[str, np.ndarray], model_cfg: ModelConfig,
                      k: int = 50) -> np.ndarray:
    """Top-k anchor boxes by the hooked RPN objectness."""
    rpn_out = acts.get("rpn")
    if rpn_out is None:
        return np.zeros((0, 4), np.float32)
    obj = np.asarray(rpn_out).reshape(-1)
    anchors = generate_anchors(
        (model_cfg.feature_height, model_cfg.feature_width),
        model_cfg.anchor_stride, model_cfg.anchor_sizes,
        model_cfg.anchor_ratios)
    idx = np.argsort(-obj)[:k]
    return anchors[idx]


def detection_counts(boxes: np.ndarray, keep: np.ndarray,
                     gt_boxes: np.ndarray) -> tuple:
    """(TP, FP, FN) of the kept detections against the GT at box IoU
    0.5: a detection whose best IoU exceeds 0.5 is a true positive."""
    tp = fp = fn = 0
    if len(gt_boxes) and keep.any():
        iou = box_iou(torch.as_tensor(np.asarray(boxes[keep], np.float32)),
                      torch.as_tensor(np.asarray(gt_boxes, np.float32))
                      ).numpy()
        tp = int((iou.max(axis=1) > 0.5).sum())
        fp = int(keep.sum()) - tp
        fn = max(len(gt_boxes) - tp, 0)
    elif len(gt_boxes):
        fn = len(gt_boxes)
    return tp, fp, fn


def explain_image(model, image_u8: np.ndarray, gt_boxes: np.ndarray,
                  save_path: str, score_threshold: float = 0.5):
    """Build one 3x4 dashboard PNG for a custom model (the RPN panel
    places the custom model's anchors)."""
    mcfg = model.cfg
    if not isinstance(mcfg, ModelConfig):
        raise ValueError("the explainer's dashboard takes the custom model")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    ih, iw = input_tile(mcfg)
    h, w = image_u8.shape[:2]
    canvas = np.zeros((ih, iw, 3), np.float32)
    canvas[:h, :w] = image_u8[:ih, :iw] / 255.0

    det, acts = capture_activations(model, canvas)
    imp = importance_percentages(acts)
    proposals = top_rpn_proposals(acts, mcfg)

    boxes = det.boxes[0]
    scores = det.scores[0]
    keep = det.valid[0] & (scores > score_threshold)
    tp, fp, fn = detection_counts(boxes, keep, gt_boxes)

    fig, axes = plt.subplots(3, 4, figsize=(22, 14))
    axes = axes.ravel()

    axes[0].imshow(image_u8)
    axes[0].set_title("Input")

    panel = 1
    for name in ("layer1", "layer2", "layer4", "cbam1", "cbam4", "fpn"):
        if acts.get(name) is not None:
            axes[panel].imshow(feature_map_image(acts[name]), cmap="jet")
        axes[panel].set_title(name)
        panel += 1

    ax = axes[panel]
    ax.imshow(image_u8)
    for b in proposals:
        ax.add_patch(patches.Rectangle((b[0], b[1]), b[2] - b[0],
                                       b[3] - b[1], fill=False,
                                       edgecolor="yellow", linewidth=0.5))
    ax.set_title(f"Top-{len(proposals)} RPN proposals")
    panel += 1

    ax = axes[panel]
    ax.imshow(image_u8)
    for b, s in zip(boxes[keep], scores[keep]):
        ax.add_patch(patches.Rectangle((b[0], b[1]), b[2] - b[0],
                                       b[3] - b[1], fill=False,
                                       edgecolor="lime", linewidth=1.0))
    ax.set_title(f"Final detections ({int(keep.sum())})")
    panel += 1

    ax = axes[panel]
    overlay = np.zeros((ih, iw), np.float32)
    if keep.any():
        full = paste_masks(torch.from_numpy(det.mask_probs[0]),
                           torch.from_numpy(boxes), (ih, iw),
                           valid=torch.from_numpy(keep)).numpy()
        overlay = (full > 0).sum(axis=0).astype(np.float32)
    ax.imshow(image_u8)
    shown = np.ma.masked_where(overlay[:h, :w] == 0, overlay[:h, :w])
    ax.imshow(shown, alpha=0.5, cmap="spring")
    ax.set_title("Mask overlay")
    panel += 1

    ax = axes[panel]
    names = list(imp.keys())
    ax.barh(names, [imp[n] for n in names], color="steelblue")
    ax.set_title("Stage importance (% of mean |activation|)")
    panel += 1

    ax = axes[panel]
    ax.axis("off")
    ax.text(0.05, 0.6, f"TP: {tp}\nFP: {fp}\nFN: {fn}\n"
            f"GT instances: {len(gt_boxes)}", fontsize=16)
    ax.set_title("Metrics @ IoU 0.5")

    for a in axes:
        if not a.get_title().startswith("Stage importance"):
            a.axis("off")
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved explanation dashboard: {save_path}")
    return save_path


def main(argv=None, device=None):
    """Dashboards of the first, middle and last image of a split, on
    `device` (the card unless the caller passes "cpu")."""
    parser = argparse.ArgumentParser(description="Pipeline explainability")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--model_type", type=str, default="custom")
    parser.add_argument("--data_dir", type=str, default="data_split")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--output_dir", type=str, default="outputs/explain")
    args = parser.parse_args(argv)

    from livecell_tpu_torch.data.dataset import PackedDataset
    from livecell_tpu_torch.serve.visualize import load_model

    dev = resolve_device(device)
    model = load_model(args.model_path, args.model_type, device=dev)
    ds = PackedDataset(args.data_dir, args.split, ModelConfig(), device=dev)

    paths = []
    for idx in sorted({0, len(ds) // 2, len(ds) - 1}):
        img = ds.images[idx]
        lo, hi = ds.offsets[idx], ds.offsets[idx + 1]
        gt = ds.boxes[lo:hi]
        paths.append(explain_image(model, img, gt, os.path.join(
            args.output_dir, f"explain_{idx:04d}.png")))
    return paths


if __name__ == "__main__":
    main()
