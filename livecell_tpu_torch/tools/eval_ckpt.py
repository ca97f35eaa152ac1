"""Evaluate a saved custom-model checkpoint without retraining
(counterpart of scripts/eval_ckpt.py).

The inference-time settings, the detection budget and the NMS
thresholds (`--dets/--infer_nms/--det_nms`) and the score threshold, can
be swept on one trained model in seconds instead of a new training run.

    python -m livecell_tpu_torch.tools.eval_ckpt \\
        --ckpt models/custom_maskrcnn_10epochs.ckpt --data_dir split \\
        --fixed_heads --decode_proposals --dets 256 --infer_nms 0.7 \\
        --det_nms 0.5

The checkpoint is a train/checkpoint.py directory of the custom model.
Its sidecar's ModelConfig is the model (JAX route names map through
config.JAX_ROUTES); without a sidecar, Config().model with
--fixed_heads/--decode_proposals/--frozen_bn. A transfer checkpoint is
refused. Runs on the card; `main([...], device="cpu")` on the CPU.
Prints one JSON line: the box IoU/P/R/F1 and COCO mask and box AP.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from livecell_tpu_torch.config import (
    Config, apply_dense_flags, config_from_dict)
from livecell_tpu_torch.data.dataset import get_datasets, instance_slots
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.mask_rcnn import create_model
from livecell_tpu_torch.parallel.train_step import make_eval_step
from livecell_tpu_torch.train import metrics as metrics_lib
from livecell_tpu_torch.train.coco_eval import evaluate_coco_multi


def load_custom_model(path: str, fallback, device):
    """(ModelConfig, state dict on `device`) of a custom checkpoint
    directory: the sidecar's config, else `fallback`. A checkpoint of
    another model type exits with a message."""
    sidecar = Path(path) / "model_config.json"
    mcfg = fallback
    if sidecar.exists():
        kind, mcfg = config_from_dict(json.loads(sidecar.read_text()))
        if kind != "custom":
            raise SystemExit(f"{path} holds a {kind} model; the quality "
                             f"tools evaluate the custom model only")
    sd = torch.load(Path(path) / "model.pt", map_location=device,
                    weights_only=True)
    return mcfg, sd


def build_model(mcfg, sd, device):
    """The serving model of `mcfg` holding `sd`; exits when the
    checkpoint's tensors do not match the configured model."""
    model = create_model(mcfg, device=device)
    ref = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if ref != {k: tuple(v.shape) for k, v in sd.items()}:
        raise SystemExit("checkpoint params do not match the model "
                         "config (wrong --fixed_heads/--decode_proposals?)")
    model.load_state_dict(sd)
    return model


def main(argv=None, device=None):
    """Returns the printed row as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data_dir", default="split")
    parser.add_argument("--split", default="test")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--fixed_heads", action="store_true",
                        help="model was trained with --fixed_heads")
    parser.add_argument("--decode_proposals", action="store_true",
                        help="model was trained with --decode_proposals")
    parser.add_argument("--frozen_bn", action="store_true")
    parser.add_argument("--dets", type=int, default=0)
    parser.add_argument("--infer_nms", type=float, default=0.0)
    parser.add_argument("--det_nms", type=float, default=0.0)
    parser.add_argument("--score_thresh", type=float, default=0.5)
    parser.add_argument("--iou_thresh", type=float, default=0.5)
    parser.add_argument("--no_coco_ap", action="store_true")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    # The training-time config (anchor geometry, budgets, quirk
    # switches) travels with the checkpoint; the flags below override
    # only the inference caps being swept.
    mcfg, sd = load_custom_model(args.ckpt, dataclasses.replace(
        Config().model, heads_all_images=args.fixed_heads,
        decode_proposals=args.decode_proposals, frozen_bn=args.frozen_bn),
        dev)
    mcfg = apply_dense_flags(mcfg, args.dets, args.infer_nms, args.det_nms)

    datasets = get_datasets(args.data_dir, mcfg, device=dev)
    ds = datasets[args.split]
    observed = max((int(d.instance_counts().max())
                    for d in datasets.values() if len(d)), default=0)
    auto_i = instance_slots(observed)
    if observed and auto_i != mcfg.max_instances:
        mcfg = dataclasses.replace(mcfg, max_instances=auto_i)
        for d in datasets.values():
            d.cfg = mcfg

    eval_step = make_eval_step(build_model(mcfg, sd, dev), device=dev)
    row = {"split": args.split, "dets": mcfg.max_detections,
           "infer_nms": mcfg.infer_nms_thresh,
           "det_nms": mcfg.det_nms_thresh}
    if args.no_coco_ap:
        tm = metrics_lib.evaluate(eval_step, ds, args.batch_size,
                                  args.score_thresh, args.iou_thresh,
                                  device=dev)
    else:
        # One detector pass over the split: box P/R/F1, COCO mask AP and
        # COCO box AP together.
        aps = evaluate_coco_multi(eval_step, ds, args.batch_size,
                                  iou_types=("segm", "bbox"),
                                  box_metrics=True,
                                  score_thresh=args.score_thresh,
                                  iou_thresh=args.iou_thresh, device=dev)
        tm = aps.pop("box_metrics")
        for iou_type, ap in aps.items():
            tag = "mask" if iou_type == "segm" else "box"
            row.update({f"{tag}_AP": round(ap["AP"], 4),
                        f"{tag}_AP50": round(ap["AP50"], 4),
                        f"{tag}_AP75": round(ap["AP75"], 4)})
    row.update({"mean_iou": round(tm["mean_iou"], 4),
                "precision": round(tm["mean_precision"], 4),
                "recall": round(tm["mean_recall"], 4),
                "f1": round(tm["f1_score"], 4)})
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
