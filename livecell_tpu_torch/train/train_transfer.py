"""Two-stage transfer fine-tuning of the R50-FPN Mask R-CNN on one card
or, under torchrun, on a data-parallel mesh of cards (counterpart of
livecell_tpu/train/train_transfer.py: FROZEN_STAGE1, stage_optimizer,
main).

Stage 1 trains the heads with the backbone, FPN and RPN frozen; stage 2
trains everything; both with SGD, momentum and weight decay, each stage
with a fresh optimizer.

    python -m livecell_tpu_torch.train.train_transfer \
        [--pretrained path/to/torchvision_maskrcnn.pth] \
        [--data_dir data_split]

Runs on the card; `main([...], device="cpu")` runs on the CPU. Without
--pretrained the weights come from the seed; --pretrained takes a local
torchvision maskrcnn_resnet50_fpn state dict (nothing is downloaded).
The final checkpoint records the transfer model's config, so it loads
and serves through serve/app.py. With more than one rank the mesh works
as in train/train_custom.py (rank 0 prints and saves). --mfu prints
each stage's analytic step FLOPs (utils/flops.py) and the step's MFU
against the card's dense bf16 peak (`mfu_report`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from livecell_tpu_torch.config import Config, ModelConfig, TransferConfig
from livecell_tpu_torch.data.dataset import get_datasets
from livecell_tpu_torch.data.device_data import (
    DeviceDataset, epoch_generator, epoch_indices, fetch_metrics,
    train_epoch)
from livecell_tpu_torch.data.multihost import ShardedLoader
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.torch_import import load_torchvision_weights
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.parallel.mesh import main_print, trainer_mesh
from livecell_tpu_torch.parallel.train_step import (
    make_eval_step, make_step_fn)
from livecell_tpu_torch.train import checkpoint
from livecell_tpu_torch.train.coco_eval import evaluate_coco_multi
from livecell_tpu_torch.train.metrics import evaluate
from livecell_tpu_torch.utils.flops import count_flops, mfu_report
from livecell_tpu_torch.utils.profiling import time_fn

FROZEN_STAGE1 = ("backbone", "fpn", "rpn")


class ClippedSGD(torch.optim.SGD):
    """torch.optim.SGD that first scales its own parameters' gradients as
    optax.clip_by_global_norm does: unchanged below `clip_norm`, else
    g / norm * clip_norm, the norm taken over this optimizer's
    parameters only."""

    def __init__(self, params, clip_norm: float, **kw):
        super().__init__(params, **kw)
        # In `defaults`, which an Optimizer keeps when it is copied or
        # pickled (its __getstate__); an attribute would be lost.
        self.defaults["clip_norm"] = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if grads:
            norm = torch.stack([(x * x).sum() for x in grads]).sum().sqrt()
            clip = self.defaults["clip_norm"]
            for x in grads:
                x.copy_(torch.where(norm < clip, x, x / norm * clip))
        return super().step(closure)


def stage_optimizer(model: nn.Module, lr: float, momentum: float,
                    weight_decay: float, freeze: bool,
                    clip_norm: float = 0.0) -> torch.optim.SGD:
    """SGD with momentum and weight decay over the model's parameters;
    with `freeze` (stage 1) the backbone, FPN and RPN are left out, so
    they get no update and no decay (optax.set_to_zero) though they
    still get gradients. torch's SGD (d = g + wd * p, buf = momentum *
    buf + d, p -= lr * buf) is optax's add_decayed_weights then
    sgd(momentum). With clip_norm > 0 the trainable gradients are first
    clipped to that global norm (not in the reference; for training from
    random weights)."""
    params = [p for name, p in model.named_parameters()
              if not (freeze and name.split(".")[0] in FROZEN_STAGE1)]
    kw = dict(lr=lr, momentum=momentum, weight_decay=weight_decay)
    if clip_norm > 0:
        return ClippedSGD(params, clip_norm, **kw)
    return torch.optim.SGD(params, **kw)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Two-stage Mask R-CNN transfer fine-tuning")
    parser.add_argument("--data_dir", type=str, default="data_split")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--stage1_epochs", type=int, default=3)
    parser.add_argument("--stage2_epochs", type=int, default=2)
    parser.add_argument("--stage1_lr", type=float, default=5e-3)
    parser.add_argument("--stage2_lr", type=float, default=1e-3)
    parser.add_argument("--pretrained", type=str, default=None,
                        help="local torchvision maskrcnn .pth state_dict")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--clip_grad_norm", type=float, default=0.0,
                        help="global grad-norm clip (0 = off, the "
                             "reference behavior). Strongly recommended "
                             "when training without --pretrained")
    parser.add_argument("--track_preds", action="store_true",
                        help="per-batch eval forward counting preds>0.5 "
                             "(host-batch path; the global batch's on a "
                             "mesh)")
    parser.add_argument("--device_data", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="hold the training split on the card and "
                             "gather batches there (auto: on)")
    parser.add_argument("--coco_ap", action="store_true",
                        help="COCO mask/box AP on the test split after "
                             "training (train/coco_eval.py)")
    parser.add_argument("--visualize_every", type=int, default=0,
                        help="save GT-vs-pred 3-panel PNGs every N epochs "
                             "(0 = off)")
    parser.add_argument("--visualize_samples", type=int, default=5)
    parser.add_argument("--eval_batch_size", type=int, default=0,
                        help="batch size for eval forwards (0 = "
                             "batch_size)")
    parser.add_argument("--frozen_bn", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="torchvision FrozenBatchNorm2d semantics, "
                             "recorded in the sidecar (the model's batch "
                             "norm uses its running statistics either "
                             "way). auto: on with --pretrained")
    parser.add_argument("--mfu", action="store_true",
                        help="print step TFLOPs + MFU per stage "
                             "(analytic count, utils/flops.py)")
    return parser


def main(argv=None, transfer_cfg=None, device=None):
    """Train from the flags in `argv`. Returns a dict: the trained
    "model", "history" (the validation metrics of every epoch),
    "stage_seconds" and "stage_img_per_s" (per stage, per epoch),
    "test_metrics", "test_ap" (with --coco_ap: "segm" and "bbox") and
    the checkpoint's "model_path"."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    mesh = trainer_mesh(args.batch_size, dev)
    main_rank = mesh is None or mesh.is_main
    print = main_print(mesh)
    if mesh is not None:
        dev = mesh.device
    cfg = Config()
    tcfg = transfer_cfg or TransferConfig()
    want_frozen = (args.frozen_bn == "on" or
                   (args.frozen_bn == "auto" and bool(args.pretrained)))
    if transfer_cfg is None and want_frozen != tcfg.frozen_bn:
        tcfg = dataclasses.replace(tcfg, frozen_bn=want_frozen)

    print("Two-stage transfer training (ResNet-50 FPN Mask R-CNN)")
    if args.pretrained:
        print(f"  Importing torchvision weights from {args.pretrained}")
    else:
        print("  WARNING: no --pretrained checkpoint; backbone is random "
              "init (no network access for torchvision downloads).")
        if args.clip_grad_norm == 0:
            print("  WARNING: the reference two-stage LRs assume a "
                  "pretrained backbone and DIVERGE from random init; "
                  "use --clip_grad_norm 10 --stage1_lr 1e-4 (or provide "
                  "--pretrained) for a stable from-scratch run.")

    # The splits are packed at the transfer model's input tile, with its
    # instance slots.
    dcfg = ModelConfig(max_instances=tcfg.max_instances,
                       mask_size=tcfg.mask_size,
                       image_height=tcfg.tile_height,
                       image_width=tcfg.tile_width)
    datasets = get_datasets(args.data_dir, dcfg, device=dev)
    train_ds = datasets["train"]
    val_ds = datasets.get("val")
    test_ds = datasets.get("test")

    model = create_transfer_model(
        tcfg, torch.Generator().manual_seed(args.seed), device=dev,
        train=True)
    if args.pretrained:
        load_torchvision_weights(model, torch.load(
            args.pretrained, map_location="cpu", weights_only=True))

    pool = None
    if args.device_data in ("on", "auto"):
        pool = DeviceDataset.from_packed(train_ds, device=dev)
        print(f"  Device-resident training data: "
              f"{pool.nbytes / 2**20:.0f} MB for {len(pool)} tiles")

    # The serving copy the evaluations run (create_transfer_model's eval
    # form), loaded with the trained weights before each use.
    eval_model = create_transfer_model(tcfg, device=dev)
    eval_step = make_eval_step(eval_model, device=dev, mesh=mesh)
    eval_bs = args.eval_batch_size or args.batch_size
    history: List[Dict] = []
    stage_seconds: Dict[int, List[float]] = {}
    stage_img_per_s: Dict[int, List[float]] = {}

    def sync_eval():
        eval_model.load_state_dict(model.state_dict())

    def visualize_epoch(stage: int, epoch: int):
        """3-panel GT-vs-prediction PNGs (serve/visualize.py:
        prediction_panels) of the first --visualize_samples tiles of the
        validation split (else the train split), to outputs/."""
        from livecell_tpu_torch.serve.visualize import prediction_panels

        sync_eval()
        ds = val_ds if val_ds is not None else train_ds
        done = 0
        for images, targets, _ in ds.batches(eval_bs, shuffle=False):
            det = eval_step(images)
            boxes, scores, valid = (t.float().cpu().numpy() if
                                    t.is_floating_point() else t.cpu().numpy()
                                    for t in (det.boxes, det.scores,
                                              det.valid))
            for i in range(images.shape[0]):
                if done >= args.visualize_samples or not main_rank:
                    return
                gtb = targets["boxes"][i][targets["valid"][i]]
                stats = prediction_panels(
                    images[i], gtb, boxes[i][valid[i]], scores[i][valid[i]],
                    f"outputs/transfer_s{stage}e{epoch}_"
                    f"sample{done + 1}.png")
                print(f"  viz sample {done + 1}: GT {stats['gt_instances']}"
                      f" pred {stats['pred_instances']} "
                      f"conf {stats['mean_confidence']:.3f} "
                      f"IoU {stats['mean_iou']:.3f}")
                done += 1
            if done >= args.visualize_samples:
                return

    def run_stage(stage: int, epochs: int, lr: float, freeze: bool):
        # A fresh optimizer for each stage: zero momentum buffers.
        opt = stage_optimizer(model, lr, cfg.transfer.momentum,
                              cfg.transfer.weight_decay, freeze,
                              args.clip_grad_norm)
        step = make_step_fn(model, opt, mesh)
        if args.mfu and main_rank:
            # One step of the stage's first batch on a copy of the model
            # and a fresh stage optimizer, so training does not move.
            copy = create_transfer_model(tcfg, device=dev, train=True)
            copy.load_state_dict(model.state_dict())
            copy_step = make_step_fn(copy, stage_optimizer(
                copy, lr, cfg.transfer.momentum, cfg.transfer.weight_decay,
                freeze, args.clip_grad_norm))
            images, targets, _ = next(train_ds.batches(
                args.batch_size, shuffle=False, drop_last=True))
            batch = (torch.from_numpy(images).to(dev),
                     {k: torch.from_numpy(v).to(dev)
                      for k, v in targets.items()})
            gen = torch.Generator(device=dev).manual_seed(0)
            flops = count_flops(copy_step, *batch, generator=gen)
            seconds = time_fn(copy_step, *batch, generator=gen)["median_s"]
            print(f"  analytic step FLOPs: {flops / 1e12:.3f} TFLOP "
                  f"({flops:.0f} FLOP)")
            print(f"  {mfu_report(flops, seconds, dev)}")
        print(f"\n=== Stage {stage}: lr={lr} freeze={freeze} "
              f"({epochs} epochs) ===")
        stage_seconds[stage], stage_img_per_s[stage] = [], []
        for epoch in range(1, epochs + 1):
            seed = args.seed + stage * 100 + epoch
            gen = epoch_generator(args.seed, stage * 100 + epoch, dev)
            t0 = time.time()
            pred_counts = []
            if pool is not None:
                m = train_epoch(model, opt, pool, epoch_indices(
                    len(pool), args.batch_size, True, seed), gen, mesh)
            else:
                rows = []
                if mesh is not None:
                    batches = ShardedLoader(train_ds, mesh, args.batch_size,
                                            shuffle=True, seed=seed).epoch(0)
                else:
                    batches = ((torch.from_numpy(images).to(dev),
                                {k: torch.from_numpy(v).to(dev)
                                 for k, v in targets.items()})
                               for images, targets, _ in train_ds.batches(
                                   args.batch_size, shuffle=True, seed=seed,
                                   drop_last=True))
                for images, targets in batches:
                    rows.append(step(images, targets, generator=gen))
                    if args.track_preds:
                        # On a mesh each rank holds its rows; the eval
                        # step takes the global batch and returns every
                        # rank the whole batch's detections.
                        sync_eval()
                        det = eval_step(images if mesh is None
                                        else mesh.data.gather(images))
                        pred_counts.append(float(
                            (det.valid & (det.scores > 0.5)).sum(1)
                            .float().mean()))
                m = fetch_metrics(rows)
            dt = time.time() - t0
            n = len(m["total_loss"])
            avg = {k: float(v.sum()) / max(n, 1) for k, v in m.items()}
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items()))
            stage_seconds[stage].append(dt)
            stage_img_per_s[stage].append(n * args.batch_size / dt)
            print(f"Stage {stage} epoch {epoch}: {dt:.1f}s "
                  f"({stage_img_per_s[stage][-1]:.1f} img/s) {msg}")
            if pred_counts:
                print(f"  preds>0.5 per image: {np.mean(pred_counts):.2f}")
            if val_ds is not None:
                sync_eval()
                vm = evaluate(eval_step, val_ds, eval_bs, device=dev)
                history.append(vm)
                print(f"  Val: IoU {vm['mean_iou']:.4f} | "
                      f"P {vm['mean_precision']:.4f} | "
                      f"R {vm['mean_recall']:.4f} | "
                      f"F1 {vm['f1_score']:.4f}")
            if args.visualize_every and epoch % args.visualize_every == 0:
                visualize_epoch(stage, epoch)

    run_stage(1, args.stage1_epochs, args.stage1_lr, freeze=True)
    run_stage(2, args.stage2_epochs, args.stage2_lr, freeze=False)

    path = "models/maskrcnn_resnet50_two_stage.ckpt"
    checkpoint.save(path, model, mesh=mesh)
    print(f"\nModel saved to {path}")

    out = dict(model=model, history=history, stage_seconds=stage_seconds,
               stage_img_per_s=stage_img_per_s, model_path=path)
    if test_ds is not None:
        sync_eval()
        tm = evaluate(eval_step, test_ds, eval_bs, device=dev)
        out["test_metrics"] = tm
        print(f"Test: IoU {tm['mean_iou']:.4f} | "
              f"P {tm['mean_precision']:.4f} | R {tm['mean_recall']:.4f} | "
              f"F1 {tm['f1_score']:.4f}")
        if args.coco_ap:
            aps = evaluate_coco_multi(eval_step, test_ds, eval_bs,
                                      iou_types=("segm", "bbox"), device=dev)
            out["test_ap"] = aps
            ap, bap = aps["segm"], aps["bbox"]
            print(f"Test Mask AP: {ap['AP']:.4f} (AP50 {ap['AP50']:.4f}, "
                  f"AP75 {ap['AP75']:.4f})")
            print(f"Test Box AP:  {bap['AP']:.4f} "
                  f"(AP50 {bap['AP50']:.4f}, AP75 {bap['AP75']:.4f})")
    return out


if __name__ == "__main__":
    main()
