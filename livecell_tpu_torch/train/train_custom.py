"""Train the custom Mask R-CNN on one card or, under torchrun, on a
data-parallel mesh of cards (counterpart of
livecell_tpu/train/train_custom.py, with its flags and defaults).

    python -m livecell_tpu_torch.train.train_custom \
        --batch_size 2 --lr 0.001 --num_epochs 5 [--use_wandb]
    torchrun --nproc_per_node N -m livecell_tpu_torch.train.train_custom \
        --batch_size 32 ...

Runs on the card; `main([...], device="cpu")` runs on the CPU. The
step is parallel/train_step.py's (forward, losses, backward, AdamW under
the per-epoch StepLR schedule); with --device_data on (or auto) the
split is held on the card and each epoch runs through
data/device_data.py:train_epoch, else host batches are prefetched and
sent one by one, in the same order. Each epoch's sampling uniforms come
from a generator seeded by (seed, epoch), so a resumed run draws what a
straight run draws. Checkpoints are train/checkpoint.py directories.

With more than one rank (parallel/mesh.py:trainer_mesh) each rank holds
the split, takes its rows of every global batch (the device pool's
slices, or data/multihost.py:ShardedLoader on the host path) and runs
the mesh step; every rank evaluates its rows of the evaluation batches;
rank 0 alone prints, saves the (gathered) checkpoints and logs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from livecell_tpu_torch.config import (
    JAX_ROUTES, Config, ModelConfig, add_dense_flags, add_train_shape_flags,
    apply_dense_flags, apply_train_shape_flags)
from livecell_tpu_torch.data.dataset import get_datasets, instance_slots
from livecell_tpu_torch.data.device_data import (
    DeviceDataset, epoch_generator, epoch_indices, fetch_metrics,
    train_epoch)
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.data.multihost import ShardedLoader
from livecell_tpu_torch.models.mask_rcnn import (
    count_parameters, create_model, create_train_model)
from livecell_tpu_torch.parallel.mesh import main_print, trainer_mesh
from livecell_tpu_torch.parallel.train_step import (
    build_optimizer, make_eval_step, make_step_fn, scheduled_lr)
from livecell_tpu_torch.train import checkpoint
from livecell_tpu_torch.train.coco_eval import evaluate_coco
from livecell_tpu_torch.train.metrics import evaluate
from livecell_tpu_torch.train.tracker import Tracker
from livecell_tpu_torch.utils.prefetch import prefetch
from livecell_tpu_torch.utils.profiling import enable_nan_debug


def device_memory_mb(device) -> float:
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / (1024 ** 2)


def save_training_plot(train_losses: List[float], val_metrics: List[Dict],
                       save_path: str):
    """3-panel loss / IoU / F1 plot. Needs matplotlib (imported here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    epochs = range(1, len(train_losses) + 1)
    panels = [
        (train_losses, "b-", "Train Loss", "Loss"),
        ([m["mean_iou"] for m in val_metrics], "g-", "Validation IoU", "IoU"),
        ([m["f1_score"] for m in val_metrics], "r-", "Validation F1 Score",
         "F1 Score"),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (ys, style, title, ylabel) in zip(axes, panels):
        ax.plot(epochs, ys, style)
        ax.set_xlabel("Epoch")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.grid(True)
    plt.tight_layout()
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Training plot saved to {save_path}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train Custom Mask R-CNN")
    parser.add_argument("--model", type=str, default="custom")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--num_epochs", type=int, default=5)
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str,
                        default="livecell-instance-segmentation")
    parser.add_argument("--data_dir", type=str, default="data_split")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval_batch_size", type=int, default=None)
    parser.add_argument("--coco_ap", action="store_true",
                        help="also compute COCO mask AP on the test split")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint directory to resume from")
    parser.add_argument("--device_data", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="hold the training split on the card and "
                             "gather batches there (auto: on)")
    parser.add_argument("--fixed_heads", action="store_true",
                        help="train box/mask heads + RPN on every image "
                             "(ModelConfig.heads_all_images)")
    parser.add_argument("--decode_proposals", action="store_true",
                        help="decode RPN/box-head deltas into real boxes "
                             "(ModelConfig.decode_proposals)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="autograd anomaly detection: fail at the "
                             "backward op that produced a NaN")
    parser.add_argument("--mask_samples", type=int, default=0,
                        help="fixed mode: run the mask head on the top-N "
                             "mask-fg proposals only (0 = all)")
    parser.add_argument("--roi_backend", type=str, default=None,
                        choices=["auto", "kernel", "plain", "einsum",
                                 "pallas"],
                        help="RoIAlign route (the JAX names load as auto)")
    parser.add_argument("--match_backend", type=str, default=None,
                        choices=["auto", "kernel", "plain", "xla", "pallas"],
                        help="anchor-matcher route (the JAX names load as "
                             "auto)")
    parser.add_argument("--frozen_bn", action="store_true",
                        help="backbone BN uses running statistics even "
                             "in train mode (ModelConfig.frozen_bn)")
    parser.add_argument("--topk_backend", type=str, default=None,
                        choices=["auto", "exact", "approx"],
                        help="training top-k (approx loads as exact)")
    add_dense_flags(parser)
    parser.add_argument("--lr_step_size", type=int, default=None,
                        help="decay LR by lr_gamma every N epochs "
                             "(default: the reference's StepLR(2, 0.1))")
    parser.add_argument("--save_every", type=int, default=0,
                        help="also checkpoint every N epochs (0 = only at "
                             "the end)")
    add_train_shape_flags(parser)
    return parser


def model_config(base: ModelConfig, args) -> ModelConfig:
    """The run's ModelConfig from the flags, as the JAX trainer builds
    it; JAX route names map onto the port's (config.JAX_ROUTES)."""
    def route(name):
        v = getattr(args, name)
        return JAX_ROUTES[name].get(v, v) if v else getattr(base, name)

    mcfg = dataclasses.replace(
        base, heads_all_images=args.fixed_heads or base.heads_all_images,
        decode_proposals=args.decode_proposals or base.decode_proposals,
        mask_train_samples=args.mask_samples or base.mask_train_samples,
        roi_backend=route("roi_backend"),
        match_backend=route("match_backend"),
        topk_backend=route("topk_backend"),
        frozen_bn=args.frozen_bn or base.frozen_bn)
    mcfg = apply_dense_flags(mcfg, args.dets, args.infer_nms, args.det_nms)
    return apply_train_shape_flags(mcfg, args)


def main(argv=None, config=None, device=None):
    """Train from the flags in `argv`. Returns a dict: the trained
    "model" and "optimizer", "train_losses", "val_metrics",
    "test_metrics", "test_ap" (with --coco_ap), "epoch_seconds",
    "img_per_s", "steps_per_epoch" and the final checkpoint's
    "model_path"."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    mesh = trainer_mesh(args.batch_size, dev)
    main_rank = mesh is None or mesh.is_main
    print = main_print(mesh)
    if mesh is not None:
        dev = mesh.device
    if args.debug_nans:
        enable_nan_debug(True)
    cfg = config or Config()
    mcfg = model_config(cfg.model, args)

    print(f"Training {args.model.upper()} Model")
    print("\nConfiguration:")
    print(f"  Device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    print(f"  Batch size: {args.batch_size}")
    print(f"  Learning rate: {args.lr}")
    print(f"  Epochs: {args.num_epochs}")
    print(f"  W&B logging: {args.use_wandb}")
    if mesh is not None:
        print(f"  Mesh: data {mesh.data_size} x model {mesh.model_size}")

    tracker = Tracker(
        args.use_wandb and main_rank, args.wandb_project,
        name=f"{args.model}_lr{args.lr}_bs{args.batch_size}"
             f"_ep{args.num_epochs}",
        config={
            "model_type": args.model,
            "architecture": "Custom MaskRCNN with CBAM",
            "backbone": "ResNet-18",
            "learning_rate": args.lr, "batch_size": args.batch_size,
            "epochs": args.num_epochs, "optimizer": "AdamW",
            "weight_decay": cfg.train.weight_decay, "scheduler": "StepLR",
            "dataset": "LIVECell",
        })

    print("\nLoading datasets...")
    datasets = get_datasets(args.data_dir, mcfg, device=dev)
    train_ds = datasets["train"]
    val_ds = datasets.get("val")
    test_ds = datasets.get("test")

    # Size the static instance slots to the data (a multiple of 32 in
    # [32, 512]): the model, the pool and every dataset's batches are
    # built with the sized config.
    observed = max((int(ds.instance_counts().max())
                    for ds in datasets.values() if len(ds)), default=0)
    auto_i = instance_slots(observed)
    if observed and auto_i != mcfg.max_instances:
        print(f"  Instance slots: {mcfg.max_instances} -> {auto_i} "
              f"(split max {observed} instances/tile)")
        mcfg = dataclasses.replace(mcfg, max_instances=auto_i)
        for ds in datasets.values():
            ds.cfg = mcfg

    steps_per_epoch = len(train_ds) // args.batch_size
    if steps_per_epoch == 0:
        raise ValueError("batch_size larger than the training split")

    print("\nCreating model...")
    model = create_train_model(
        mcfg, torch.Generator().manual_seed(args.seed), device=dev)
    param_info = count_parameters(model)
    print(f"  Total parameters: {param_info['total']:,}")
    print(f"  Backbone (ResNet-18): {param_info['backbone']:,}")
    print(f"  Custom: {param_info['custom']:,} "
          f"({param_info['custom_percentage']:.1f}%)")
    print(f"  Memory size: {param_info['memory_mb']:.2f} MB")
    tracker.update_config({
        "total_params": param_info["total"],
        "custom_params": param_info["custom"],
        "cbam_params": param_info["cbam"],
        "custom_percentage": param_info["custom_percentage"],
        "model_memory_mb": param_info["memory_mb"],
    })

    opt = build_optimizer(
        model, args.lr, cfg.train.weight_decay, steps_per_epoch,
        args.lr_step_size or cfg.train.lr_step_size, cfg.train.lr_gamma)

    start_epoch = 1
    if args.resume:
        # The weights, the moments and the step count come from the
        # checkpoint, the schedule from the flags.
        _, _, meta = checkpoint.restore(args.resume, dev, model, opt)
        start_epoch = int(meta.get("epoch", 0)) + 1
        print(f"Resumed from {args.resume} at epoch {start_epoch}")

    pool = None
    if args.device_data in ("on", "auto"):
        pool = DeviceDataset.from_packed(train_ds, device=dev)
        print(f"  Device-resident training data: "
              f"{pool.nbytes / 2**20:.0f} MB for {len(pool)} tiles")
    step = make_step_fn(model, opt, mesh)
    # The serving copy the evaluations run: the trained weights cast to
    # the compute dtype, batch norm on its running statistics.
    eval_model = create_model(mcfg, device=dev)
    eval_step = make_eval_step(eval_model, device=dev, mesh=mesh)
    eval_bs = args.eval_batch_size or args.batch_size

    def evaluate_split(ds):
        eval_model.load_state_dict(model.state_dict())
        return evaluate(eval_step, ds, eval_bs, cfg.train.eval_score_thresh,
                        cfg.train.eval_iou_thresh, device=dev)

    train_losses: List[float] = []
    val_history: List[Dict] = []
    epoch_seconds: List[float] = []
    img_per_s: List[float] = []

    for epoch in range(start_epoch, args.num_epochs + 1):
        gen = epoch_generator(args.seed, epoch, dev)
        t_epoch = time.time()
        mems = []
        if pool is not None:
            idx_mat = epoch_indices(len(pool), args.batch_size, True,
                                    args.seed + epoch)
            m = train_epoch(model, opt, pool, idx_mat, gen, mesh)
            mems.append(device_memory_mb(dev))
        else:
            rows = []
            if mesh is not None:
                batches = ShardedLoader(train_ds, mesh, args.batch_size,
                                        shuffle=True, seed=args.seed
                                        ).epoch(epoch)
            else:
                batches = ((torch.from_numpy(images).to(dev),
                            {k: torch.from_numpy(v).to(dev)
                             for k, v in targets.items()})
                           for images, targets, _ in prefetch(
                               train_ds.batches(
                                   args.batch_size, shuffle=True,
                                   seed=args.seed + epoch, drop_last=True)))
            for images, targets in batches:
                rows.append(step(images, targets, generator=gen))
                mems.append(device_memory_mb(dev))
            m = fetch_metrics(rows)
        epoch_time = time.time() - t_epoch
        n_steps = len(m["total_loss"])
        gnorms = m.pop("grad_norm")
        avg = {k: float(np.mean(v)) for k, v in m.items()}
        lr_now = scheduled_lr(dict(opt.param_groups[0], schedule_step=(
            epoch - 1) * steps_per_epoch))
        epoch_seconds.append(epoch_time)
        img_per_s.append(n_steps * args.batch_size / epoch_time)
        print(f"\nEpoch {epoch} Training ({epoch_time:.1f}s, "
              f"{img_per_s[-1]:.1f} img/s):")
        print(f"  Loss: {avg['total_loss']:.4f}")
        print(f"    RPN Cls:  {avg['loss_rpn_cls']:.4f}")
        print(f"    Box Cls:  {avg['loss_box_cls']:.4f}")
        print(f"    Box Reg:  {avg['loss_box_reg']:.4f}")
        print(f"    Mask:     {avg['loss_mask']:.4f}")
        print(f"  Gradient Norm: {np.mean(gnorms):.4f} "
              f"(min {np.min(gnorms):.4f}, max {np.max(gnorms):.4f})")
        print(f"  Learning Rate: {lr_now:.6f}")
        print(f"  Device Memory: {np.mean(mems):.1f} MB "
              f"(max {np.max(mems):.1f} MB)")

        train_losses.append(avg["total_loss"])
        tracker.log({
            "epoch": epoch,
            "train/total_loss": avg["total_loss"],
            "train/rpn_cls_loss": avg["loss_rpn_cls"],
            "train/box_cls_loss": avg["loss_box_cls"],
            "train/box_reg_loss": avg["loss_box_reg"],
            "train/mask_loss": avg["loss_mask"],
            "dynamics/gradient_norm_mean": float(np.mean(gnorms)),
            "dynamics/gradient_norm_max": float(np.max(gnorms)),
            "dynamics/learning_rate": lr_now,
            "dynamics/memory_usage_mb": float(np.mean(mems)),
            "dynamics/epoch_time_seconds": epoch_time,
        })

        if val_ds is not None:
            vm = evaluate_split(val_ds)
            val_history.append(vm)
            print(f"  Validation: IoU {vm['mean_iou']:.4f} | "
                  f"P {vm['mean_precision']:.4f} | R {vm['mean_recall']:.4f}"
                  f" | F1 {vm['f1_score']:.4f}")
            tracker.log({
                "epoch": epoch,
                "val/mean_iou": vm["mean_iou"],
                "val/precision": vm["mean_precision"],
                "val/recall": vm["mean_recall"],
                "val/f1_score": vm["f1_score"],
            })

        if args.save_every and epoch % args.save_every == 0 and \
                epoch < args.num_epochs:
            checkpoint.save(
                f"models/{args.model}_maskrcnn_epoch{epoch}.ckpt", model,
                opt, epoch=epoch, train_losses=train_losses,
                val_metrics=val_history, param_info=param_info, mesh=mesh)

    model_path = f"models/{args.model}_maskrcnn_{args.num_epochs}epochs.ckpt"
    checkpoint.save(model_path, model, opt, epoch=args.num_epochs,
                    train_losses=train_losses, val_metrics=val_history,
                    param_info=param_info, mesh=mesh)
    print(f"\nModel saved to {model_path}")

    if val_history and main_rank:
        plot_path = f"outputs/{args.model}_training_plot.png"
        try:
            save_training_plot(train_losses, val_history, plot_path)
            tracker.log_image("training_plot", plot_path)
        except ImportError as e:
            print(f"Training plot skipped: {e}")

    out = dict(model=model, optimizer=opt, train_losses=train_losses,
               val_metrics=val_history, epoch_seconds=epoch_seconds,
               img_per_s=img_per_s, steps_per_epoch=steps_per_epoch,
               model_path=model_path)
    if test_ds is not None:
        print("\nTesting...")
        tm = evaluate_split(test_ds)
        out["test_metrics"] = tm
        print(f"  Test: IoU {tm['mean_iou']:.4f} | "
              f"P {tm['mean_precision']:.4f} | R {tm['mean_recall']:.4f} | "
              f"F1 {tm['f1_score']:.4f}")
        tracker.log({
            "test/mean_iou": tm["mean_iou"],
            "test/precision": tm["mean_precision"],
            "test/recall": tm["mean_recall"],
            "test/f1_score": tm["f1_score"],
        })
        if args.coco_ap:
            ap = evaluate_coco(eval_step, test_ds, eval_bs, iou_type="segm",
                               device=dev)
            out["test_ap"] = ap
            print(f"  Mask AP: {ap['AP']:.4f} (AP50 {ap['AP50']:.4f}, "
                  f"AP75 {ap['AP75']:.4f})")
            tracker.log({f"test/mask_{k}": v for k, v in ap.items()})

    tracker.finish()
    return out


if __name__ == "__main__":
    main()
