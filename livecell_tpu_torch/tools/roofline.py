"""Bytes-and-FLOPs roofline of a training step on the H100 (counterpart
of scripts/roofline.py).

For the flagship `--fixed_heads --decode_proposals --mask_samples 64`
step (or the quirk mode's, or the transfer model's) this prints

  - the analytic tensor-core FLOPs (utils/flops.py:count_flops, the
    numerator MFU uses),
  - the bytes the step moves (utils/flops.py:count_bytes: each aten op's
    inputs and outputs, each kernel's inputs and outputs once),
  - the two roofline times t_tensor = F / 989.4 TFLOP/s and t_hbm =
    B / 3.35 TB/s (H100 SXM, dense bf16 and HBM3 data-sheet rates),
    whose max is the floor of a perfectly scheduled card,
  - with --measure, the measured time per dispatch beside it.

    python -m livecell_tpu_torch.tools.roofline --batch_size 32 --measure

The record's keys under their H100 names, against JAX's:
  analytic_tensor_tflops <- analytic_mxu_tflops (the same FLOP rules);
  hbm_gbytes <- xla_hbm_gbytes (eager ops' traffic for XLA's post-fusion
    bytes accessed);
  t_tensor_ms <- t_mxu_ms; t_hbm_ms; roofline_floor_ms;
  bound: "tensor" or "hbm" <- "mxu" or "hbm";
  measured_ms_per_dispatch, img_per_sec_per_dispatch, floor_fraction;
  card: the card's name and power limit (nvidia-smi), "the CPU" there.
xla_total_tflops, t_mxu_xla_ms and xla_transcendentals_g have no
counterpart without XLA's cost analysis and are not printed. The floor
is the H100's for this work on any device; only the measured keys come
from the device the step ran on. --stem_s2d is accepted and the record
says "stem_s2d_ignored": the port computes the plain stem (config.py).

build_step and build_transfer_step are JAX's workload shapes: random
weights from seed 0, uint8 noise images and 40 boxes a tile drawn with
numpy (default_rng(0)) in JAX's order. Runs on the card;
`main([...], device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Dict

import numpy as np
import torch

from livecell_tpu_torch.config import ModelConfig, TransferConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.mask_rcnn import create_train_model
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.parallel.train_step import build_optimizer
from livecell_tpu_torch.tools.steps import (
    CONSTANT_LR_EPOCH, N_INST, copied_stepper, stepper, to_device)
from livecell_tpu_torch.train.train_transfer import stage_optimizer
from livecell_tpu_torch.utils.flops import (
    H100_BF16_PEAK, H100_HBM_BYTES_PER_S, card_of, count_bytes, count_flops)
from livecell_tpu_torch.utils.profiling import sync

def loop_targets(rng: np.random.Generator, b: int, h: int, w: int,
                 slots: int, min_side: float) -> Dict[str, np.ndarray]:
    """JAX's per-image draw: N_INST boxes of min_side-55 px in `slots`,
    then the mask28 noise."""
    boxes = np.zeros((b, slots, 4), np.float32)
    for bi in range(b):
        x1 = rng.uniform(0, w - 60, N_INST)
        y1 = rng.uniform(0, h - 60, N_INST)
        bw = rng.uniform(min_side, 55, N_INST)
        bh = rng.uniform(min_side, 55, N_INST)
        boxes[bi, :N_INST] = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
    valid = np.zeros((b, slots), bool)
    valid[:, :N_INST] = True
    return {"boxes": boxes, "labels": valid.astype(np.int32),
            "mask28": (rng.uniform(size=(b, slots, 28, 28)) > 0.5
                       ).astype(np.uint8) * 255,
            "valid": valid}


def build_step(cfg: ModelConfig, batch_size: int, device):
    """(model, AdamW 1e-3 / wd 1e-4, images, targets) of the custom
    model's step at `cfg`, on `device`."""
    model = create_train_model(cfg, torch.Generator().manual_seed(0),
                               device=device)
    opt = build_optimizer(model, 1e-3, 1e-4, CONSTANT_LR_EPOCH)
    rng = np.random.default_rng(0)
    b, h, w = batch_size, cfg.image_height, cfg.image_width
    images = (rng.uniform(size=(b, h, w, 3)) * 255).astype(np.uint8)
    targets = loop_targets(rng, b, h, w, cfg.max_instances, 20)
    return (model, opt) + to_device(images, targets, model_device(model))


def build_transfer_step(batch_size: int, device, roi_backend: str = "auto",
                        frozen_bn: bool = False):
    """(model, SGD 5e-3 / momentum 0.9 / clip 10, images, targets) of the
    transfer model's step on the 800x1088 canvas (profile_transfer's
    workload shape), on `device`."""
    c = TransferConfig(roi_backend=roi_backend, frozen_bn=frozen_bn)
    model = create_transfer_model(c, torch.Generator().manual_seed(0),
                                  device=device, train=True)
    # From random weights the transfer step needs the clip to stay
    # finite, as the trainer's --clip_grad_norm.
    opt = stage_optimizer(model, 5e-3, 0.9, 0.0, False, clip_norm=10.0)
    rng = np.random.default_rng(0)
    b, th, tw = batch_size, c.tile_height, c.tile_width
    images = (rng.uniform(size=(b, th, tw, 3)) * 255).astype(np.uint8)
    targets = loop_targets(rng, b, th, tw, c.max_instances, 12)
    return (model, opt) + to_device(images, targets, model_device(model))


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def measure(run: Callable[[], Dict], steps: int, dev) -> float:
    """Seconds per dispatch: 3 warm-up steps, then `steps` queued back to
    back with one host read of the last loss, as JAX's loop."""
    for _ in range(3):
        metrics = run()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = run()
    final = float(metrics["total_loss"])
    dt = (time.perf_counter() - t0) / steps
    if not math.isfinite(final):
        raise AssertionError(f"non-finite loss {final}")
    return dt


def main(argv=None, device=None) -> Dict:
    """Returns the printed record."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--quirk", action="store_true",
                        help="reference-quirk mode instead of fixed mode")
    parser.add_argument("--transfer", action="store_true",
                        help="the transfer (R50-FPN, 800x1088) step "
                             "instead of the custom model")
    parser.add_argument("--measure", action="store_true",
                        help="also time the per-dispatch step")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--stem_s2d", action="store_true",
                        help="accepted; the port computes the plain stem")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    if args.transfer:
        parts = build_transfer_step(args.batch_size, dev)
    else:
        cfg = ModelConfig() if args.quirk else ModelConfig(
            heads_all_images=True, decode_proposals=True,
            mask_train_samples=64)
        parts = build_step(cfg, args.batch_size, dev)
    run = copied_stepper(*parts)
    flops, nbytes = count_flops(run), count_bytes(run)
    t_tensor_ms = flops / H100_BF16_PEAK * 1e3
    t_hbm_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    rec = {
        "mode": ("transfer" if args.transfer
                 else "quirk" if args.quirk else "fixed"),
        "batch_size": args.batch_size,
        "analytic_tensor_tflops": round(flops / 1e12, 4),
        "hbm_gbytes": round(nbytes / 1e9, 4),
        "t_tensor_ms": round(t_tensor_ms, 3),
        "t_hbm_ms": round(t_hbm_ms, 3),
        "roofline_floor_ms": round(max(t_tensor_ms, t_hbm_ms), 3),
        "bound": "tensor" if t_tensor_ms >= t_hbm_ms else "hbm",
        "card": card_of(dev),
    }
    if args.stem_s2d:
        rec["stem_s2d_ignored"] = True
    if args.measure:
        dt = measure(stepper(*parts), args.steps, dev)
        rec["measured_ms_per_dispatch"] = round(dt * 1e3, 3)
        rec["img_per_sec_per_dispatch"] = round(args.batch_size / dt, 1)
        rec["floor_fraction"] = round(
            rec["roofline_floor_ms"] / (dt * 1e3), 4)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
