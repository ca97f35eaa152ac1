"""Profile the custom model's training step on the H100 (counterpart of
scripts/profile_step.py): a torch.profiler trace of 3 steps and the
step's MFU from the analytic FLOP count (utils/flops.py).

    python -m livecell_tpu_torch.tools.profile_step [--bs 32] [--fixed] \\
        [--mask_samples N] [--frozen_bn] [--trace outputs/xprof]

The step is parallel/train_step.py:make_step_fn over the full-width
ModelConfig of the flags, f32 masters with bf16 compute, AdamW 1e-3 /
wd 1e-4 (build_optimizer); the inputs are JAX's numpy draws
(default_rng(0): uint8 noise images, 40 boxes of 20-55 px, mask28
noise). The steps are timed by utils/profiling.time_fn (each ended by a
synchronize); the trace (written with Python frames, `with_stack`)
goes to --trace, for tools/trace_summary.py. The FLOP count executes a
step, so it runs on a copy of the model and optimizer.

Prints JAX's keys (step_ms, img_per_sec, analytic_flops_per_step, mfu,
trace_dir) and "card", the card's name and power limit. The MFU is taken
against utils/flops.py:peak_flops (989.4 TFLOP/s, H100 SXM dense bf16)
in place of JAX's 197 TFLOP/s (v5e); it is null on another card and on
the CPU. Runs on the card; `main([...], device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.mask_rcnn import create_train_model
from livecell_tpu_torch.parallel.train_step import build_optimizer
from livecell_tpu_torch.tools.steps import (
    CONSTANT_LR_EPOCH, N_INST, copied_stepper, stepper, to_device)
from livecell_tpu_torch.utils.flops import card_of, count_flops, peak_flops
from livecell_tpu_torch.utils.profiling import time_fn, trace

TRACE_STEPS = 3


def draw_inputs(cfg, b: int):
    """JAX's draws: the images, then the boxes of all images at once."""
    rng = np.random.default_rng(0)
    h, w, i = cfg.image_height, cfg.image_width, cfg.max_instances
    images = (rng.uniform(size=(b, h, w, 3)) * 255).astype(np.uint8)
    boxes = np.zeros((b, i, 4), np.float32)
    n = (b, N_INST)
    boxes[:, :N_INST] = np.stack([
        rng.uniform(0, w - 60, n), rng.uniform(0, h - 60, n),
        rng.uniform(20, 55, n), rng.uniform(20, 55, n)], axis=2)
    boxes[:, :N_INST, 2:] += boxes[:, :N_INST, :2]
    valid = np.zeros((b, i), bool)
    valid[:, :N_INST] = True
    return images, {"boxes": boxes, "labels": valid.astype(np.int32),
                    "mask28": (rng.uniform(size=(b, i, 28, 28)) > .5
                               ).astype(np.uint8) * 255,
                    "valid": valid}


def main(argv=None, device=None) -> Dict:
    """Returns the printed record."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--trace", type=str, default="outputs/xprof")
    parser.add_argument("--fixed", action="store_true",
                        help="profile the fixed+decode quality mode")
    parser.add_argument("--mask_samples", type=int, default=0)
    parser.add_argument("--frozen_bn", action="store_true",
                        help="backbone BN uses running stats in train "
                             "mode (skips batch-stat reductions)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    cfg = ModelConfig(heads_all_images=args.fixed,
                      decode_proposals=args.fixed,
                      mask_train_samples=args.mask_samples,
                      frozen_bn=args.frozen_bn)
    model = create_train_model(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    opt = build_optimizer(model, 1e-3, 1e-4, CONSTANT_LR_EPOCH)
    images, targets = to_device(*draw_inputs(cfg, args.bs), dev)
    run = stepper(model, opt, images, targets)

    step_ms = time_fn(run, warmup=1, iters=args.steps)["median_s"] * 1e3
    with trace(args.trace, with_stack=True):
        for _ in range(TRACE_STEPS):
            run()
    print(f"torch.profiler trace written to {args.trace}", file=sys.stderr)

    flops = count_flops(copied_stepper(model, opt, images, targets))
    peak = peak_flops(dev)
    mfu = flops / (step_ms / 1000) / peak if peak else None
    rec = {"step_ms": round(step_ms, 2),
           "img_per_sec": round(args.bs / (step_ms / 1000), 1),
           "analytic_flops_per_step": flops,
           "mfu": round(mfu, 4) if mfu else None,
           "trace_dir": args.trace,
           "card": card_of(dev)}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
