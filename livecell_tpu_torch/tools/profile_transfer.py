"""Profile the transfer model's training step on the H100 (counterpart of
scripts/profile_transfer.py): the R50-FPN Mask R-CNN on the 800x1088
canvas, a torch.profiler trace of 3 steps, the step time and the MFU
from the analytic FLOP count.

    python -m livecell_tpu_torch.tools.profile_transfer [--bs 4] \\
        [--steps 10] [--trace outputs/xprof_transfer] [--scan]

The workload is tools/roofline.py:build_transfer_step (random weights
from seed 0, SGD 5e-3, momentum 0.9, clip 10, as bench.py's transfer
step; the inputs are JAX's numpy draws). --roi_backend takes the port's
routes ("auto", "kernel", "plain"); JAX's "pallas" and "xla" are refused,
as TransferConfig refuses them. --scan times the port's one-dispatch
shape: all steps queued with no host read until the last loss, as the
trainer's --device_data on runs an epoch (JAX: one lax.scan dispatch);
without it each step's loss is read back before the next (JAX: a
dispatch and a fetch a step). A non-finite loss fails the run.

Prints JAX's keys (step_ms, img_per_sec, analytic_flops_per_step, mfu,
trace_dir) and "card". The MFU is taken against 989.4 TFLOP/s (H100 SXM
dense bf16) in place of JAX's 197 TFLOP/s (v5e), and left out where the
card has no known peak (JAX leaves it out where the count failed). Runs
on the card; `main([...], device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.tools.roofline import build_transfer_step
from livecell_tpu_torch.tools.steps import copied_stepper, stepper
from livecell_tpu_torch.utils.flops import card_of, count_flops, peak_flops
from livecell_tpu_torch.utils.profiling import sync, trace

TRACE_STEPS = 3


def main(argv=None, device=None) -> Dict:
    """Returns the printed record."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bs", type=int, default=4)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--trace", type=str, default="outputs/xprof_transfer")
    parser.add_argument("--roi_backend", default="auto")
    parser.add_argument("--frozen_bn", action="store_true",
                        help="torchvision FrozenBatchNorm2d semantics (the "
                             "port's transfer model always has them)")
    parser.add_argument("--scan", action="store_true",
                        help="queue all timed steps, one host read at the "
                             "end (the --device_data production shape)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    parts = build_transfer_step(args.bs, dev, args.roi_backend,
                                args.frozen_bn)
    run = stepper(*parts)
    float(run()["total_loss"])            # first call + drain
    t0 = time.perf_counter()
    if args.scan:
        for _ in range(args.steps):
            metrics = run()
        final = float(metrics["total_loss"])
    else:
        for _ in range(args.steps):
            final = float(run()["total_loss"])
    dt = (time.perf_counter() - t0) / args.steps
    if not math.isfinite(final):
        raise AssertionError(f"non-finite loss {final}")

    flops = count_flops(copied_stepper(*parts))
    if args.trace:
        with trace(args.trace, with_stack=True):
            for _ in range(TRACE_STEPS):
                run()
        sync(dev)
        print(f"torch.profiler trace written to {args.trace}")

    rec = {"step_ms": round(dt * 1e3, 2),
           "img_per_sec": round(args.bs / dt, 1)}
    peak = peak_flops(dev)
    if flops:
        rec["analytic_flops_per_step"] = flops
        if peak:
            rec["mfu"] = round(flops / dt / peak, 4)
    rec["trace_dir"] = args.trace
    rec["card"] = card_of(dev)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
