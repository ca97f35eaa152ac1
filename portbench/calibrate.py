"""The readings a cell's limits are set from (limits/<workload>.json):
over a dozen seeds or more, in one process on the card, each seed's
program (sound), the control (the reference in fp8 put in the program's
place) and the planted faults, each judged by the float32 reference as
a run judges the program: a training cell over the same first steps, a
serving cell over `check_frames` requests.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--what sound,control,half_batch]

Prints one JSON line a seed and reading: the compared numbers, each
step's loss gap, and the leaves that set the two leaf gaps. Faults:

  half_batch  the program's forward takes the first half of the batch
              only, its losses the mean over that half;
  half_tiles  a frame's forward over the first half of its tiles only;
  altered     every detection's box one pixel to the right where the
              model produces it;
  mask_roi_bin
              the mask branch's RoIAlign (K5 at 14x14) sampling each
              box one output bin (1/14 of its width) to the right;
  (a step that returns its state unchanged reads 1 by update_gap, whose
  changed norm is 0 against the reference's, and needs no run.)"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import spec as spec_mod  # noqa: E402
from portbench.drivers import train  # noqa: E402
from portbench.reference import lowp  # noqa: E402


def half_batch(model) -> None:
    forward = model.train_forward

    def half(images, targets, noise=None, generator=None, record=None):
        h = images.shape[0] // 2
        return forward(images[:h], {k: v[:h] for k, v in targets.items()},
                       generator=generator, record=record)

    model.train_forward = half


def altered(model) -> None:
    """Every detection's box one pixel to the right where the model
    produces it."""
    forward = model.inference_forward

    def shifted(images):
        det = forward(images)
        return det._replace(boxes=det.boxes + torch.tensor(
            [1.0, 0.0, 1.0, 0.0], device=det.boxes.device))

    model.inference_forward = shifted


def half_tiles(model) -> None:
    """The forward over the first half of the frame's tiles only."""
    forward = model.inference_forward
    model.inference_forward = lambda images: forward(
        images[:images.shape[0] // 2])


def mask_roi_bin(model) -> None:
    """The mask branch's RoIAlign samples each box one output bin to the
    right (the box branch's is left alone)."""
    ms_roi = model.ms_roi
    size = model.cfg.mask_roi_size

    def shifted(feats, boxes, out_size, *args, **kwargs):
        if out_size == size:
            dx = (boxes[..., 2] - boxes[..., 0]) / size
            boxes = boxes + torch.stack(
                [dx, torch.zeros_like(dx), dx, torch.zeros_like(dx)], -1)
        return ms_roi(feats, boxes, out_size, *args, **kwargs)

    model.ms_roi = shifted


FAULTS = {"half_batch": half_batch, "altered": altered,
          "half_tiles": half_tiles, "mask_roi_bin": mask_roi_bin}
SERVE_FAULTS = ("altered", "half_tiles", "mask_roi_bin")


def frame_seed(spec, seed: int, what, faults: bool) -> dict:
    from portbench.drivers import frame

    dev = torch.device("cuda")
    k = spec["traffic"]["check_frames"]

    def served(fault=None):
        s.captured = {}
        s.build(fault=fault)
        failed = s.warm_up()
        with s.observed():
            for i in range(k):
                try:
                    s.request(i, capture=True)
                except RuntimeError:
                    failed += 1
        s.free()
        caps = {i: c for i, c in s.captured.items() if "answer" in c}
        s.captured = caps
        out = frame.judge(s) if caps else dict.fromkeys(
            s.part.NUMBERS, float("inf"))
        return dict(out, failed=failed)

    s = frame.Serve(spec, seed, dev)
    lines = {}
    if "sound" in what:
        lines["sound"] = served()
    if "sound_f32" in what:
        # The look behind the limits: the program in float32 (TF32 off).
        s.spec = dict(spec, config=dict(spec["config"],
                                        compute_dtype="float32"))
        with lowp.exact():
            lines["sound_f32"] = served()
        s.spec = spec
    frames = sorted({c["frame"] for c in s.captured.values()})
    if "control" in what:
        lines["control"] = s.combine([s.control(f)
                                      for f in frames or range(k)])
    for f in what:
        if f in SERVE_FAULTS and faults:
            lines[f] = served(FAULTS[f])
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="sound,control,half_batch")
    p.add_argument("--fault_seeds", type=int, default=3,
                   help="the faults run on the first N seeds only")
    args = p.parse_args(argv)
    spec = spec_mod.load(args.workload)
    if spec["traffic"]["driver"] == "frame":
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            for k, v in frame_seed(spec, seed, args.what.split(","),
                                   i < args.fault_seeds).items():
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "reading": k, **v}), flush=True)
            print(f"seed {seed} {time.time() - t0:.1f} s", file=sys.stderr,
                  flush=True)
        return 0
    dev = torch.device("cuda")
    what = args.what.split(",")
    n = spec["traffic"]["check_steps"]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if "sound_f32" in what:
            # The look behind the limits: the program in float32 (TF32
            # off), judged as the sound program is.
            f32 = dict(spec, config=dict(spec["config"],
                                         compute_dtype="float32"))
            r = train.Run(f32, seed, dev)
            with lowp.exact():
                r.build()
                prog = r.check_steps(r.epoch()[:n])
            r.free()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": "sound_f32",
                              **r.judge(prog, details=True)}), flush=True)
        r = train.Run(spec, seed, dev)
        rows = r.epoch()[:n]
        lines = {}
        if "sound" in what:
            r.build()
            prog = r.check_steps(rows)
            r.free()
            lines["sound"] = r.judge(prog, details=True)
        else:
            r.plan(rows)
        if "control" in what:
            lines["control"] = r.control(details=True)
        for f in what:
            if f in FAULTS and i < args.fault_seeds:
                r.build(fault=FAULTS[f])
                prog = r.check_steps(rows)
                r.free()
                lines[f] = r.judge(prog, details=True)
        for k, v in lines.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": k, **v}), flush=True)
        print(f"seed {seed} {time.time() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
