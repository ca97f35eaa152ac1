"""Dense-scene anchor and budget sweep (counterpart of
scripts/dense_sweep.py).

The flagship recipe collapses on LIVECell-statistics scenes (~59
instances a tile): the reference's 32/64/128 anchors rarely cross the
0.5 IoU gate on ~20 px cells, and its training budgets starve the
positives. Each (recipe, seed) trains the flagship configuration with
the recipe's anchor and budget flags in its own working directory
(checkpoints are written relative to it), then tools/eval_ckpt.py
scores the checkpoint under both inference caps; the anchor geometry
rides the checkpoint's sidecar, so evaluation rebuilds the same model.

    python -m livecell_tpu_torch.tools.dense_sweep --split /tmp/lc \\
        --name lc --seeds 0 1 2 [--recipes a12 a4x]

Writes outputs/dense_sweep_<name>.jsonl and prints a markdown table of
the mean and half-spread over seeds. The children run on the card; a
failed child stops the sweep with a non-zero exit after its output's
tail.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.tools.quality_matrix import (
    LIFTED_CAPS, REPO, eval_cmd, eval_row, run_child, train_cmd)

# The training budget for dense scenes: the training proposals lifted
# from 500 to 1024 before sampling, 128 -> 256 sampled ROIs, the RPN
# minibatch 256 -> 512 with up to 256 positives (the reference's
# 128/256 starve the positives at ~59 GT a tile).
DENSE_BUDGET = ["--train_topk", "1024", "--train_samples", "256",
                "--rpn_batch", "512", "--rpn_pos", "256"]

RECIPES = {
    # The reference's anchors and budgets.
    "base": [],
    # The reference's anchors with the dense budget.
    "budget": DENSE_BUDGET,
    # Small anchors, 3 sizes (cells of ~14-28 px).
    "a12": ["--anchor_sizes", "12,24,48"] + DENSE_BUDGET,
    # Smaller still.
    "a8": ["--anchor_sizes", "8,16,32"] + DENSE_BUDGET,
    # A 4-size pyramid covering 8-64 px: 12 anchors a location.
    "a4x": ["--anchor_sizes", "8,16,32,64"] + DENSE_BUDGET,
}

CAPS = {"reference": [], "lifted": LIFTED_CAPS}


def main(argv=None, device=None, runner=subprocess.run):
    """`runner` runs each child (subprocess.run's signature). Returns
    the rows."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--split", required=True,
                   help="root containing split/ (tools/synth_splits.py)")
    p.add_argument("--name", default="lc")
    p.add_argument("--recipes", nargs="+", default=list(RECIPES))
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--workroot", default=str(REPO / "outputs" / "sweep"))
    p.add_argument("--out", default=None)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--eval_dets", type=int, default=256,
                   help="lifted-caps detection budget")
    args = p.parse_args(argv)
    resolve_device(device)

    # Absolute: the children run from their working directories.
    split_dir = Path(os.path.abspath(args.split)) / "split"
    workroot = Path(os.path.abspath(args.workroot))
    if not (split_dir / "train").exists():
        raise SystemExit(f"no split at {split_dir}")
    out_path = args.out or str(
        REPO / "outputs" / f"dense_sweep_{args.name}.jsonl")

    caps = dict(CAPS)
    caps["lifted"] = ["--dets", str(args.eval_dets),
                      "--infer_nms", "0.7", "--det_nms", "0.6"]

    rows = []
    for recipe in args.recipes:
        for seed in args.seeds:
            wd = workroot / args.name / f"{recipe}_s{seed}"
            wd.mkdir(parents=True, exist_ok=True)
            ckpt = wd / "models" / \
                f"custom_maskrcnn_{args.epochs}epochs.ckpt"
            if not args.skip_train or not ckpt.exists():
                t0 = time.time()
                run_child(runner, train_cmd(
                    args.batch_size, args.epochs, str(split_dir), seed)
                    + RECIPES[recipe], wd, f"train {recipe} s{seed}", 3000)
                print(f"[{recipe} s{seed}] trained in "
                      f"{time.time() - t0:.0f}s", flush=True)

            for cap_name, cap_extra in caps.items():
                rec = eval_row(runner, eval_cmd(ckpt, str(split_dir),
                                                cap_extra), wd,
                               f"eval {recipe} s{seed} {cap_name}", 3000)
                rec.update({"recipe": recipe, "seed": seed,
                            "caps": cap_name, "split": args.name})
                rows.append(rec)
                print(f"[{recipe} s{seed}/{cap_name}] "
                      f"maskAP {rec.get('mask_AP', float('nan')):.3f} "
                      f"AP50 {rec.get('mask_AP50', float('nan')):.3f} "
                      f"AP75 {rec.get('mask_AP75', float('nan')):.3f} "
                      f"F1 {rec.get('f1', float('nan')):.3f}", flush=True)
                Path(out_path).parent.mkdir(parents=True, exist_ok=True)
                with open(out_path, "w") as f:
                    for row in rows:
                        f.write(json.dumps(row) + "\n")

    # The mean and half-spread over seeds of each (recipe, caps).
    print(f"\n### {args.name} sweep ({len(args.seeds)} seeds)")
    print("| recipe | caps | mask AP | AP50 | AP75 | box AP | F1 |")
    print("|---|---|---|---|---|---|---|")
    for recipe in args.recipes:
        for cap_name in caps:
            sel = [r for r in rows
                   if r["recipe"] == recipe and r["caps"] == cap_name]
            if not sel:
                continue

            def ms(key):
                vs = [r.get(key, float("nan")) for r in sel]
                m = statistics.fmean(vs)
                s = (max(vs) - min(vs)) / 2 if len(vs) > 1 else 0.0
                return f"{m:.3f}±{s:.3f}"

            print(f"| {recipe} | {cap_name} | {ms('mask_AP')} "
                  f"| {ms('mask_AP50')} | {ms('mask_AP75')} "
                  f"| {ms('box_AP')} | {ms('f1')} |")
    return rows


if __name__ == "__main__":
    main()
