#!/usr/bin/env python3
"""Time the custom model's training step of several checkouts of the port
on one GPU, in turns (A, B, B, A, ...), each run in a process of its own.

    python3 train_step_ab.py --trees ab/parent,. [--rounds 2]

Each run imports the tree's own `chip_smoke.py` and runs its phase-6
training (`make_pool`, `phase_train`: full-width ModelConfig(), bf16
compute, batch 32 from a pool of 128 synthetic tiles, 3 warm-up and 10
timed steps through `train_epoch`) for T1 (quirk mode) and T2 (the
flagship fixed mode), with a profiled step each. Prints one JSON line a
run (tree, step ms, img/s, the profiled step's wall and busy ms and
launches) with the card's name and power limit, and as the last line the
medians per tree and configuration. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import dataclasses, json, sys
import torch
import chip_smoke as cs
from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
cfg = ModelConfig()
pool = cs.make_pool(cfg, cs.POOL_TILES, "cuda", cs.SEED)
out = {}
for label, kw in cs.TRAIN_CFGS.items():
    res, model, opt = cs.phase_train(label, dataclasses.replace(cfg, **kw),
                                     pool, cs.TRAIN_B, "cuda")
    p = res["profile"]
    out[label] = dict(step_ms=res["step_ms"], img_per_s=res["img_per_s"],
                      profile_wall_ms=p["wall_ms"],
                      profile_busy_ms=p["device_busy_ms"],
                      launches=p["kernel_launches"])
    del model, opt
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", required=True,
                        help="comma-separated checkout directories")
    parser.add_argument("--rounds", type=int, default=2,
                        help="A, B, B, A, ... pairs of runs per tree")
    args = parser.parse_args()
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    runs = {t: [] for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                              env=env, capture_output=True, text=True,
                              timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        runs[tree].append(res)
        print(json.dumps({"card": smi, "tree": tree, **res}), flush=True)
    summary = {t: {label: {k: statistics.median(r[label][k] for r in rs)
                           for k in rs[0][label]}
                   for label in rs[0]} for t, rs in runs.items()}
    print(json.dumps({"card": smi, "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
