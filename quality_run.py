#!/usr/bin/env python3
"""The quality tools of the PyTorch/CUDA port at their real size on one
GPU (livecell_tpu_torch/tools/):

  1. synth_splits: the sparse, lc and dense splits at 14/3/3 frames;
  2. gt_bound on lc and dense at the reference caps (50 detections, NMS
     0.5) and the lifted caps (256, 0.6);
  3. quality_matrix over the three splits: the flagship recipe for
     --epochs epochs, each checkpoint scored at both caps;
  4. dense_sweep --recipes a12 on lc;
  5. oracle_probe on 16 dense test tiles with the a12-lc checkpoint.

    python3 quality_run.py [--workdir outputs/quality_run] [--epochs 10]
        [--seed 0]

Everything is written under --workdir: the splits, the checkpoints,
each child's output (children/<n>.log), the JSONL of the matrix and the
sweep, the oracle report, and results.json. Prints the card's name and
power limit first, each child's and each step's seconds, and the
results as one JSON line last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default="outputs/quality_run")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("quality_run: no CUDA device", file=sys.stderr)
        return 1
    from livecell_tpu_torch.tools import (
        dense_sweep, gt_bound, oracle_probe, quality_matrix, synth_splits)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = Path(args.workdir).resolve()
    (work / "children").mkdir(parents=True, exist_ok=True)
    roots = {m: work / m for m in synth_splits.MODES}
    res = {"card": smi, "epochs": args.epochs, "seed": args.seed,
           "children": [], "steps_s": {}}

    def runner(cmd, **kw):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, **kw)
        n = len(res["children"])
        (work / "children" / f"{n}.log").write_text(
            " ".join(map(str, cmd)) + "\n" + r.stdout + r.stderr)
        res["children"].append({"cmd": cmd[2:], "cwd": str(kw.get("cwd")),
                                "rc": r.returncode,
                                "s": time.perf_counter() - t0})
        print(f"[child {n}] {time.perf_counter() - t0:.1f} s rc "
              f"{r.returncode}: {' '.join(map(str, cmd[2:]))}", flush=True)
        return r

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        res["steps_s"][name] = time.perf_counter() - t0
        print(f"[{name}] {res['steps_s'][name]:.1f} s", flush=True)
        return out

    step("splits", lambda: synth_splits.main(
        ["--roots"] + [f"{m}:{r}" for m, r in roots.items()]
        + ["--seed", str(args.seed)]))
    res["gt_bound"] = step("gt_bound", lambda: {
        f"{m}/{caps}": gt_bound.main(["--data_dir", str(roots[m] / "split"),
                                      "--dets", dets, "--det_nms", nms])
        for m in ("lc", "dense")
        for caps, dets, nms in (("reference", "50", "0.5"),
                                ("lifted", "256", "0.6"))})
    res["matrix"] = step("matrix", lambda: quality_matrix.main(
        ["--splits"] + [f"{m}:{r}" for m, r in roots.items()]
        + ["--epochs", str(args.epochs), "--out",
           str(work / "quality_matrix.jsonl")], runner=runner))
    res["sweep"] = step("sweep", lambda: dense_sweep.main(
        ["--split", str(roots["lc"]), "--name", "lc", "--recipes", "a12",
         "--seeds", str(args.seed), "--epochs", str(args.epochs),
         "--workroot", str(work / "sweep"), "--out",
         str(work / "dense_sweep_lc.jsonl")], runner=runner))
    ckpt = work / "sweep" / "lc" / f"a12_s{args.seed}" / "models" / \
        f"custom_maskrcnn_{args.epochs}epochs.ckpt"
    res["oracle"] = step("oracle", lambda: oracle_probe.main(
        ["--ckpt", str(ckpt), "--data_dir", str(roots["dense"] / "split"),
         "--max_images", "16", "--out", str(work / "oracle_dense.json")]))
    (work / "results.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
