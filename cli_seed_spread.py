#!/usr/bin/env python3
"""The seed spread under chip_smoke.py's phase 15 gate, on one GPU.

    python3 cli_seed_spread.py --seeds 0,1,2,3,4 [--f32]

Draws phase 15's "sparse" split (chip_smoke.draw_split, the same seed),
then runs train/train_custom.py:main with phase 15's flagship command
(chip_smoke.CUSTOM_CLI) once per seed in bf16, and in f32 too with
--f32, each from its own working directory under a temporary one. Prints
one JSON line a run: the test mask AP/AP50/AP75, the test box metrics,
the training losses, the validation F1 and the epoch seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import torch

from chip_smoke import CUSTOM_CLI, SEED, SPARSE_FRAMES, draw_split, log


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=str, default="0,1,2",
                        help="comma-separated seeds")
    parser.add_argument("--f32", action="store_true",
                        help="also run each seed in f32")
    args = parser.parse_args(argv)
    from livecell_tpu_torch.config import Config, ModelConfig
    from livecell_tpu_torch.ops import _build
    from livecell_tpu_torch.train import train_custom

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    seeds = [int(x) for x in args.seeds.split(",")]
    runs = [(s, "bfloat16") for s in seeds]
    runs += [(s, "float32") for s in seeds] if args.f32 else []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        draw_split(root, SEED + 15, "sparse", SPARSE_FRAMES)
        for seed, dtype in runs:
            wd = root / f"run_{seed}_{dtype}"
            wd.mkdir()
            os.chdir(wd)
            try:
                out = train_custom.main(
                    ["--data_dir", str(root)] + CUSTOM_CLI
                    + ["--seed", str(seed)],
                    config=Config(model=ModelConfig(compute_dtype=dtype)))
            finally:
                os.chdir(cwd)
            log("[cli seeds]", json.dumps(dict(
                seed=seed, dtype=dtype, test_mask_ap=out["test_ap"],
                test=out["test_metrics"], train_losses=out["train_losses"],
                val_f1=[v["f1_score"] for v in out["val_metrics"]],
                epoch_s=out["epoch_seconds"])))
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
