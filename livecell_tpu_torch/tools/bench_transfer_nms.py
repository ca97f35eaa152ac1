"""Time the transfer model's RPN-NMS tail on the H100 (counterpart of
scripts/bench_transfer_nms.py): inference on one 224x304 tile at
per-level top-k 1000/1000 (torchvision parity, the default) against a
reduced 512/512.

    python -m livecell_tpu_torch.tools.bench_transfer_nms [--steps 20]

The model is the full-width TransferConfig at rpn_pre_topk_per_level =
rpn_post_nms = k, random weights from seed 0, bf16; the tile is
default_rng(0) noise in [0, 1]. Each timed run of --steps calls ends in
a synchronize. Prints JAX's keys (topk_512_ms, topk_1000_ms,
parity_cost_ms) and "card". Runs on the card; `main([...],
device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from livecell_tpu_torch.config import TransferConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.utils.flops import card_of
from livecell_tpu_torch.utils.profiling import sync


def run(topk: int, steps: int, dev: torch.device) -> float:
    """Seconds per inference of one tile at per-level top-k `topk`."""
    cfg = dataclasses.replace(TransferConfig(),
                              rpn_pre_topk_per_level=topk, rpn_post_nms=topk)
    model = create_transfer_model(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(
        size=(1, cfg.tile_height, cfg.tile_width, 3)).astype(np.float32)
    ).to(dev)
    with torch.inference_mode():
        model.inference_forward(images)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            model.inference_forward(images)
        sync(dev)
    return (time.perf_counter() - t0) / steps


def main(argv=None, device=None) -> Dict:
    """Returns the printed record."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    results = {}
    for topk in (512, 1000):
        dt = run(topk, args.steps, dev)
        results[f"topk_{topk}_ms"] = round(dt * 1000, 2)
        print(f"transfer inference topk={topk}: {dt * 1000:.1f} ms/tile",
              file=sys.stderr)
    results["parity_cost_ms"] = round(
        results["topk_1000_ms"] - results["topk_512_ms"], 2)
    results["card"] = card_of(dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
