"""The cells' inputs, drawn from the seed.

`train_split`: the draw of the port's measurement tools
(tools/profile_step.py:draw_inputs, tools/roofline.py:loop_targets), a
tile of uint8 noise with `n_inst` boxes whose corner lies in [0, w - 60)
x [0, h - 60) and whose sides lie in [min_side, max_side), in `slots`
instance slots, and mask28 targets of noise at one half; made here on
the device with a torch generator, in bulk, where the tools draw on the
host with numpy.

`frames`: grey 704x520 frames of ellipses at LIVECell's statistics (a
copy of tools/synth_splits.py's `lc` mode: a normal count about 305, a
lognormal equivalent radius about 10 px, elongation up to 3:1, each
cell one grey level of 120-220 on 30), filled with numpy, cut into the
25 overlapping tiles of the frame predictor; `pool_counts` gives a
pool of frames the normal count's quantiles in place of its draws."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def train_split(n: int, h: int, w: int, slots: int, n_inst: int,
                min_side: float, max_side: float, gen: torch.Generator,
                device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    images = torch.randint(0, 255, (n, h, w, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    u = torch.rand((4, n, n_inst), generator=gen, device=device)
    x1, y1 = u[0] * (w - 60), u[1] * (h - 60)
    bw = min_side + u[2] * (max_side - min_side)
    bh = min_side + u[3] * (max_side - min_side)
    boxes = torch.zeros((n, slots, 4), device=device)
    boxes[:, :n_inst] = torch.stack([x1, y1, x1 + bw, y1 + bh], dim=-1)
    valid = torch.zeros((n, slots), dtype=torch.bool, device=device)
    valid[:, :n_inst] = True
    mask28 = (torch.rand((n, slots, 28, 28), generator=gen, device=device)
              > 0.5).to(torch.uint8) * 255
    return images, {"boxes": boxes, "labels": valid.to(torch.int32),
                    "mask28": mask28, "valid": valid}


MEAN_CELLS, RADIUS_MEDIAN, RADIUS_SIGMA, MAX_ASPECT = 305, 10.0, 0.45, 3.0
BACKGROUND = 30


def frame(rng: np.random.Generator, fw: int = 704, fh: int = 520,
          count: Optional[int] = None) -> np.ndarray:
    """One grey frame [fh, fw] uint8 of `count` cells, or of a normal
    count about MEAN_CELLS where None."""
    if count is None:
        count = max(1, int(rng.normal(MEAN_CELLS, MEAN_CELLS * 0.25)))
    canvas = np.full((fh, fw), BACKGROUND, np.uint8)
    yy, xx = np.mgrid[0:fh, 0:fw].astype(np.float32)
    for _ in range(count):
        r = RADIUS_MEDIAN * math.exp(rng.normal(0.0, RADIUS_SIGMA))
        aspect = rng.uniform(1.0, MAX_ASPECT)
        rx, ry = r * math.sqrt(aspect), r / math.sqrt(aspect)
        cx, cy = rng.uniform(5, fw - 5), rng.uniform(5, fh - 5)
        t = rng.uniform(0, math.pi)
        level = int(rng.uniform(120, 220))
        ext = int(math.ceil(max(rx, ry))) + 1
        y0, y1 = max(int(cy) - ext, 0), min(int(cy) + ext + 1, fh)
        x0, x1 = max(int(cx) - ext, 0), min(int(cx) + ext + 1, fw)
        dx, dy = xx[y0:y1, x0:x1] - cx, yy[y0:y1, x0:x1] - cy
        ct, st = math.cos(t), math.sin(t)
        u, v = dx * ct + dy * st, -dx * st + dy * ct
        inside = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
        canvas[y0:y1, x0:x1][inside] = level
    return canvas


def pool_counts(n: int, rng: np.random.Generator) -> List[int]:
    """The cell counts of a pool of n frames: the normal count's
    quantiles (i + 1/2) / n, in an order drawn from rng, so that every
    seed serves the same set of frame sizes."""
    dist = statistics.NormalDist(MEAN_CELLS, MEAN_CELLS * 0.25)
    counts = [max(1, int(dist.inv_cdf((i + 0.5) / n))) for i in range(n)]
    return [counts[i] for i in rng.permutation(n)]


def tiles(frame_u8: np.ndarray, tile_hw: Tuple[int, int], mini_hw:
          Tuple[int, int], per_row: int) -> np.ndarray:
    """The frame's per_row^2 overlapping tiles [T, th, tw, 3] uint8 (grey
    widened to RGB), tile t at mini-tile (t % per_row, t // per_row)."""
    th, tw = tile_hw
    mh, mw = mini_hw
    out = np.zeros((per_row * per_row, th, tw, 3), np.uint8)
    for t in range(per_row * per_row):
        y0, x0 = (t // per_row) * mh, (t % per_row) * mw
        patch = frame_u8[y0:y0 + th, x0:x0 + tw]
        out[t, :patch.shape[0], :patch.shape[1]] = patch[..., None]
    return out
