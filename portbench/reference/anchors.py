"""Anchor generation (counterpart of livecell_tpu/ops/anchors.py).

Anchors depend only on static shapes, so they are built once in numpy.
The base-anchor parameterization follows the reference: for size s and
ratio r, h = sqrt(s^2 / r) and w = h * r (the width carries the ratio).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=32)
def generate_anchors(
    feature_size: Tuple[int, int],
    stride: int = 4,
    sizes: Sequence[int] = (32, 64, 128),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """All anchors of a feature map, row-major over (y, x, anchor):
    float32 [H*W*A, 4] xyxy. The cached array is shared; do not write
    to it."""
    h, w = feature_size

    base = []
    for size in sizes:
        for ratio in ratios:
            area = float(size) * float(size)
            ah = np.sqrt(area / ratio)
            aw = ah * ratio
            base.append([-aw / 2.0, -ah / 2.0, aw / 2.0, ah / 2.0])
    base = np.asarray(base, dtype=np.float32)  # [A,4]

    shifts_x = np.arange(w, dtype=np.float32) * stride
    shifts_y = np.arange(h, dtype=np.float32) * stride
    sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], axis=2).reshape(-1, 4)  # [H*W,4]

    anchors = shifts[:, None, :] + base[None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)
