"""Bilinear interpolation as dense weight matrices (counterpart of
livecell_tpu/ops/interp.py).

A 1-D bilinear resampling is a matrix W[k, out, in] with
W[k, o, i] = relu(1 - |coord(k, o) - i|) for clamped sample coordinates:
the two-tap bilinear weight with replicate edges. A boolean validity
factor zeroes rows whose sample falls outside the source.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def interp_weights(coords: torch.Tensor, size: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-tap bilinear weights [..., size] for sample coordinates [...],
    clamped to [0, size - 1] first; rows with valid False are zero."""
    c = coords.clamp(0.0, float(size - 1))[..., None]
    idx = torch.arange(size, dtype=coords.dtype, device=coords.device)
    w = (1.0 - (c - idx).abs()).clamp(min=0.0)
    if valid is not None:
        w = w * valid[..., None].to(w.dtype)
    return w


@functools.lru_cache(maxsize=64)
def resize_weight_matrix(src: int, dst: int) -> np.ndarray:
    """Static [dst, src] matrix of
    F.interpolate(mode='bilinear', align_corners=False) in 1-D."""
    i = np.arange(dst, dtype=np.float64)
    x = (i + 0.5) * (src / dst) - 0.5
    x = np.clip(x, 0.0, src - 1)
    idx = np.arange(src, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs(x[:, None] - idx[None, :]))
    return w.astype(np.float32)


def _int_trunc(x: torch.Tensor) -> torch.Tensor:
    """torch Tensor.int() semantics: truncate toward zero (not floor)."""
    return torch.trunc(x)


def crop_resize_matrices(boxes: torch.Tensor, src_hw: Tuple[int, int],
                         dst: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-box weight matrices for GT-mask target extraction (the
    reference's extract_mask_target): the box is truncated to ints and
    clamped (x1 in [0, w-1], x2 in [x1+1, w]), the mask cropped to it and
    resized bilinearly to dst x dst with align_corners=False.

    boxes [K, 4] float xyxy -> (Wy [K, dst, H], Wx [K, dst, W]) with
    target[k] = Wy[k] @ mask[k] @ Wx[k].T.
    """
    h, w = src_hw
    x1 = _int_trunc(boxes[:, 0]).clamp(0, w - 1)
    y1 = _int_trunc(boxes[:, 1]).clamp(0, h - 1)
    x2 = torch.maximum(x1 + 1, _int_trunc(boxes[:, 2]).clamp(max=w))
    y2 = torch.maximum(y1 + 1, _int_trunc(boxes[:, 3]).clamp(max=h))

    def axis_weights(lo, hi, size):
        span = hi - lo                                          # [K]
        i = torch.arange(dst, dtype=boxes.dtype, device=boxes.device)
        # A tensor divisor: PyTorch divides by a Python scalar as a
        # multiplication by its reciprocal, JAX divides.
        step = span / torch.full_like(span, dst)
        local = (i + 0.5) * step[:, None] - 0.5
        local = torch.minimum(local.clamp(min=0.0), span[:, None] - 1.0)
        return interp_weights(lo[:, None] + local, size)

    return axis_weights(y1, y2, h), axis_weights(x1, x2, w)


def roi_sample_matrices(
    boxes: torch.Tensor,
    feat_hw: Tuple[int, int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    spatial_scale: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ROI sample-point weight matrices for RoIAlign (torchvision,
    aligned=False): box coords scaled by spatial_scale, side lengths
    floored at 1.0, `sampling_ratio` samples per bin at offsets
    (s + 0.5) / ratio, samples outside [-1, size] contribute zero.

    boxes [..., K, 4] -> (Wy [..., K, out*ratio, H],
    Wx [..., K, out*ratio, W]).
    """
    fh, fw = feat_hw
    n = out_size * sampling_ratio
    s = torch.arange(n, dtype=boxes.dtype, device=boxes.device)
    pos = torch.floor(s / sampling_ratio) + (
        s % sampling_ratio + 0.5) / sampling_ratio

    def axis_weights(lo, hi, size):
        start = lo * spatial_scale
        length = (hi * spatial_scale - start).clamp(min=1.0)
        bin_sz = length / out_size
        coords = start[..., None] + pos * bin_sz[..., None]
        valid = (coords >= -1.0) & (coords <= float(size))
        return interp_weights(coords, size, valid)

    wy = axis_weights(boxes[..., 1], boxes[..., 3], fh)
    wx = axis_weights(boxes[..., 0], boxes[..., 2], fw)
    return wy, wx


def paste_matrices(
    boxes: torch.Tensor, img_hw: Tuple[int, int], mask_size: int = 28,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matrices that paste a mask_size^2 mask into the image: the box is
    truncated toward zero to ints (torch `Tensor.int()`) and clamped,
    the mask is resized (bilinear, align_corners=False) to the box
    extent and written inside it.

    boxes [..., K, 4] -> (Py [..., K, H, m], Px [..., K, W, m],
    nonempty [..., K]); full[k] = Py[k] @ mask[k] @ Px[k].T.
    """
    h, w = img_hw
    x1 = torch.trunc(boxes[..., 0]).clamp(min=0.0)
    y1 = torch.trunc(boxes[..., 1]).clamp(min=0.0)
    x2 = torch.trunc(boxes[..., 2]).clamp(max=float(w))
    y2 = torch.trunc(boxes[..., 3]).clamp(max=float(h))
    nonempty = (x2 > x1) & (y2 > y1)

    def axis_weights(lo, hi, size):
        span = (hi - lo).clamp(min=1.0)
        p = torch.arange(size, dtype=boxes.dtype, device=boxes.device)
        local = p - lo[..., None]
        src = (local + 0.5) * (mask_size / span[..., None]) - 0.5
        inside = (p >= lo[..., None]) & (p < hi[..., None])
        return interp_weights(src, mask_size, inside)

    return axis_weights(y1, y2, h), axis_weights(x1, x2, w), nonempty
