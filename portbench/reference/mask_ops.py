"""Mask target extraction, resizing, reprojection and pasting, batched
and static-shaped (counterpart of livecell_tpu/ops/mask_ops.py:
extract_mask_targets, resize_bilinear, reproject_mask28, paste_masks).

All are two-matrix interpolation resamplings (ops/interp.py) in f32.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

from portbench.reference.interp import (
    crop_resize_matrices, paste_matrices, resize_weight_matrix)


@contextlib.contextmanager
def true_f32(device_type: str):
    """Matrix products in true f32 inside the block: no autocast, and on
    the card no TF32 (cuBLAS would otherwise round the operands to 10
    mantissa bits where the process allows it)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def extract_mask_targets(masks: torch.Tensor, boxes: torch.Tensor,
                         mask_size: int = 28) -> torch.Tensor:
    """Crop each mask to its box and resize it to mask_size^2 (the
    reference crops at the matched GT box).

    masks [K, H, W] float or uint8, boxes [K, 4] xyxy -> [K, mask_size,
    mask_size] f32, computed in true f32.
    """
    k, h, w = masks.shape
    wy, wx = crop_resize_matrices(boxes.float(), (h, w), mask_size)
    with true_f32(masks.device.type):
        t = torch.bmm(wy, masks.float())                   # [K, m, W]
        return torch.bmm(t, wx.transpose(1, 2))            # [K, m, m]


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, device: torch.device
                   ) -> torch.Tensor:
    """resize_weight_matrix on `device`, copied there once, outside
    inference mode (see device.constant: a copy in every call would make
    the host wait for the card)."""
    with torch.inference_mode(False):
        return torch.from_numpy(resize_weight_matrix(n_in, n_out)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) for NHWC
    tensors [..., H, W, C], computed in f32 with constant matrices (also
    under autocast, as the JAX package's einsums run at "highest")."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    wy = _resize_matrix(h, oh, x.device)
    wx = _resize_matrix(w, ow, x.device)
    with torch.autocast(x.device.type, enabled=False):
        t = torch.einsum("yh,...hwc->...ywc", wy, x.float())
        out = torch.einsum("xw,...ywc->...yxc", wx, t)
    return out.to(x.dtype)


def _reproject_axis(plo, phi, glo, ghi, m: int) -> torch.Tensor:
    """[..., m, m] weights resampling a GT-box-grid axis at the proposal
    box's bin centers; samples outside the GT box weigh 0 (no clamp)."""
    gspan = (ghi - glo).clamp(min=1e-6)
    j = torch.arange(m, dtype=torch.float32, device=plo.device)
    # Tensor operands on both sides of each division: PyTorch divides by
    # a Python scalar as a multiplication by its reciprocal.
    mm = torch.full_like(gspan, m)
    y = plo[..., None] + (j + 0.5) * ((phi - plo) / mm)[..., None] - 0.5
    u = (y - glo[..., None] + 0.5) * (mm / gspan)[..., None] - 0.5
    return (1.0 - (u[..., None] - j).abs()).clamp(min=0.0)


def reproject_mask28(mask28: torch.Tensor, gt_boxes: torch.Tensor,
                     prop_boxes: torch.Tensor) -> torch.Tensor:
    """Resample mask targets sampled on their GT boxes' grids [..., m, m]
    onto the proposal boxes' grids (torchvision's project_masks_on_boxes
    from the precomputed mask28): gt_boxes, prop_boxes [..., 4] -> [...,
    m, m] f32."""
    m = mask28.shape[-1]
    p, g = prop_boxes.float(), gt_boxes.float()
    wy = _reproject_axis(p[..., 1], p[..., 3], g[..., 1], g[..., 3], m)
    wx = _reproject_axis(p[..., 0], p[..., 2], g[..., 0], g[..., 2], m)
    with torch.autocast(mask28.device.type, enabled=False):
        t = torch.einsum("...yu,...uv->...yv", wy, mask28.float())
        return torch.einsum("...xv,...yv->...yx", wx, t)


def paste_masks(
    mask_probs: torch.Tensor,
    boxes: torch.Tensor,
    image_size: Tuple[int, int],
    threshold: float = 0.5,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paste [..., K, m, m] probability maps into full-image binary masks:
    resize each to its int-truncated, clamped box, binarize at
    `threshold` and write inside the box. Rows with valid False (or an
    empty box) paste nothing. Returns [..., K, H, W] uint8 in {0, 255}."""
    py, px, nonempty = paste_matrices(boxes.float(), image_size,
                                      mask_probs.shape[-1])
    ok = nonempty if valid is None else (nonempty & valid)
    t = torch.einsum("...khm,...kmn->...khn", py, mask_probs.float())
    full = torch.einsum("...kwn,...khn->...khw", px, t)
    binary = (full > threshold) & ok[..., None, None]
    return binary.to(torch.uint8) * 255
