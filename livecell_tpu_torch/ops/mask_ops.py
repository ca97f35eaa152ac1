"""Mask resizing, reprojection and pasting, batched and static-shaped
(counterpart of livecell_tpu/ops/mask_ops.py: resize_bilinear,
reproject_mask28, paste_masks).

All are two-matrix interpolation resamplings (ops/interp.py) in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from livecell_tpu_torch.ops.interp import paste_matrices, resize_weight_matrix


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) for NHWC
    tensors [..., H, W, C], computed in f32 with constant matrices (also
    under autocast, as the JAX package's einsums run at "highest")."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    wy = torch.from_numpy(resize_weight_matrix(h, oh)).to(x.device)
    wx = torch.from_numpy(resize_weight_matrix(w, ow)).to(x.device)
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
