"""Mask resizing and pasting, batched and static-shaped (counterpart of
livecell_tpu/ops/mask_ops.py: resize_bilinear, paste_masks).

Both are two-matrix interpolation resamplings (ops/interp.py) in f32.
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
