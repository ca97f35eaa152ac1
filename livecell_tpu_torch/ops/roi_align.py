"""RoIAlign as two dense contractions in float32 (counterpart of
livecell_tpu/ops/roi_align.py: roi_align, roi_align_batched,
multiscale_roi_align).

Each ROI's bilinear sampling is two interpolation matrices
(ops/interp.roi_sample_matrices):

    t    = einsum('kyh,hwc->kywc', Wy, feat)     # rows
    s    = einsum('kxw,kywc->kyxc', Wx, t)       # cols
    out  = mean of s over the sampling_ratio^2 sub-samples of each bin

This float32 form is the port's yardstick of exactness for the kernels
in ops/cuda_roi_align.py and ops/cuda_ms_roi_align.py. It exists only as
a test reference: no code path of the port calls it.
"""

from __future__ import annotations

import torch

from typing import Sequence

from livecell_tpu_torch.ops.interp import roi_sample_matrices


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor,
                      out_size: int = 7, spatial_scale: float = 0.25,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """features [B, H, W, C] (NHWC), boxes [B, K, 4] xyxy in image
    coordinates -> [B, K, out_size, out_size, C] in features.dtype,
    computed in float32."""
    b, fh, fw, c = features.shape
    k = boxes.shape[1]
    wy, wx = roi_sample_matrices(boxes.float(), (fh, fw), out_size,
                                 sampling_ratio, spatial_scale)
    f32 = features.float()
    t = torch.einsum("bkyh,bhwc->bkywc", wy, f32)
    s = torch.einsum("bkxw,bkywc->bkyxc", wx, t)
    s = s.reshape(b, k, out_size, sampling_ratio, out_size, sampling_ratio, c)
    return s.mean(dim=(3, 5)).to(features.dtype)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              out_size: int = 7, spatial_scale: float = 0.25,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Single image: features [H, W, C], boxes [K, 4] -> [K, s, s, C]."""
    return roi_align_batched(features[None], boxes[None], out_size,
                             spatial_scale, sampling_ratio)[0]


def multiscale_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                         out_size: int = 7, sampling_ratio: int = 2,
                         canonical_size: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """torchvision MultiScaleRoIAlign over P2-P5, batched: feats 4 maps
    [B, H_l, W_l, C] (strides 4, 8, 16, 32), boxes [B, K, 4] in image
    coordinates -> [B, K, s, s, C] in feats[0].dtype, computed in f32.
    Each ROI takes the LevelMapper level floor(k0 + log2(sqrt(area) /
    224 + 1e-6)) clamped to [2, 5] and RoIAlign (aligned=False) there."""
    b = boxes.float()
    area = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp(
        min=1e-12)
    lvl = torch.floor(canonical_level + torch.log2(
        area.sqrt() / torch.full_like(area, canonical_size) + 1e-6))
    lvl = lvl.clamp(2, 5).long() - 2                         # [B, K]
    out = None
    for i, f in enumerate(feats):
        o = roi_align_batched(f.float(), b, out_size, 0.25 / 2 ** i,
                              sampling_ratio)
        o = torch.where((lvl == i)[..., None, None, None], o,
                        torch.zeros_like(o))
        out = o if out is None else out + o
    return out.to(feats[0].dtype)
