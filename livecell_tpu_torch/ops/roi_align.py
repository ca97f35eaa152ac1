"""RoIAlign as two dense contractions in float32 (counterpart of
livecell_tpu/ops/roi_align.py: roi_align, roi_align_batched).

Each ROI's bilinear sampling is two interpolation matrices
(ops/interp.roi_sample_matrices):

    t    = einsum('kyh,hwc->kywc', Wy, feat)     # rows
    s    = einsum('kxw,kywc->kyxc', Wx, t)       # cols
    out  = mean of s over the sampling_ratio^2 sub-samples of each bin

This float32 form is the port's yardstick of exactness for the kernels
in ops/cuda_roi_align.py. It exists only as a test reference: no code
path of the port calls it.
"""

from __future__ import annotations

import torch

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
