"""RPN head (counterpart of livecell_tpu/models/rpn.py).

Shared 3x3 conv + ReLU, then one fused 1x1 conv with A objectness
channels followed by 4A delta channels (the JAX package fuses its two
1x1 predictors the same way; models/convert.py concatenates their
kernels). Outputs are NHWC: cls [B,H,W,A], deltas [B,H,W,4A], so a
row-major flatten gives (y, x, a) and (y, x, a, c) order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.init import (
    normal_std, torch_default_bias, torch_default_kernel, zeros)


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int,
                 generator: torch.Generator):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        torch_default_kernel(self.conv.weight, 9 * in_channels, generator)
        torch_default_bias(self.conv.bias, 9 * in_channels, generator)
        self.fused = nn.Conv2d(in_channels, 5 * num_anchors, 1)
        normal_std(self.fused.weight, 0.01, generator)
        zeros(self.fused.bias)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
        """NCHW levels -> (cls per level, deltas per level), NHWC."""
        a = self.num_anchors
        cls_out, box_out = [], []
        for f in feats:
            fused = self.fused(F.relu(self.conv(f))).permute(0, 2, 3, 1)
            cls_out.append(fused[..., :a])
            box_out.append(fused[..., a:])
        return tuple(cls_out), tuple(box_out)
