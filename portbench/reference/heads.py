"""Box and mask heads (counterpart of livecell_tpu/models/heads.py).

Both take NHWC ROI features [K, 7, 7, C], as the RoIAlign gives them.

BoxHead: flatten (y, x, c)-major -> FC 1024 -> FC 1024 -> (cls_score,
bbox_pred); predictor init normal std 0.01 / 0.001, zero bias. On a
mesh with a model axis (`model_group`, parallel/mesh.py:shard_model)
fc1 holds this rank's output columns and fc2 the matching input
columns: fc1 takes its input through copy_to_model, fc2's partial
products are summed by reduce_from_model before its bias.

MaskHead: 4x (3x3 conv 256 + ReLU) -> 2x2/2 transposed conv + ReLU ->
1x1 logits -> fixed bilinear resize 14 -> 28; kaiming_normal(fan_out)
weights, zero biases.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.init import (
    kaiming_normal_fan_out, normal_std, torch_default_bias,
    torch_default_kernel, zeros)
from portbench.reference.mask_ops import resize_bilinear


class BoxHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, roi_size: int,
                 generator: torch.Generator):
        super().__init__()
        fan_in = in_channels * roi_size * roi_size
        self.fc1 = nn.Linear(fan_in, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, num_classes)
        self.bbox_pred = nn.Linear(1024, 4 * num_classes)
        torch_default_kernel(self.fc1.weight, fan_in, generator)
        torch_default_bias(self.fc1.bias, fan_in, generator)
        torch_default_kernel(self.fc2.weight, 1024, generator)
        torch_default_bias(self.fc2.bias, 1024, generator)
        normal_std(self.cls_score.weight, 0.01, generator)
        zeros(self.cls_score.bias)
        normal_std(self.bbox_pred.weight, 0.001, generator)
        zeros(self.bbox_pred.bias)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, 7, 7, C] -> (cls_logits [K, nc], deltas [K, 4nc]) in f32."""
        x = roi_feats.reshape(roi_feats.shape[0], -1).to(self.fc1.weight.dtype)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, mask_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.mask_size = mask_size
        cin = in_channels
        for i in range(4):
            conv = nn.Conv2d(cin, 256, 3, padding=1)
            kaiming_normal_fan_out(conv.weight, 9 * 256, generator)
            zeros(conv.bias)
            self.add_module(f"conv{i + 1}", conv)
            cin = 256
        self.deconv = nn.ConvTranspose2d(256, 256, 2, stride=2)
        kaiming_normal_fan_out(self.deconv.weight, 4 * 256, generator)
        zeros(self.deconv.bias)
        self.mask_fcn_logits = nn.Conv2d(256, num_classes, 1)
        kaiming_normal_fan_out(self.mask_fcn_logits.weight, num_classes,
                               generator)
        zeros(self.mask_fcn_logits.bias)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """[K, 7, 7, C] -> mask logits [K, 28, 28, num_classes] in f32."""
        x = roi_feats.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = F.relu(self.deconv(x))
        logits = self.mask_fcn_logits(x).float().permute(0, 2, 3, 1)
        if logits.shape[1] != self.mask_size:
            logits = resize_bilinear(logits, (self.mask_size, self.mask_size))
        return logits
