"""ResNet backbones (counterpart of livecell_tpu/models/resnet.py).

torchvision's stem + BasicBlock stages (ResNet-18, the custom model) or
Bottleneck stages (ResNet-50, the transfer model), NCHW inside (the model keeps
activations in channels_last memory, so they are NHWC in memory).
Batch norm has flax's semantics (`BatchNorm`). Module names mirror the
JAX parameter tree (`conv1`, `bn1`, `layer1_0/conv1/conv`, ...). The
JAX package's
space-to-depth stem (`stem_s2d`) computes the same function as the
plain 7x7/2 stem, so the port has only the plain one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from livecell_tpu_torch.models.init import kaiming_normal_fan_out


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` on NCHW
    (livecell_tpu/models/resnet.py:36-38,166-168).

    Eval mode, or `frozen` (the model's frozen_bn): the running
    statistics. Train mode: the batch's mean and biased variance, taken
    in f32 whatever the activations' dtype, and the running statistics
    move as running = 0.9 * running + 0.1 * batch with the biased
    variance (nn.BatchNorm2d would move running_var with the unbiased
    one). The output keeps the input's dtype."""

    frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        return y


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = BatchNorm(cout, eps=1e-5)
        kaiming_normal_fan_out(self.conv.weight, kernel * kernel * cout,
                               generator)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    """3x3-3x3 with identity or 1x1 projection shortcut."""

    def __init__(self, cin: int, cout: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, stride, generator)
        self.conv2 = ConvBN(cout, cout, 3, 1, generator)
        self.downsample = (ConvBN(cin, cout, 1, stride, generator)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = self.conv2(F.relu(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 - 3x3 (strided) - 1x1 to 4x the
    width, with identity or 1x1 projection shortcut."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = ConvBN(cin, width, 1, 1, generator)
        self.conv2 = ConvBN(width, width, 3, stride, generator)
        self.conv3 = ConvBN(width, cout, 1, 1, generator)
        self.downsample = (ConvBN(cin, cout, 1, stride, generator)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = self.conv3(F.relu(self.conv2(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages, returning the stage outputs (c1..c4).
    depths/bottleneck select ResNet-18 ((2,2,2,2), BasicBlock) or
    ResNet-50 ((3,4,6,3), Bottleneck)."""

    def __init__(self, generator: torch.Generator,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 bottleneck: bool = False):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        kaiming_normal_fan_out(self.conv1.weight, 7 * 7 * 64, generator)
        self.bn1 = BatchNorm(64, eps=1e-5)
        self.stage_names = []
        cin = 64
        for i, (depth, width) in enumerate(zip(depths, widths)):
            names = []
            for j in range(depth):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block(cin, width, stride, generator))
                names.append(name)
                cin = width * (Bottleneck.expansion if bottleneck else 1)
            self.stage_names.append(names)

    def forward(self, x, post_stage: Sequence = ()
                ) -> Tuple[torch.Tensor, ...]:
        """post_stage: per-stage modules (CBAM) applied after each stage
        and fed to the next one (serial chaining)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if i < len(post_stage):
                x = post_stage[i](x)
            feats.append(x)
        return tuple(feats)
