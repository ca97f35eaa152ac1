"""CBAM attention (counterpart of livecell_tpu/models/cbam.py), NCHW.

Channel attention: sigmoid(MLP(avgpool) + MLP(maxpool)) with a shared
bias-free 2-layer MLP (reduction 16); then spatial attention:
sigmoid(conv7x7([mean_c, max_c])), bias-free.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.init import torch_default_kernel


class ChannelAttention(nn.Module):
    def __init__(self, channels: int, reduction: int,
                 generator: torch.Generator):
        super().__init__()
        hidden = channels // reduction
        self.fc1 = nn.Linear(channels, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, channels, bias=False)
        torch_default_kernel(self.fc1.weight, channels, generator)
        torch_default_kernel(self.fc2.weight, hidden, generator)

    def forward(self, x):
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        y = self.fc2(F.relu(self.fc1(avg))) + self.fc2(F.relu(self.fc1(mx)))
        return x * torch.sigmoid(y)[:, :, None, None]


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int, generator: torch.Generator):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)
        torch_default_kernel(self.conv.weight, kernel_size * kernel_size * 2,
                             generator)

    def forward(self, x):
        y = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(y))


class CBAM(nn.Module):
    def __init__(self, channels: int, reduction: int, kernel_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.channel = ChannelAttention(channels, reduction, generator)
        self.spatial = SpatialAttention(kernel_size, generator)

    def forward(self, x):
        return self.spatial(self.channel(x))
