"""Feature Pyramid Network (counterpart of livecell_tpu/models/fpn.py),
NCHW: 1x1 laterals, nearest top-down upsample-and-add, 3x3 output convs
with ReLU; kaiming_uniform(a=1) weights, zero biases. torchvision's
detection FPN (the transfer model) has no ReLU on the outputs and adds
P6, a 1x1 max-pool at stride 2 of the last output (ceil(n/2) rows).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from livecell_tpu_torch.models.init import kaiming_uniform_a1, zeros


def nearest_upsample_to(x: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """F.interpolate(mode='nearest', size=out_hw) on NCHW with the
    integer rule src = (i * S) // D, indexed explicitly: the top level
    goes 7x10 -> 14x19, a ratio on which float index rules can land on
    other rows."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = out_hw
    ih = torch.arange(oh, device=x.device) * h // oh
    iw = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, ih][:, :, :, iw]


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 generator: torch.Generator, relu_outputs: bool = True,
                 extra_maxpool: bool = False):
        super().__init__()
        self.n_levels = len(in_channels)
        self.relu_outputs = relu_outputs
        self.extra_maxpool = extra_maxpool
        for i, cin in enumerate(in_channels):
            lat = nn.Conv2d(cin, out_channels, 1)
            out = nn.Conv2d(out_channels, out_channels, 3, padding=1)
            kaiming_uniform_a1(lat.weight, cin, generator)
            zeros(lat.bias)
            kaiming_uniform_a1(out.weight, 9 * out_channels, generator)
            zeros(out.bias)
            self.add_module(f"lateral{i}", lat)
            self.add_module(f"output{i}", out)

    def forward(self, feats: Sequence[torch.Tensor],
                levels: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """The first `levels` outputs (default all, and P6 after them
        with extra_maxpool): the top-down path needs every lateral, but
        an output conv only runs for a level that is returned."""
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_upsample_to(
                laterals[i], laterals[i - 1].shape[2:])
        n = self.n_levels if levels is None else levels
        outs = [getattr(self, f"output{i}")(laterals[i]) for i in range(n)]
        if self.relu_outputs:
            outs = [F.relu(o) for o in outs]
        if self.extra_maxpool and levels is None:
            # max_pool2d(kernel 1, stride 2) is this strided slice.
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
