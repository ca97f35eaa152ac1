"""Feature Pyramid Network (counterpart of livecell_tpu/models/fpn.py),
NCHW: 1x1 laterals, nearest top-down upsample-and-add, 3x3 output convs
with ReLU; kaiming_uniform(a=1) weights, zero biases. torchvision's
detection FPN (the transfer model) has no ReLU on the outputs and adds
P6, a 1x1 max-pool at stride 2 of the last output (ceil(n/2) rows).
"""

from __future__ import annotations

import functools
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
    other rows.

    FPN.forward takes this path only for a level whose map is not
    i // r on some axis (`repeat_factor`); its backward is two
    index_put_(accumulate=True), each a zero-fill, a sort of the indices
    and a scatter."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = out_hw
    ih = torch.arange(oh, device=x.device) * h // oh
    iw = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, ih][:, :, :, iw]


@functools.lru_cache(maxsize=None)
def repeat_factor(src: int, dst: int) -> Optional[int]:
    """The integer r with (i * src) // dst == i // r for every i < dst,
    or None. That holds for dst == r * src, and also for a crop of it:
    (i * 10) // 19 == i // 2 for every i < 19. Only r = ceil(dst / src),
    the first i that maps to 1, can."""
    r = -(-dst // src)
    return r if all((i * src) // dst == i // r for i in range(dst)) else None


def upsample_add(lat: torch.Tensor, top: torch.Tensor
                 ) -> Optional[torch.Tensor]:
    """lat + nearest_upsample_to(top, lat's HxW), equal bit for bit, as
    a broadcast add over the NHWC memory of both (a free view where they
    are channels_last, and the sum is too); None where an axis's map is
    not i // r (`repeat_factor`). The backward passes lat's gradient
    through and sums top's over the repeats, C innermost: no gather, no
    sort, no index tensor."""
    n, c, oh, ow = lat.shape
    h, w = top.shape[2], top.shape[3]
    rh, rw = repeat_factor(h, oh), repeat_factor(w, ow)
    if rh is None or rw is None:
        return None
    t = top.permute(0, 2, 3, 1)
    if (oh, ow) == (rh * h, rw * w):
        out = (lat.permute(0, 2, 3, 1).view(n, h, rh, w, rw, c)
               + t[:, :, None, :, None])
        return out.view(n, oh, ow, c).permute(0, 3, 1, 2)
    # A cropped axis: repeat rows, then columns (the indexed path's
    # order, so the backward sums in its order), and slice.
    up = t[:, :, None].expand(n, h, rh, w, c).reshape(n, h * rh, w, c)
    up = up[:, :, :, None].expand(n, h * rh, w, rw, c).reshape(
        n, h * rh, w * rw, c)
    return (lat.permute(0, 2, 3, 1) + up[:, :oh, :ow]).permute(0, 3, 1, 2)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 generator: torch.Generator, relu_outputs: bool = True,
                 extra_maxpool: bool = False):
        super().__init__()
        self.n_levels = len(in_channels)
        self.relu_outputs = relu_outputs
        self.extra_maxpool = extra_maxpool
        # Top-down levels summed by `upsample_add` and by the indexed
        # fallback, over every forward.
        self.stats = {"repeat": 0, "indexed": 0}
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
        an output conv only runs for a level that is returned.

        Each top-down step adds the upsampled level above to a lateral.
        Where the map src = (i * S) // D is i // r on both axes, as on
        every level of both models (exact 2x steps, and custom's top
        columns 10 -> 19, the 2x map cropped by one), `upsample_add`
        broadcasts the level above over the lateral; elsewhere the step
        adds `nearest_upsample_to`'s gather. The forward is the same
        either way, bit for bit; the paths taken count in `stats`."""
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            lat, top = laterals[i - 1], laterals[i]
            summed = upsample_add(lat, top)
            if summed is None:
                summed = lat + nearest_upsample_to(top, lat.shape[2:])
                self.stats["indexed"] += 1
            else:
                self.stats["repeat"] += 1
            laterals[i - 1] = summed
        n = self.n_levels if levels is None else levels
        outs = [getattr(self, f"output{i}")(laterals[i]) for i in range(n)]
        if self.relu_outputs:
            outs = [F.relu(o) for o in outs]
        if self.extra_maxpool and levels is None:
            # max_pool2d(kernel 1, stride 2) is this strided slice.
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
