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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from portbench.reference.init import kaiming_normal_fan_out


class _BatchStats(torch.autograd.Function):
    """Train-mode batch norm over the batch of one process or, with a
    data group, the global batch split over its ranks (`n`: the global
    batch's values a channel). The statistics come from per-channel
    sums taken in f64 (and summed over the group), so every split of a
    batch normalizes with the same f32 mean and variance; on the card
    the normalization and its backward are PyTorch's batch-norm
    element and reduction kernels (batch_norm_elemt,
    batch_norm_backward_reduce / _elemt, SyncBatchNorm's), on the CPU
    F.batch_norm on the statistics and the same backward in plain ops:
    dx = w / sigma (dy - mean(dy) - x^ mean(dy x^)), the means over the
    global batch (their sums summed over the group). The weight and bias
    get this process's share, which DDP sums. Returns (y, mean, biased
    variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, n):
        dims = (0, 2, 3)
        sums = torch.stack([
            x.sum(dims, dtype=torch.float64),
            torch.linalg.vector_norm(x, 2, dims,
                                     dtype=torch.float64).square()])
        if group is not None:
            dist.all_reduce(sums, group=group)
        # Row 0 the mean, row 1 the biased variance E[x^2] - mean^2, in
        # f64, then rounded once; few launches (the step is host-bound).
        moments = sums / n
        moments[1].addcmul_(moments[0], moments[0], value=-1.0).clamp_(
            min=0.0)
        mean, var = moments.to(weight.dtype).unbind()
        invstd = (var + eps).rsqrt_()
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        fmt = torch.channels_last if x.is_contiguous(
            memory_format=torch.channels_last) else torch.contiguous_format
        dy = dy.contiguous(memory_format=fmt)
        if x.is_cuda:
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            if ctx.group is not None:
                both = torch.cat([sum_dy, sum_dy_xmu])
                dist.all_reduce(both, group=ctx.group)
                sum_dy, sum_dy_xmu = both[:c], both[c:]
            count = torch.full((1,), ctx.n, dtype=torch.int32,
                               device=x.device)
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count)
            return dx, dw, db, None, None, None
        wdt = weight.dtype
        dims = (0, 2, 3)
        per = (None, slice(None), None, None)
        xf, dyf = x.to(wdt), dy.to(wdt)
        sums = torch.cat([dyf.sum(dims, dtype=torch.float64),
                          (dyf * xf).sum(dims, dtype=torch.float64)])
        local = sums.clone()
        if ctx.group is not None:
            dist.all_reduce(sums, group=ctx.group)
        mean64, invstd64 = mean.double(), invstd.double()
        # sum(dy x^) = invstd (sum(dy x) - mean sum(dy)), per process and
        # over the group.
        dw = (invstd64 * (local[c:] - mean64 * local[:c])).to(wdt)
        db = local[:c].to(wdt)
        g_dy = sums[:c] / ctx.n
        g_dyx = invstd64 * (sums[c:] - mean64 * sums[:c]) / ctx.n
        a = weight.double() * invstd64
        coef_x = (-a * invstd64 * g_dyx).to(wdt)
        shift = (-a * (g_dy - mean64 * invstd64 * g_dyx)).to(wdt)
        dx = dyf * a.to(wdt)[per] + xf * coef_x[per] + shift[per]
        return dx.to(x.dtype), dw, db, None, None, None


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` on NCHW
    (livecell_tpu/models/resnet.py:36-38,166-168).

    Eval mode, or `frozen` (the model's frozen_bn): the running
    statistics. Train mode: the batch's mean and biased variance, and
    the running statistics move as running + 0.1 * (batch - running),
    that is 0.9 * running + 0.1 * batch, with the biased variance
    (nn.BatchNorm2d would move running_var with the unbiased one). The
    output keeps the input's dtype.

    On one card the train-mode statistics are cuDNN's (F.batch_norm, the
    fastest: the step is host-bound). With `data_axis`
    (parallel/mesh.py:shard_model, a data axis of more than one rank)
    the batch is the global one and `_BatchStats` takes its statistics
    from f64 sums summed over the data ranks, forward and backward, so
    every split of a batch normalizes with the same f32 values; on CPU
    tensors `_BatchStats` serves one process too, so the CPU tests hold
    a mesh to the single process bit for bit in its statistics.
    nn.SyncBatchNorm is not used: it moves running_var with the
    unbiased variance."""

    frozen = False
    data_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.data_axis is None and x.is_cuda:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True,
                             0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
        else:
            n = x.numel() // x.shape[1]
            group = None
            if self.data_axis is not None:
                group = self.data_axis.group
                n *= self.data_axis.size
            y, mean, var = _BatchStats.apply(x, self.weight, self.bias,
                                             self.eps, group, n)
        with torch.no_grad():
            self.running_mean.lerp_(mean, 0.1)
            self.running_var.lerp_(var, 0.1)
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
