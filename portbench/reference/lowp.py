"""The reference's precisions.

`exact()`: float32 with TF32 off in cuBLAS and cuDNN, the precision the
reference is compared in. `fp8(model)`: the control, the reference with
every convolution and linear layer computed on operands rounded to fp8
(e4m3, each tensor scaled so its largest magnitude is e4m3's largest,
448), the precision below the configurations' bfloat16, forward and
backward: the inputs and weights are rounded in the forward, and in the
backward the gradient of each layer's output and the gradients its
products give back, so every product of the step takes fp8 operands."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(x.dtype)


class _RoundFp8(torch.autograd.Function):
    """Rounds in the forward and the gradient in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class _RoundGradFp8(torch.autograd.Function):
    """The identity, its gradient rounded."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFp8.apply(x)


def _conv(self, x):
    return _RoundGradFp8.apply(self._conv_forward(
        round_fp8(x), round_fp8(self.weight), self.bias))


def _linear(self, x):
    return _RoundGradFp8.apply(
        F.linear(round_fp8(x), round_fp8(self.weight), self.bias))


def _deconv(self, x, output_size=None):
    return _RoundGradFp8.apply(F.conv_transpose2d(
        round_fp8(x), round_fp8(self.weight), self.bias, self.stride,
        self.padding, self.output_padding, self.groups, self.dilation))


def fp8(model: nn.Module) -> nn.Module:
    """`model` with its convolutions and linear layers computing on fp8
    operands (in place)."""
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.forward = _deconv.__get__(m)
        elif isinstance(m, nn.Conv2d):
            m.forward = _conv.__get__(m)
        elif isinstance(m, nn.Linear):
            m.forward = _linear.__get__(m)
    return model
