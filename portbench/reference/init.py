"""Parameter initializers (counterpart of livecell_tpu/models/init.py).

The same distributions as the JAX package, drawn in place from an
explicit `torch.Generator`. Fans follow the JAX kernel convention: a
conv's fan_in is kh*kw*C_in and its fan_out kh*kw*C_out, a dense
layer's fan_in its input width. The numbers differ from JAX's for the
same seed; a model that must equal a JAX one takes its weights through
models/convert.py.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_default_kernel(w: torch.Tensor, fan_in: int,
                         generator: torch.Generator) -> torch.Tensor:
    """torch Conv2d/Linear default, kaiming_uniform(a=sqrt(5)):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return w.uniform_(-bound, bound, generator=generator)


# torch's default bias init has the same bound.
torch_default_bias = torch_default_kernel


@torch.no_grad()
def kaiming_uniform_a1(w: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    """kaiming_uniform_(a=1): U(-sqrt(3/fan_in), sqrt(3/fan_in))."""
    bound = math.sqrt(3.0 / fan_in)
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_fan_out(w: torch.Tensor, fan_out: int,
                           generator: torch.Generator) -> torch.Tensor:
    """kaiming_normal_(mode='fan_out', nonlinearity='relu'):
    N(0, 2/fan_out)."""
    return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def normal_std(w: torch.Tensor, std: float,
               generator: torch.Generator) -> torch.Tensor:
    return w.normal_(0.0, std, generator=generator)


@torch.no_grad()
def zeros(w: torch.Tensor) -> torch.Tensor:
    return w.zero_()
