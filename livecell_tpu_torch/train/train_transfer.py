"""The transfer model's optimizer (counterpart of
livecell_tpu/train/train_transfer.py: FROZEN_STAGE1, stage_optimizer).

Stage 1 trains the heads with the backbone, FPN and RPN frozen; stage 2
trains everything; both with SGD, momentum and weight decay. The
trainer's command line waits for the port's data slice.
"""

from __future__ import annotations

import torch
from torch import nn

FROZEN_STAGE1 = ("backbone", "fpn", "rpn")


class ClippedSGD(torch.optim.SGD):
    """torch.optim.SGD that first scales its own parameters' gradients as
    optax.clip_by_global_norm does: unchanged below `clip_norm`, else
    g / norm * clip_norm, the norm taken over this optimizer's
    parameters only."""

    def __init__(self, params, clip_norm: float, **kw):
        super().__init__(params, **kw)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if grads:
            norm = torch.stack([(x * x).sum() for x in grads]).sum().sqrt()
            for x in grads:
                x.copy_(torch.where(norm < self.clip_norm, x,
                                    x / norm * self.clip_norm))
        return super().step(closure)


def stage_optimizer(model: nn.Module, lr: float, momentum: float,
                    weight_decay: float, freeze: bool,
                    clip_norm: float = 0.0) -> torch.optim.SGD:
    """SGD with momentum and weight decay over the model's parameters;
    with `freeze` (stage 1) the backbone, FPN and RPN are left out, so
    they get no update and no decay (optax.set_to_zero) though they
    still get gradients. torch's SGD (d = g + wd * p, buf = momentum *
    buf + d, p -= lr * buf) is optax's add_decayed_weights then
    sgd(momentum). With clip_norm > 0 the trainable gradients are first
    clipped to that global norm (not in the reference; for training from
    random weights)."""
    params = [p for name, p in model.named_parameters()
              if not (freeze and name.split(".")[0] in FROZEN_STAGE1)]
    kw = dict(lr=lr, momentum=momentum, weight_decay=weight_decay)
    if clip_norm > 0:
        return ClippedSGD(params, clip_norm, **kw)
    return torch.optim.SGD(params, **kw)
