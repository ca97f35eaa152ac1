"""One training step on one card (counterpart of
livecell_tpu/parallel/train_step.py: _normalize_batch, make_step_fn; and
of livecell_tpu/train/train_custom.py: build_optimizer).

The step runs the forward with its loss dict, the backward, the global
gradient norm over every parameter and an optimizer update: AdamW under
the reference's per-epoch StepLR schedule (`build_optimizer`, the custom
model) or any other torch optimizer (train/train_transfer.py:
stage_optimizer, the transfer model). The custom model's batch norm
moves its running statistics in the forward. No mesh: one card.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn


def normalize_batch(images: torch.Tensor,
                    targets: Optional[Dict[str, torch.Tensor]]
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """On-device normalization of uint8 batches: images / 255 and mask
    targets / 255; float inputs pass through unchanged."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if targets is not None and targets.get("mask28") is not None \
            and targets["mask28"].dtype == torch.uint8:
        targets = dict(targets, mask28=targets["mask28"].float() / 255.0)
    return images, targets


def build_optimizer(model: nn.Module, lr: float, weight_decay: float,
                    steps_per_epoch: int, step_size: int = 2,
                    gamma: float = 0.1) -> torch.optim.AdamW:
    """optax.adamw (betas 0.9/0.999, eps 1e-8, every parameter decayed)
    with the reference's per-epoch StepLR: the update whose step count
    is t (from 0, as optax counts) uses lr * gamma ** (epoch // step_size)
    with epoch = t // steps_per_epoch. The schedule's settings and the
    step count live in the parameter group, so the optimizer's state
    dict carries them."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    opt.param_groups[0].update(
        base_lr=lr, steps_per_epoch=max(steps_per_epoch, 1),
        lr_step_size=step_size, lr_gamma=gamma, schedule_step=0)
    return opt


def scheduled_lr(group: dict) -> float:
    """The learning rate of the group's next update."""
    epoch = group["schedule_step"] // group["steps_per_epoch"]
    return group["base_lr"] * group["lr_gamma"] ** (
        epoch // group["lr_step_size"])


def apply_update(opt: torch.optim.Optimizer) -> None:
    """One optimizer update from the parameters' .grad, at the scheduled
    learning rate where the group carries build_optimizer's schedule. The
    loss does not reach every parameter (the custom model's FPN computes
    level 0's output conv only): optax decays such a parameter (its Adam
    or momentum term is exactly 0), torch's optimizers skip a parameter
    without a gradient, so it gets a zero one."""
    for g in opt.param_groups:
        for p in g["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if "base_lr" in g:
            g["lr"] = scheduled_lr(g)
    opt.step()
    for g in opt.param_groups:
        if "base_lr" in g:
            g["schedule_step"] += 1


def make_step_fn(model: nn.Module, opt: torch.optim.Optimizer) -> Callable:
    """step(images, targets, noise=None, generator=None, record=None) ->
    metrics {total_loss, grad_norm, loss_*}: scalar tensors left on the
    device, so a loop of steps never waits for the card. The gradient
    norm covers every parameter of the model, also those the optimizer
    leaves frozen (optax.global_norm of all gradients)."""
    params = list(model.parameters())

    def step(images, targets, noise=None, generator=None, record=None):
        images, targets = normalize_batch(images, targets)
        model.train()
        for p in params:
            p.grad = None
        losses = model.train_forward(images, targets, noise=noise,
                                     generator=generator, record=record)
        total = sum(losses.values())
        total.backward()
        # optax.global_norm's sum of squares: torch.linalg.vector_norm on
        # the CPU sums a large f32 tensor with ~4e-4 relative error.
        gnorm = torch.stack([(p.grad * p.grad).sum() for p in params
                             if p.grad is not None]).sum().sqrt()
        apply_update(opt)
        return {"total_loss": total.detach(), "grad_norm": gnorm,
                **{k: v.detach() for k, v in losses.items()}}

    return step
