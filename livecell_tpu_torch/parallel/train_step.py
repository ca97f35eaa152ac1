"""One training step on one card, and the batched inference step of an
evaluation (counterpart of livecell_tpu/parallel/train_step.py:
_normalize_batch, make_step_fn, make_eval_step; and of
livecell_tpu/train/train_custom.py: build_optimizer).

The step runs the forward with its loss dict, the backward, the global
gradient norm over every parameter and an optimizer update: AdamW under
the reference's per-epoch StepLR schedule (`build_optimizer`, the custom
model) or any other torch optimizer (train/train_transfer.py:
stage_optimizer, the transfer model). The custom model's batch norm
moves its running statistics in the forward.

With a mesh (parallel/mesh.py) the step is the no-mesh step on the
global batch, as JAX's sharded step is: each rank takes its rows, the
model is laid out by mesh.shard_model (batch norm over the global
batch, the losses over the global normalizers, the box head sharded
over the model axis), the sampling noise is drawn for the global batch
from the step's generator and each rank keeps its rows, DDP reduces the
gradients over the data axis (the loss is scaled by its size, which DDP
divides by), and the gradient norm and the metrics are the global ones.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.parallel.mesh import param_spec, shard_model
from livecell_tpu_torch.utils.profiling import span


def normalize_batch(images: torch.Tensor,
                    targets: Optional[Dict[str, torch.Tensor]]
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """On-device normalization of uint8 batches: images / 255 and mask
    targets / 255; float inputs pass through unchanged. The divisor is a
    tensor: PyTorch divides by a Python scalar as a multiplication by its
    reciprocal, JAX divides."""
    if images.dtype == torch.uint8:
        images = images.float() / torch.full((), 255.0,
                                             device=images.device)
    if targets is not None and targets.get("mask28") is not None \
            and targets["mask28"].dtype == torch.uint8:
        m = targets["mask28"]
        targets = dict(targets, mask28=m.float() / torch.full(
            (), 255.0, device=m.device))
    return images, targets


def make_eval_step(model: nn.Module, device=None, mesh=None) -> Callable:
    """step(images) -> Detections: a batch (uint8 [B, H, W, 3] or float
    in [0, 1], numpy or tensor) on `device` (the card unless the caller
    passes "cpu"), normalized as normalize_batch does and run through the
    model's inference forward in eval mode without gradients. Works for
    the custom and the transfer model alike.

    With a mesh the batch is padded to a multiple of the data axis, each
    rank runs its rows (the model laid out by mesh.shard_model) and the
    detections are gathered over the data axis: every rank returns the
    whole batch's."""
    dev = resolve_device(device)
    if mesh is not None:
        shard_model(model, mesh)

    def step(images):
        images, _ = normalize_batch(torch.as_tensor(images, device=dev),
                                    None)
        model.eval()
        if mesh is None:
            with torch.no_grad():
                return model.inference_forward(images)
        b = images.shape[0]
        pad = -b % mesh.data_size
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad,) + images.shape[1:])])
        with torch.no_grad():
            det = model.inference_forward(images[mesh.rows(b + pad)])
        return type(det)(*(mesh.data.gather(t)[:b] for t in det))

    return step


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


def _global_rows(model, mesh, b: int, device, generator, noise):
    """This rank's rows of the global batch's sampling noise: drawn
    for all size * b images from `generator` (every rank draws the same)
    unless given, then sliced. A draw of one image's rows (quirk mode)
    is everybody's."""
    n = b * mesh.data_size
    if noise is None:
        noise = model.sampling_noise(n, device, generator)
    rows = mesh.rows(n)
    return {k: v[rows] if v.shape[0] == n else v for k, v in noise.items()}


def make_step_fn(model: nn.Module, opt: torch.optim.Optimizer,
                 mesh=None) -> Callable:
    """step(images, targets, noise=None, generator=None, record=None) ->
    metrics {total_loss, grad_norm, loss_*}: scalar tensors left on the
    device, so a loop of steps never waits for the card. The gradient
    norm covers every parameter of the model, also those the optimizer
    leaves frozen (optax.global_norm of all gradients).

    With a mesh, images and targets are this rank's rows of the global
    batch and `noise`, when given, the global batch's; the metrics are
    the global batch's on every rank.

    Each call runs under the span livecell.step (utils/profiling.span,
    recorded while a profiler records) with the step function's call
    number, the model's stage spans inside it, then livecell.backward
    and livecell.update (gradient norm and optimizer)."""
    if mesh is not None:
        return _make_mesh_step(model, opt, mesh)
    params = list(model.parameters())
    count = itertools.count()

    def step(images, targets, noise=None, generator=None, record=None):
        with span("livecell.step", next(count)):
            images, targets = normalize_batch(images, targets)
            model.train()
            for p in params:
                p.grad = None
            losses = model.train_forward(images, targets, noise=noise,
                                         generator=generator, record=record)
            total = sum(losses.values())
            with span("livecell.backward"):
                total.backward()
            with span("livecell.update"):
                # optax.global_norm's sum of squares:
                # torch.linalg.vector_norm on the CPU sums a large f32
                # tensor with ~4e-4 relative error.
                gnorm = torch.stack([(p.grad * p.grad).sum() for p in params
                                     if p.grad is not None]).sum().sqrt()
                apply_update(opt)
        return {"total_loss": total.detach(), "grad_norm": gnorm,
                **{k: v.detach() for k, v in losses.items()}}

    return step


def _make_mesh_step(model: nn.Module, opt: torch.optim.Optimizer,
                    mesh) -> Callable:
    shard_model(model, mesh, opt)
    forward = mesh.train_forward(model)
    params = list(model.parameters())
    sharded = [p for n, p in model.named_parameters()
               if mesh.model_size > 1 and "model" in param_spec(n)]
    sharded_ids = {id(p) for p in sharded}
    count = itertools.count()

    def step(images, targets, noise=None, generator=None, record=None):
        with span("livecell.step", next(count)):
            images, targets = normalize_batch(images, targets)
            model.train()
            for p in params:
                p.grad = None
            noise = _global_rows(model, mesh, images.shape[0],
                                 images.device, generator, noise)
            losses = forward(images, targets, noise=noise, record=record)
            total = sum(losses.values())
            with span("livecell.backward"):
                # DDP averages the data ranks' gradients; each rank's
                # losses are its share of the global batch's, whose
                # gradient is their sum.
                (total * mesh.data_size).backward()
            with span("livecell.update"):
                # The squares of a sharded parameter's slices summed over
                # the model axis, a replicated parameter's counted once.
                sq = [(p.grad * p.grad).sum() for p in params
                      if p.grad is not None and id(p) not in sharded_ids]
                if sharded:
                    part = torch.stack([(p.grad * p.grad).sum()
                                        for p in sharded
                                        if p.grad is not None]).sum()
                    dist.all_reduce(part, group=mesh.model_group)
                    sq.append(part)
                gnorm = torch.stack(sq).sum().sqrt()
                apply_update(opt)
            names = list(losses)
            glob = torch.stack([losses[k].detach() for k in names])
            dist.all_reduce(glob, group=mesh.data.group)
        losses = {k: glob[i] for i, k in enumerate(names)}
        return {"total_loss": sum(losses.values()), "grad_norm": gnorm,
                **losses}

    return step
