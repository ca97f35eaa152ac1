"""The reference's training step: the loss of the model's training
forward, its backward, and the optimizer update of the recipe (AdamW,
or SGD with momentum after a clip to a global norm), in plain PyTorch.

`follow` runs the reference over the batches the program's first steps
took, with the program's sampling uniforms (the same generator state),
and returns what the comparison reads: each step's loss, each leaf's
gradient norm at the first step (as the optimizer gets it: after the
clip, before the decay) and each leaf's change after the last step."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


def normalize(images: torch.Tensor, targets: Dict[str, torch.Tensor]):
    """uint8 images and mask targets / 255 (a tensor divisor)."""
    div = torch.full((), 255.0, device=images.device)
    return images.float() / div, dict(targets,
                                      mask28=targets["mask28"].float() / div)


def make_optimizer(model: torch.nn.Module, opt: dict):
    """The recipe's optimizer over every parameter: {"kind": "adamw",
    "lr", "weight_decay"} (betas 0.9/0.999, eps 1e-8) or {"kind": "sgd",
    "lr", "momentum", "weight_decay", "clip_norm"}."""
    params = list(model.parameters())
    if opt["kind"] == "adamw":
        return torch.optim.AdamW(params, lr=opt["lr"], betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=opt["weight_decay"])
    return torch.optim.SGD(params, lr=opt["lr"], momentum=opt["momentum"],
                           weight_decay=opt["weight_decay"])


def follow(model: torch.nn.Module, opt: dict, batches: List[tuple],
           generator: torch.Generator,
           forced: Optional[List[dict]] = None,
           records: Optional[List[dict]] = None) -> Dict:
    """Steps of the recipe over `batches` [(images, targets)], the
    uniforms drawn from `generator`; with `forced`, each step's sampled
    proposals are those given ({"proposals", "proposal_valid"} a step);
    `records`, when given, receives each step's record. Returns {"loss":
    [per step], "terms": [each step's losses by name], "grad": {leaf:
    norm at step 1}, "delta": {leaf: norm of the change after the last
    step}}."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    optim = make_optimizer(model, opt)
    clip = opt.get("clip_norm", 0.0)
    losses, terms, grad = [], [], {}
    model.train()
    for step, (images, targets) in enumerate(batches):
        images, targets = normalize(images, targets)
        for p in params:
            p.grad = None
        rec = {} if records is not None else None
        out = model.train_forward(
            images, targets, generator=generator, record=rec,
            forced=None if forced is None else forced[step])
        if records is not None:
            records.append(rec)
        total = sum(out.values())
        total.backward()
        losses.append(float(total.detach()))
        terms.append({k: float(v.detach()) for k, v in out.items()})
        for p in params:
            if p.grad is None:
                # The loss reaches no such leaf; the optimizer still
                # decays it (optax's rule, which the port keeps).
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            if clip > 0:
                norm = torch.stack([(p.grad * p.grad).sum()
                                    for p in params]).sum().sqrt()
                for p in params:
                    p.grad.copy_(torch.where(norm < clip, p.grad,
                                             p.grad / norm * clip))
            if step == 0:
                grad = {n: float(p.grad.norm()) for n, p in
                        zip(names, params)}
        optim.step()
    delta = {n: float((p.detach() - s).norm())
             for n, p, s in zip(names, params, start)}
    return {"loss": losses, "terms": terms, "grad": grad, "delta": delta}
