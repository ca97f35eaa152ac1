"""Checkpoints of the port (counterpart of livecell_tpu/train/checkpoint.py).

A checkpoint is a directory:
  model.pt           the model's state dict, floating tensors in f32;
  optimizer.pt       the optimizer's state dict (training checkpoints);
  meta.json          the epoch, the loss and metric history, param_info;
  model_config.json  the model's config and its `model_type`, "custom"
                     (a ModelConfig, the JAX package's sidecar format)
                     or "transfer" (a TransferConfig).
A sidecar without `model_type` (the JAX package's) is custom.
serve/app.py:load_model reads model.pt and the sidecar through
`load_model_state`, so every checkpoint here can be served.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from livecell_tpu_torch.config import config_from_dict, config_to_dict
from livecell_tpu_torch.device import resolve_device


def save(path: str, model, optimizer: Optional[torch.optim.Optimizer] = None,
         epoch: Optional[int] = None, train_losses=None, val_metrics=None,
         param_info: Optional[Dict] = None) -> str:
    """Write a checkpoint directory (created if missing) of a custom or a
    transfer model; returns it."""
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().float().cpu() if v.is_floating_point()
          else v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(path, "model.pt"))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, "optimizer.pt"))
    meta = {"epoch": epoch, "train_losses": train_losses,
            "val_metrics": val_metrics, "param_info": param_info}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({k: v for k, v in meta.items() if v is not None}, f,
                  indent=1)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(config_to_dict(model.cfg), f, indent=1)
    return path


def load_model_state(path: str, device=None
                     ) -> Tuple[str, Any, Dict[str, torch.Tensor]]:
    """(model_type, config, state dict) of a checkpoint: the type and the
    ModelConfig or TransferConfig from its sidecar, the state dict on
    `device` (the card unless the caller passes "cpu")."""
    with open(os.path.join(path, "model_config.json")) as f:
        kind, cfg = config_from_dict(json.load(f))
    sd = torch.load(os.path.join(path, "model.pt"),
                    map_location=resolve_device(device), weights_only=True)
    return kind, cfg, sd


def _load_optimizer_state(path: str, device=None) -> Optional[Dict]:
    """The checkpoint's optimizer state dict on `device`, or None."""
    opt_path = os.path.join(path, "optimizer.pt")
    if not os.path.exists(opt_path):
        return None
    return torch.load(opt_path, map_location=resolve_device(device),
                      weights_only=True)


def _load_meta(path: str) -> Dict:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore(path: str, device=None, model=None, optimizer=None
            ) -> Tuple[Any, Any, Dict]:
    """Resume training: (train model, optimizer or None, meta).

    The weights load strictly into `model`, or, without one, into a model
    built for training as the checkpoint records (create_train_model or
    create_transfer_model(train=True)); a model of the other type raises.
    The optimizer takes the checkpoint's moments and step count
    (`schedule_step`) and keeps its own schedule. Without `optimizer`, a
    custom checkpoint's AdamW is built with the schedule it recorded."""
    from livecell_tpu_torch.config import model_type
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.parallel.train_step import build_optimizer

    kind, cfg, sd = load_model_state(path, device)
    if model is None:
        model = (create_transfer_model(cfg, device=device, train=True)
                 if kind == "transfer" else
                 create_train_model(cfg, device=device))
    elif model_type(model.cfg) != kind:
        raise ValueError(f"{path} holds a {kind} model, not a "
                         f"{model_type(model.cfg)} one")
    model.load_state_dict(sd, strict=True)
    state = _load_optimizer_state(path, device)
    if state is not None and optimizer is None and kind == "custom":
        g = state["param_groups"][0]
        optimizer = build_optimizer(model, g["base_lr"], g["weight_decay"],
                                    g["steps_per_epoch"], g["lr_step_size"],
                                    g["lr_gamma"])
    if state is not None and optimizer is not None:
        schedule = {k: v for k, v in optimizer.param_groups[0].items()
                    if k not in ("params", "schedule_step")}
        optimizer.load_state_dict(state)
        optimizer.param_groups[0].update(schedule)
    return model, optimizer, _load_meta(path)
