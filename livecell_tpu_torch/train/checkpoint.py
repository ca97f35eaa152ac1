"""Checkpoints of the port (counterpart of livecell_tpu/train/checkpoint.py).

A checkpoint is a directory:
  model.pt           the model's state dict, floating tensors in f32;
  optimizer.pt       the optimizer's state dict (training checkpoints);
  meta.json          the epoch and the loss history;
  model_config.json  the ModelConfig sidecar, the JAX package's format.
serve/app.py:load_model reads model.pt and the sidecar through
`load_model_state`, so every checkpoint here can be served.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from livecell_tpu_torch.config import (
    ModelConfig, model_config_from_dict, model_config_to_dict)
from livecell_tpu_torch.device import resolve_device


def save(path: str, model, optimizer: Optional[torch.optim.Optimizer] = None,
         epoch: Optional[int] = None, train_losses=None) -> str:
    """Write a checkpoint directory (created if missing); returns it."""
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().float().cpu() if v.is_floating_point()
          else v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(path, "model.pt"))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, "optimizer.pt"))
    meta = {"epoch": epoch, "train_losses": train_losses}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({k: v for k, v in meta.items() if v is not None}, f,
                  indent=1)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(model_config_to_dict(model.cfg), f, indent=1)
    return path


def load_model_state(path: str, device=None
                     ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """The checkpoint's ModelConfig (from the sidecar) and model state
    dict, on `device` (the card unless the caller passes "cpu")."""
    with open(os.path.join(path, "model_config.json")) as f:
        cfg = model_config_from_dict(json.load(f))
    sd = torch.load(os.path.join(path, "model.pt"),
                    map_location=resolve_device(device), weights_only=True)
    return cfg, sd


def restore(path: str, device=None) -> Tuple[Any, Any, Dict]:
    """Resume training: (train model, optimizer or None, meta)."""
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.parallel.train_step import build_optimizer

    cfg, sd = load_model_state(path, device)
    model = create_train_model(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    opt = None
    opt_path = os.path.join(path, "optimizer.pt")
    if os.path.exists(opt_path):
        state = torch.load(opt_path, map_location=resolve_device(device),
                           weights_only=True)
        g = state["param_groups"][0]
        opt = build_optimizer(model, g["base_lr"], g["weight_decay"],
                              g["steps_per_epoch"], g["lr_step_size"],
                              g["lr_gamma"])
        opt.load_state_dict(state)
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return model, opt, meta
