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

`load_model_state` and `restore` also open a directory the JAX package's
checkpoint.save wrote (Orbax: `_METADATA`, an OCDBT store of zarr
arrays; train/jax_checkpoint.py), by what the directory holds: model.pt
means the port's format, _METADATA JAX's. A JAX checkpoint serves,
evaluates and resumes like a port one: its optax AdamW moments and step
counts become the port's optimizer state.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from livecell_tpu_torch.config import (
    config_from_dict, config_to_dict, model_type as config_model_type)
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.train import jax_checkpoint


def save(path: str, model, optimizer: Optional[torch.optim.Optimizer] = None,
         epoch: Optional[int] = None, train_losses=None, val_metrics=None,
         param_info: Optional[Dict] = None, mesh=None) -> str:
    """Write a checkpoint directory (created if missing) of a custom or a
    transfer model; returns it. With a mesh (parallel/mesh.py) every rank
    calls it: the sharded tensors are gathered to their full shape
    (mesh.full_state), so the checkpoint loads into the no-mesh model,
    and rank 0 alone writes."""
    if mesh is not None:
        from livecell_tpu_torch.parallel.mesh import full_state

        state, opt_state = full_state(model, mesh, optimizer)
        if not mesh.is_main:
            return path
    else:
        state = model.state_dict()
        opt_state = optimizer.state_dict() if optimizer is not None else None
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().float().cpu() if v.is_floating_point()
          else v.detach().cpu() for k, v in state.items()}
    torch.save(sd, os.path.join(path, "model.pt"))
    if opt_state is not None:
        torch.save(opt_state, os.path.join(path, "optimizer.pt"))
    meta = {"epoch": epoch, "train_losses": train_losses,
            "val_metrics": val_metrics, "param_info": param_info}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({k: v for k, v in meta.items() if v is not None}, f,
                  indent=1)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(config_to_dict(model.cfg), f, indent=1)
    return path


def _is_port(path: str) -> bool:
    """Whether `path` is a port checkpoint (model.pt); raises where it is
    neither a port nor a JAX checkpoint."""
    if os.path.exists(os.path.join(path, "model.pt")):
        return True
    if jax_checkpoint.is_jax_checkpoint(path):
        return False
    raise FileNotFoundError(f"{path} is not a checkpoint: it holds neither "
                            f"model.pt (the port's) nor _METADATA (the JAX "
                            f"package's Orbax checkpoint)")


def load_model_state(path: str, device=None,
                     model_type: Optional[str] = None, fallback=None
                     ) -> Tuple[str, Any, Dict[str, torch.Tensor]]:
    """(model_type, config, state dict) of a checkpoint: the type and the
    ModelConfig or TransferConfig from its sidecar, the state dict on
    `device` (the card unless the caller passes "cpu"). A JAX checkpoint
    without a sidecar (the transfer trainer's) takes the caller's
    `model_type`, or the type its parameter tree shows; a `model_type`
    that disagrees with a JAX checkpoint raises (the caller checks a
    port checkpoint's). Where the directory has no sidecar, `fallback`,
    when given, is its config (the quality tools build it from their
    flags): of a port checkpoint always, of a JAX one where the tree is
    that config's type."""
    has_sidecar = os.path.exists(os.path.join(path, "model_config.json"))
    if not _is_port(path):
        kind, cfg, sd = jax_checkpoint.model_state(path, device, model_type)
        if fallback is not None and not has_sidecar \
                and config_model_type(fallback) == kind:
            cfg = fallback
        return kind, cfg, sd
    if has_sidecar or fallback is None:
        with open(os.path.join(path, "model_config.json")) as f:
            kind, cfg = config_from_dict(json.load(f))
    else:
        kind, cfg = config_model_type(fallback), fallback
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
    custom checkpoint's AdamW is built with the schedule it recorded.

    A JAX custom checkpoint resumes as JAX's `--resume` does: optax's
    adamw moments and counts become the optimizer's (jax_checkpoint.
    adamw_state). It records no schedule, so its moments need the
    caller's `optimizer`; without one they raise. A JAX transfer
    checkpoint holds no optimizer state."""
    from livecell_tpu_torch.config import model_type
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.models.transfer import create_transfer_model
    from livecell_tpu_torch.parallel.train_step import build_optimizer

    payload = None
    if _is_port(path):
        kind, cfg, sd = load_model_state(path, device)
    else:
        payload = jax_checkpoint.load(path)
        kind, cfg, sd = jax_checkpoint.model_state(
            path, device, model_type(model.cfg) if model is not None
            else None, payload)
    if model is None:
        model = (create_transfer_model(cfg, device=device, train=True)
                 if kind == "transfer" else
                 create_train_model(cfg, device=device))
    elif model_type(model.cfg) != kind:
        raise ValueError(f"{path} holds a {kind} model, not a "
                         f"{model_type(model.cfg)} one")
    model.load_state_dict(sd, strict=True)
    if payload is not None:
        opt_state = payload.get("opt_state")
        if opt_state is not None:
            if optimizer is None:
                raise ValueError(
                    f"{path} is a JAX checkpoint with optimizer state but "
                    f"no schedule: pass the optimizer to resume it "
                    f"(parallel/train_step.py:build_optimizer)")
            optimizer.load_state_dict(jax_checkpoint.adamw_state(
                opt_state, model, optimizer))
        return model, optimizer, payload["meta"]
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
