"""A torchvision maskrcnn_resnet50_fpn state dict -> the port's transfer
model (counterpart of livecell_tpu/models/torch_import.py).

Both sides are PyTorch, so the conversion is a renaming:
  backbone.body.layer{s}.{j}.conv{K}/bn{K}/downsample.{0,1} ->
    backbone.layer{s}_{j}.conv{K}.conv/.bn, .downsample.conv/.bn;
  backbone.fpn.inner_blocks.{i} / layer_blocks.{i} -> fpn.lateral{i} /
    fpn.output{i} (with or without torchvision >= 0.13's nested `.0`);
  rpn.head.conv -> rpn.conv; rpn.head.cls_logits and bbox_pred are
    stacked into rpn.fused;
  roi_heads.box_head.fc6/fc7 -> box_head.fc6/fc7, fc6's input permuted
    from torchvision's (C, y, x) ROI flatten to the port's (y, x, C);
  roi_heads.box_predictor.* -> box_predictor.*; roi_heads.mask_head.* and
    mask_predictor.* -> mask_head.* (ConvTranspose2d keeps its layout).
The class-count-dependent predictors (box_predictor.*,
mask_predictor.mask_fcn_logits.*) are skipped when their shapes differ
(a 91-class COCO checkpoint into the 2-class model), as the reference
swaps those modules; BN step counters are not imported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# Class-count-dependent targets, skipped on a shape mismatch.
_SWAPPED_PREFIXES = ("box_predictor.", "mask_head.mask_fcn_logits.")
_RPN_FUSED = ("rpn.head.cls_logits.", "rpn.head.bbox_pred.")


def _fc6(w: torch.Tensor, roi: int = 7, ch: int = 256) -> torch.Tensor:
    """[1024, C*r*r] over (C, y, x) -> the same over (y, x, C)."""
    out = w.shape[0]
    return w.reshape(out, ch, roi, roi).permute(0, 2, 3, 1).reshape(out, -1)


def _translate(key: str) -> Optional[str]:
    """torchvision key -> the port's key; None for keys imported
    elsewhere (the RPN predictors) or not at all (step counters). Raises
    KeyError for a key it does not know."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked" or key.startswith(_RPN_FUSED):
        return None
    if key.startswith("backbone.body."):
        rest = parts[2:]
        if rest[0] in ("conv1", "bn1"):
            return f"backbone.{rest[0]}.{leaf}"
        block = f"backbone.{rest[0]}_{rest[1]}"
        if rest[2].startswith("conv"):
            return f"{block}.{rest[2]}.conv.{leaf}"
        if rest[2].startswith("bn"):
            return f"{block}.conv{rest[2][2:]}.bn.{leaf}"
        if rest[2] == "downsample":
            return f"{block}.downsample.{'conv' if rest[3] == '0' else 'bn'}" \
                   f".{leaf}"
    if key.startswith("backbone.fpn."):
        kind = {"inner_blocks": "lateral", "layer_blocks": "output"}[parts[2]]
        return f"fpn.{kind}{parts[3]}.{leaf}"
    if key.startswith("rpn.head.conv."):
        return f"rpn.conv.{leaf}"
    if key.startswith(("roi_heads.box_head.", "roi_heads.box_predictor.")):
        return f"{parts[1]}.{parts[2]}.{leaf}"
    if key.startswith(("roi_heads.mask_head.", "roi_heads.mask_predictor.")):
        return f"mask_head.{parts[2]}.{leaf}"
    raise KeyError(f"unrecognized torchvision key: {key}")


def load_torchvision_weights(model: nn.Module, path_or_sd,
                             strict: bool = False) -> nn.Module:
    """Import a torchvision maskrcnn_resnet50_fpn state dict (a `.pth`
    path or a dict of tensors) into the port's TransferMaskRCNN in place,
    in the model's own dtypes, and return the model. Tensors that do not
    map are left out; strict=True raises on an unknown key or on a shape
    mismatch outside the swapped predictors."""
    sd = path_or_sd
    if not isinstance(sd, dict):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    out = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    skipped = []

    def put(src: str, ours: str, val: torch.Tensor) -> None:
        if ours not in out:
            skipped.append((src, f"no such parameter: {ours}"))
        elif tuple(val.shape) != tuple(out[ours].shape):
            if not ours.startswith(_SWAPPED_PREFIXES):
                skipped.append((src, f"shape {tuple(val.shape)} vs ours "
                                     f"{tuple(out[ours].shape)}"))
        else:
            out[ours] = val.to(out[ours].dtype)

    for key, tensor in sd.items():
        try:
            ours = _translate(key)
        except KeyError:
            if strict:
                raise
            skipped.append((key, "unrecognized key"))
            continue
        if ours is None:
            continue
        val = tensor.detach().cpu().float()
        put(key, ours, _fc6(val) if ours == "box_head.fc6.weight" else val)

    for leaf in ("weight", "bias"):
        src = [sd.get(p + leaf) for p in _RPN_FUSED]
        if all(s is not None for s in src):
            put(_RPN_FUSED[0] + leaf, f"rpn.fused.{leaf}",
                torch.cat([s.detach().cpu().float() for s in src], 0))
    if strict and skipped:
        lines = "\n".join(f"  {k}: {why}" for k, why in skipped[:20])
        raise ValueError(f"{len(skipped)} unconsumed tensors:\n{lines}")
    model.load_state_dict(out, strict=True)
    return model
