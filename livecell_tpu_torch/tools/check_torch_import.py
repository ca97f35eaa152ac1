"""Validate a torchvision maskrcnn_resnet50_fpn checkpoint through the
port's importer before training on it (counterpart of
scripts/check_torch_import.py).

The translation of every key is covered by the tests against a fake
checkpoint; what a real file can still break is key naming or version
drift and numerics. The strongest available tier wins (reference
src/train_transfer.py:22 pretrained=True):

  1. torchvision present: its backbone+FPN+RPN and the port's run on the
     same 224x304 fixture; every FPN level's and the RPN objectness's
     correlation must be >= 0.99 (the port computes in bf16, so
     elementwise equality is meaningless; correlation is the gate).
  2. without torchvision: the import with strict key mapping (any
     unconsumed checkpoint key raises), then the port's P2-P5 features
     and RPN objectness must be finite with non-degenerate variance, and
     the zero-shot peak objectness on the fixture's blobs > 0.7.

    python -m livecell_tpu_torch.tools.check_torch_import --weights x.pth

The model is TransferConfig(num_classes=91) loaded through
models/torch_import.py:load_torchvision_weights (strict). The gates and
their messages are JAX's; a failed gate raises AssertionError with its
message, and the run exits non-zero. JAX's third tier (no torch: exit 2)
has no counterpart: the port always has torch. Runs on the card;
`main([...], device="cpu")` on the CPU. Returns {"tier", "p2_std",
"objectness_std", "peak_objectness"}.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

from livecell_tpu_torch.config import TransferConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.torch_import import load_torchvision_weights
from livecell_tpu_torch.models.transfer import create_transfer_model


def fixture_image(h: int = 224, w: int = 304) -> np.ndarray:
    """Deterministic high-contrast blobs on grey (JAX's fixture, tile
    shaped so the transfer model's resize matches torchvision's
    800-min-side resize of the same image)."""
    rng = np.random.default_rng(42)
    img = np.full((h, w, 3), 0.4, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(5):
        cy, cx = rng.integers(40, h - 40), rng.integers(40, w - 40)
        ry, rx = rng.integers(15, 35), rng.integers(15, 35)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img[blob] = rng.uniform(0.7, 1.0, 3).astype(np.float32)
    return img


def run_ours(weights: str, img: np.ndarray, device
             ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The port's FPN features P2..P5 ([H, W, C] f32 each) and the
    concatenated RPN objectness logits of the fixture."""
    model = create_transfer_model(TransferConfig(num_classes=91),
                                  torch.Generator().manual_seed(0),
                                  device=device)
    load_torchvision_weights(model, weights, strict=True)
    x = torch.from_numpy(img)[None].to(device)
    with torch.inference_mode():
        feats = model.features(x)
        objs, _ = model.rpn_outputs(feats)
    return ([f[0].permute(1, 2, 0).float().cpu().numpy() for f in feats[:4]],
            torch.cat(objs, dim=1)[0].cpu().numpy())


def gate(feats: List[np.ndarray], obj: np.ndarray) -> float:
    """JAX's tier-2 checks; returns the zero-shot peak objectness."""
    for i, f in enumerate(feats):
        if not np.isfinite(f).all():
            raise AssertionError(f"non-finite P{i + 2} features")
        if not f.std() > 1e-3:
            raise AssertionError(f"degenerate P{i + 2} features")
    if not (np.isfinite(obj).all() and obj.std() > 1e-3):
        raise AssertionError("degenerate RPN objectness")
    # Zero-shot behavior gate (docs/manifests/torchvision_weights.json):
    # genuine COCO weights must fire on at least one high-contrast blob
    # of the fixture; random or tampered tensors with correct shapes
    # pass the variance checks but not this.
    peak = float(1.0 / (1.0 + np.exp(-obj.max())))
    if not peak > 0.7:
        raise AssertionError(
            f"zero-shot RPN peak objectness {peak:.3f} <= 0.7 — weights do "
            "not behave like pretrained COCO weights")
    return peak


def tier1(weights: str, img: np.ndarray, feats: List[np.ndarray],
          obj: np.ndarray, torchvision) -> None:
    """Every FPN level's and the objectness's correlation with
    torchvision's own forward of the file, >= 0.99."""
    tv = torchvision.models.detection.maskrcnn_resnet50_fpn(
        weights=None, weights_backbone=None)
    tv.load_state_dict(
        torch.load(weights, map_location="cpu", weights_only=True))
    tv.eval()
    with torch.no_grad():
        il, _ = tv.transform([torch.from_numpy(img.transpose(2, 0, 1))])
        t_feats = tv.backbone(il.tensors)
        t_obj, _ = tv.rpn.head(list(t_feats.values()))
    for i, name in enumerate(list(t_feats.keys())[:4]):
        ref = t_feats[name][0].numpy().transpose(1, 2, 0)
        ours = feats[i]
        hh, ww = (min(ref.shape[0], ours.shape[0]),
                  min(ref.shape[1], ours.shape[1]))
        corr = float(np.corrcoef(ref[:hh, :ww].ravel(),
                                 ours[:hh, :ww].ravel())[0, 1])
        if not corr >= 0.99:
            raise AssertionError(f"P{i + 2} correlation {corr:.4f} < 0.99")
    ref_obj = np.concatenate(
        [o[0].numpy().transpose(1, 2, 0).ravel() for o in t_obj])
    n = min(len(ref_obj), len(obj))
    corr = float(np.corrcoef(ref_obj[:n], obj[:n])[0, 1])
    if not corr >= 0.99:
        raise AssertionError(f"objectness correlation {corr:.4f} < 0.99")


def main(argv=None, device=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--weights", required=True)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    img = fixture_image()
    feats, obj = run_ours(args.weights, img, dev)
    peak = gate(feats, obj)
    res = {"p2_std": float(feats[0].std()),
           "objectness_std": float(obj.std()), "peak_objectness": peak}
    try:
        import torchvision
    except ImportError:
        print(f"import OK (tier 2): P2 std {feats[0].std():.3f}, "
              f"objectness std {obj.std():.3f}, strict key mapping "
              "passed")
        return dict(res, tier=2)
    tier1(args.weights, img, feats, obj, torchvision)
    print("import OK (tier 1): all FPN levels + RPN objectness "
          "correlate >= 0.99 with torchvision")
    return dict(res, tier=1)


if __name__ == "__main__":
    main()
