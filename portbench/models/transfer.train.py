"""The transfer Mask R-CNN (livecell_tpu_torch/models/transfer.py) under
the training driver: the program's model, the reference's, and the
proposal stage of the timed path held to the reference's.

The proposal stage is the module function the program's step looks up,
`image_proposals`: while the checked steps run it is wrapped, and each
call's inputs (the step's per-level objectness and deltas) and output
are kept. The check hands those inputs, with the reference's anchors,
image size and constants, to the reference's copy of the function and
counts the proposal rows that differ."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from portbench import compare
from portbench.reference import config as ref_config


def program(cfg: Dict, device) -> torch.nn.Module:
    from livecell_tpu_torch.config import config_from_dict
    from livecell_tpu_torch.models.transfer import create_transfer_model

    gen = torch.Generator(device=device).manual_seed(0)
    with torch.device(device):
        return create_transfer_model(config_from_dict(cfg)[1], gen,
                                     device=device, train=True)


def reference(cfg: Dict, device) -> torch.nn.Module:
    from portbench.reference.transfer import TransferMaskRCNN

    with torch.device(device):
        return TransferMaskRCNN(
            ref_config.from_dict(ref_config.TransferConfig, cfg),
            torch.Generator(device=device).manual_seed(0))


def tile_hw(cfg: Dict):
    return cfg["tile_height"], cfg["tile_width"]


@contextlib.contextmanager
def proposals_observed(calls: List[Dict]):
    """Appends each call of the program's proposal stage to `calls`:
    {"objs", "dlts" (per level), "out": (boxes, valid)}."""
    import livecell_tpu_torch.models.transfer as mod

    fn = mod.image_proposals

    def observed(cfg, objs, dlts, anchors, img_hw):
        out = fn(cfg, objs, dlts, anchors, img_hw)
        calls.append({"objs": [o.detach().clone() for o in objs],
                      "dlts": [d.detach().clone() for d in dlts],
                      "out": tuple(x.detach().clone() for x in out)})
        return out

    mod.image_proposals = observed
    try:
        yield
    finally:
        mod.image_proposals = fn


def proposals_differ(call: Dict, rec: Dict, ref: Dict) -> float:
    """Rows of one step's proposals (box or validity) that differ from
    the reference's proposal stage on the same step's RPN outputs; `ref`
    is what the driver's reference returned (its "ref_cfg" and
    "anchors")."""
    from portbench.reference.transfer import image_proposals

    c = ref["ref_cfg"]
    want = image_proposals(c, call["objs"], call["dlts"], ref["anchors"],
                           (c.image_height, c.resized_width))
    return compare.rows_differ(zip(call["out"], want))
