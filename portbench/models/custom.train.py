"""The custom Mask R-CNN (livecell_tpu_torch/models/mask_rcnn.py) under
the training driver: the program's model, the reference's, and the
proposal stage of the timed path held to the reference's.

The proposal stage is the module function the program's step looks up,
`training_proposals`: while the checked steps run it is wrapped, and each
call's inputs (the step's objectness and RPN deltas) and output are
kept. The check hands those inputs, with the reference's anchors, image
size, constants and the step's uniforms as the reference drew them, to
the reference's copy of the function and counts the proposal rows that
differ."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from portbench import compare
from portbench.reference import config as ref_config


def program(cfg: Dict, device) -> torch.nn.Module:
    from livecell_tpu_torch.config import config_from_dict
    from livecell_tpu_torch.models.mask_rcnn import create_train_model

    gen = torch.Generator(device=device).manual_seed(0)
    with torch.device(device):
        return create_train_model(config_from_dict(cfg)[1], gen,
                                  device=device)


def reference(cfg: Dict, device) -> torch.nn.Module:
    from portbench.reference.mask_rcnn import CustomMaskRCNN

    with torch.device(device):
        return CustomMaskRCNN(
            ref_config.from_dict(ref_config.ModelConfig, cfg),
            torch.Generator(device=device).manual_seed(0))


def tile_hw(cfg: Dict):
    return cfg["image_height"], cfg["image_width"]


@contextlib.contextmanager
def proposals_observed(calls: List[Dict]):
    """Appends each call of the program's proposal stage to `calls`:
    {"objectness", "deltas", "out": (boxes, valid)}."""
    import livecell_tpu_torch.models.mask_rcnn as mod

    fn = mod.training_proposals

    def observed(*args, **kwargs):
        out = fn(*args, **kwargs)
        deltas = kwargs.get("deltas")
        calls.append({
            "objectness": args[0].detach().clone(),
            "deltas": None if deltas is None else deltas.detach().clone(),
            "out": (out.boxes.detach().clone(), out.valid.clone())})
        return out

    mod.training_proposals = observed
    try:
        yield
    finally:
        mod.training_proposals = fn


def proposals_differ(call: Dict, rec: Dict, ref: Dict) -> float:
    """Rows of one step's proposals (box or validity) that differ from
    the reference's proposal stage on the same step's RPN outputs; `rec`
    is the reference's record of that step, `ref` what the driver's
    reference returned (its "ref_cfg" and "anchors")."""
    from portbench.reference.proposals import training_proposals

    c = ref["ref_cfg"]
    want = training_proposals(
        call["objectness"], ref["anchors"],
        (c.image_height, c.image_width), rec["proposal_noise"],
        c.train_pre_topk, c.train_score_thresh, c.train_min_box_size,
        c.train_num_samples,
        deltas=call["deltas"] if c.decode_proposals else None)
    return compare.rows_differ(zip(call["out"], (want.boxes, want.valid)))
