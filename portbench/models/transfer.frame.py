"""The transfer Mask R-CNN (livecell_tpu_torch/models/transfer.py) under
the frame driver: the program's serving model, the reference's, what is
observed inside the timed path, and how a captured request is judged.

Observed (module functions the model looks up, wrapped for the window;
kept for the sampled requests only): the proposal stage,
`image_proposals`, with its inputs (the RPN's per-level objectness and
deltas) and its proposals; and every call of `nms_iterated` (the
proposal stage's and the detections'), with its inputs and its picks.

The numbers of a request (limits/<workload>.json names those compared):

  rpn_gap           the RPN's outputs on the timed path against the
                    reference's on the same tiles: the larger of the
                    objectness's and the deltas' mean |gap| / mean
                    |reference|;
  proposals_differ  proposal rows in which the timed path's proposals
                    and the reference's proposal stage on the timed
                    path's own RPN outputs part;
  nms_differ        picks in which each observed NMS call and the
                    reference's NMS on the same inputs part;
  stitch_differ     rows of the served answer that differ from the
                    reference's stitch of the same detections;
  unmatched_share   the share of the program's detections with no
                    reference candidate from its own proposal (the
                    reference's refined box at the program's proposal,
                    box IoU 0.99 or more);
  mean_box_gap, mean_score_gap
                    over the matched ones, 1 - IoU and the score gap;
  mask_feat_gap     the mask head's 256-channel features at 28x28 (what
                    its last 1x1 convolution reads: K5 at 14x14, the four
                    3x3 convolutions and the transposed one) of each
                    tile's first MASK_ROWS detections, from the timed
                    path, against the reference's at the same boxes:
                    sum |gap| / sum |reference|;
  mask_gap, mean_mask_gap
                    (not compared) over the detections, the |probability
                    gap| of the served 28x28 mask and the reference's at
                    the detection's own box, summed over the sum of the
                    reference's p (1 - p), and its plain mean. The traffic
                    fills the masks (logits about 2 +- 0.5) so that every
                    seed serves the same amount; there bf16's rounding of
                    the probabilities is most of either.

Over the sampled requests the counts and widest gaps take their
largest, the others their mean."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from portbench import compare
from portbench.drivers import frame
from portbench.reference import config as ref_config
from portbench.reference import lowp
from portbench.reference.boxes import box_iou, clip_boxes, small_box_mask

NUMBERS = ("rpn_gap", "proposals_differ", "nms_differ", "stitch_differ",
           "unmatched_share", "mean_box_gap", "mean_score_gap",
           "mask_feat_gap", "mask_gap", "mean_mask_gap")
# Each tile's first detections whose mask features are kept.
MASK_ROWS = 8
COUNTS = ("proposals_differ", "nms_differ", "stitch_differ")


def program(cfg: Dict, device) -> torch.nn.Module:
    from livecell_tpu_torch.config import config_from_dict
    from livecell_tpu_torch.models.transfer import create_transfer_model

    gen = torch.Generator(device=device).manual_seed(0)
    with torch.device(device):
        return create_transfer_model(config_from_dict(cfg)[1], gen,
                                     device=device)


def reference(cfg: Dict, device) -> torch.nn.Module:
    from portbench.reference.transfer import TransferMaskRCNN

    with torch.device(device):
        return TransferMaskRCNN(
            ref_config.from_dict(ref_config.TransferConfig, cfg),
            torch.Generator(device=device).manual_seed(0))


@contextlib.contextmanager
def observed(s: "frame.Serve"):
    """Wraps the proposal stage and the NMS where the program's model
    looks them up; a captured request's calls go to s.capture_next."""
    import livecell_tpu_torch.models.transfer as mod

    proposals, nms = mod.image_proposals, mod.nms_iterated

    def proposals_(cfg, objs, dlts, anchors, img_hw):
        out = proposals(cfg, objs, dlts, anchors, img_hw)
        if s.capture_next is not None:
            s.capture_next.update(
                rpn=([o.clone() for o in objs], [d.clone() for d in dlts]),
                proposals=tuple(x.clone() for x in out))
        return out

    def nms_(*args, **kwargs):
        out = nms(*args, **kwargs)
        if s.capture_next is not None:
            def kept(v):
                return v.clone() if torch.is_tensor(v) else v
            s.capture_next.setdefault("nms", []).append((
                [kept(a) for a in args],
                {k: kept(v) for k, v in kwargs.items()},
                tuple(x.clone() for x in out)))
        return out

    mod.image_proposals, mod.nms_iterated = proposals_, nms_
    hook = s.model.mask_head.mask_fcn_logits.register_forward_hook(
        _mask_features_into(s.tile_cfg.num_tiles,
                            lambda: s.capture_next))
    try:
        yield
    finally:
        hook.remove()
        mod.image_proposals, mod.nms_iterated = proposals, nms


def _mask_features_into(tiles: int, capture):
    """A forward hook on the mask head's last convolution that keeps the
    features it reads, [tiles, MASK_ROWS, 256, 28, 28], in capture()."""
    def hook(module, inputs, output):
        cap = capture()
        if cap is not None:
            x = inputs[0]
            cap["mask_features"] = x.reshape(
                (tiles, -1) + x.shape[1:])[:, :MASK_ROWS].clone()
    return hook


def images(s: "frame.Serve", f: int, cfg) -> torch.Tensor:
    """The frame's tiles as the predictor feeds them: / 255, padded to
    the model's input tile."""
    x = torch.from_numpy(s.frames[f]).to(s.device).float() / 255.0
    th, tw = s.tile_cfg.tile_height, s.tile_cfg.tile_width
    return F.pad(x, (0, 0, 0, cfg.tile_width - tw, 0, cfg.tile_height - th))


def control_capture(s: "frame.Serve", ctl, f: int) -> Dict:
    """The fp8 reference's request on frame f, as a captured one."""
    rec, cap = {}, {}
    hook = ctl.mask_head.mask_fcn_logits.register_forward_hook(
        _mask_features_into(s.tile_cfg.num_tiles, lambda: cap))
    try:
        det = ctl.inference_forward(images(s, f, ctl.cfg), record=rec)
    finally:
        hook.remove()
    return dict(cap, frame=f, det=det, rpn=(rec["objs"], rec["dlts"]),
                proposals=(rec["proposals"], rec["proposal_valid"]))


def _mean_gap(got, want) -> float:
    got, want = torch.cat([g.float().flatten() for g in got]), \
        torch.cat([w.float().flatten() for w in want])
    return float((got - want).abs().mean() / want.abs().mean()
                 .clamp(min=1e-30))


@torch.no_grad()
def check(s: "frame.Serve", cap: Dict, ref, program: bool) -> Dict:
    """The numbers of one captured request; `program` False for the
    control (no answer, no observed NMS calls)."""
    from portbench.reference.nms import nms_iterated as ref_nms
    from portbench.reference.transfer import (
        _decode_weighted, image_proposals as ref_proposals)

    c = ref.cfg
    det = cap["det"]
    pboxes, pvalid = cap["proposals"]
    n = s.tile_cfg.num_tiles
    if det.boxes.shape[0] != n or pboxes.shape[0] != n:
        return dict.fromkeys(NUMBERS, float("inf"))
    out = {}
    with lowp.exact():
        x = images(s, cap["frame"], c)
        feats = ref.features(x)
        objs, dlts = ref.rpn_outputs(feats)
        anchors = ref.anchors(s.device)
        pobjs, pdlts = cap["rpn"]
        out["rpn_obj_gap"] = _mean_gap(pobjs, objs)
        out["rpn_dlt_gap"] = _mean_gap(pdlts, dlts)
        out["rpn_gap"] = max(out["rpn_obj_gap"], out["rpn_dlt_gap"])
        want = ref_proposals(c, pobjs, pdlts, anchors, ref.img_hw)
        out["proposals_differ"] = compare.rows_differ(
            zip(cap["proposals"], want))
        if program:
            calls = cap.get("nms", [])
            out["nms_differ"] = float(sum(
                (a != b).sum() for args, kwargs, got in calls
                for a, b in zip(got, ref_nms(*args, **kwargs)))) \
                if len(calls) == 2 else float("inf")
        # The reference's scores and refined boxes at the program's
        # proposals.
        rois = ref.ms_roi(feats, pboxes.float(), c.roi_size)
        h = ref.box_head(rois.reshape((-1,) + rois.shape[2:]))
        cls_logits, box_deltas = ref.box_predictor(h)
        p = pboxes.shape[1]
        scores = torch.softmax(cls_logits.reshape(n, p, -1), -1)[..., 1]
        d1 = box_deltas.reshape(n, p, c.num_classes, 4)[:, :, 1]
        refined = clip_boxes(_decode_weighted(
            d1, pboxes.float(), c.box_reg_weights), ref.img_hw)
        sy, sx = ref.scale
        unscale = torch.tensor([1 / sx, 1 / sy, 1 / sx, 1 / sy],
                               device=s.device)
        cand = clip_boxes(refined * unscale, (c.tile_height, c.tile_width))
        # Each detection against the candidate of its own proposal: the
        # one its box overlaps at IoU 0.99 or more, the nearest in score
        # among them.
        dv = det.valid
        iou = box_iou(det.boxes.float(), cand)                 # [T, D, P]
        sgap = (det.scores.float()[:, :, None] - scores[:, None]).abs()
        ok = iou >= 0.99
        sgap = torch.where(ok, sgap, torch.full_like(sgap, 1.0))
        best_s, at = sgap.min(-1)
        best_iou = torch.gather(iou, 2, at[..., None])[..., 0]
        matched = dv & ok.any(-1)
        n_valid = dv.sum().clamp(min=1)
        n_matched = matched.sum().clamp(min=1)
        out["unmatched_share"] = float((dv & ~matched).sum() / n_valid)
        out["mean_box_gap"] = float(torch.where(
            matched, 1.0 - best_iou, torch.zeros_like(best_iou)).sum()
            / n_matched)
        out["mean_score_gap"] = float(torch.where(
            matched, best_s, torch.zeros_like(best_s)).sum() / n_matched)
        # The masks the reference predicts at the detections' own boxes.
        scale = torch.tensor([sx, sy, sx, sy], device=s.device)
        mrois = ref.ms_roi(feats, det.boxes.float() * scale,
                           c.mask_roi_size)
        kept = {}
        hook = ref.mask_head.mask_fcn_logits.register_forward_hook(
            _mask_features_into(n, lambda: kept))
        try:
            ml = ref.mask_head(mrois.reshape((-1,) + mrois.shape[2:]))
        finally:
            hook.remove()
        r = min(MASK_ROWS, dv.shape[1])
        fv = dv[:, :r, None, None, None]
        got = cap["mask_features"].float()
        want = kept["mask_features"]
        out["mask_feat_gap"] = float(
            torch.where(fv, (got - want).abs(), 0.0).sum()
            / torch.where(fv, want.abs(), 0.0).sum().clamp(min=1e-30)) \
            if got.shape == want.shape else float("inf")
        m = c.mask_size
        probs = torch.sigmoid(ml[..., 1].reshape(n, -1, m, m))
        per = (det.mask_probs.float() - probs).abs().mean(dim=(2, 3))
        per = torch.where(dv, per, torch.zeros_like(per))
        slope = torch.where(dv, (probs * (1 - probs)).mean(dim=(2, 3)),
                            torch.zeros_like(per))
        out["mask_gap"] = float(per.sum() / slope.sum().clamp(min=1e-30))
        out["mean_mask_gap"] = float(per.sum() / n_valid)
        # Not compared: the widest of each, how far the reference's masks
        # lie from 0 and 1, and the answer's size.
        out["widest_mask_gap"] = float(per.max())
        out["widest_score_gap"] = float(torch.where(
            matched, best_s, torch.zeros_like(best_s)).max())
        out["mask_spread"] = float(slope.sum() / n_valid)
    if program:
        out["stitch_differ"] = frame.stitch_differs(
            s, cap, (c.tile_height, c.tile_width), c.max_detections)
    out["served"] = float(len(cap["answer"].scores)) if program else 0.0
    out["valid_dets"] = float(det.valid.sum())
    return out
