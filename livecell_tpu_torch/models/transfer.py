"""Transfer Mask R-CNN: torchvision maskrcnn_resnet50_fpn with 2-class
predictors (counterpart of livecell_tpu/models/transfer.py).

ImageNet normalization and a bilinear resize of the tile to the 800-scale
canvas, a ResNet-50 FPN with P6, an RPN over five levels (one anchor size
per level, 3 ratios), per-level top-k and NMS with fixed slots, RoI heads
with torchvision's matching and sampling rules, and MultiScaleRoIAlign
through K5/K6 (ops/cuda_ms_roi_align.py). Everything is batched over the
images where the JAX model vmaps per image, with the same static slot
counts and validity masks.

Batch norm normalizes with its running statistics in every mode and
never moves them (torchvision's FrozenBatchNorm2d, transfer.py:458-464).
Training keeps f32 parameters and computes the convolutions and matmuls
in the compute dtype under autocast; the step's random draws are
explicit uniforms (`sampling_noise`). Module names mirror the JAX
parameter tree (backbone, fpn, rpn, box_head/fc6..., box_predictor,
mask_head/mask_fcn1..., conv5_mask, mask_fcn_logits).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from livecell_tpu_torch.config import TransferConfig
from livecell_tpu_torch.device import constant, resolve_device
from livecell_tpu_torch.models.detector import (
    Detections, local_count, bce_with_logits, smooth_l1)
from livecell_tpu_torch.models.fpn import FPN
from livecell_tpu_torch.models.init import (
    kaiming_normal_fan_out, normal_std, torch_default_bias,
    torch_default_kernel, zeros)
from livecell_tpu_torch.models.resnet import BatchNorm, ResNetBackbone
from livecell_tpu_torch.models.rpn import RPNHead
from livecell_tpu_torch.ops.boxes import (
    box_iou, clip_boxes, decode_boxes, small_box_mask)
from livecell_tpu_torch.ops.cuda_match import (
    match_anchors, match_anchors_plain)
from livecell_tpu_torch.ops.cuda_ms_roi_align import ms_roi_align
from livecell_tpu_torch.ops.mask_ops import reproject_mask28, resize_bilinear
from livecell_tpu_torch.ops.nms import nms_fixed, nms_iterated
from livecell_tpu_torch.ops.proposals import (
    sample_rows, take_rows, top_k_stable)
from livecell_tpu_torch.utils.profiling import span

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Static geometry (numpy).
# ---------------------------------------------------------------------------
def _ceil2(n: int) -> int:
    return (n + 1) // 2


@functools.lru_cache(maxsize=8)
def pyramid_shapes(h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    """Feature shapes of P2..P6 for an (h, w) canvas: every downsample of
    the R50-FPN stack computes ceil(n/2)."""
    ph, pw = _ceil2(_ceil2(h)), _ceil2(_ceil2(w))     # stem, max-pool
    shapes = [(ph, pw)]
    for _ in range(3):
        ph, pw = _ceil2(ph), _ceil2(pw)
        shapes.append((ph, pw))
    shapes.append((_ceil2(ph), _ceil2(pw)))           # P6
    return tuple(shapes)


@functools.lru_cache(maxsize=8)
def torchvision_anchors(shapes: Tuple[Tuple[int, int], ...],
                        sizes: Tuple[int, ...], ratios: Tuple[float, ...],
                        strides: Tuple[int, ...]) -> Tuple[np.ndarray, ...]:
    """Per-level anchors in torchvision's convention (w = size/sqrt(r),
    h = size*sqrt(r), rounded, centered at (x*stride, y*stride)),
    flattened (y, x, anchor): a tuple of [A_l, 4] float32. The cached
    arrays are shared; do not write to them."""
    out = []
    h_r = np.sqrt(np.asarray(ratios, np.float64))
    w_r = 1.0 / h_r
    for (h, w), size, stride in zip(shapes, sizes, strides):
        ws, hs = size * w_r, size * h_r
        base = np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0)
        sy, sx = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride,
                             indexing="ij")
        shift = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        out.append((shift + base[None]).reshape(-1, 4).astype(np.float32))
    return tuple(out)


def _encode_weighted(boxes: torch.Tensor, anchors: torch.Tensor,
                     weights: Tuple[float, ...]) -> torch.Tensor:
    """torchvision BoxCoder.encode, [..., 4]: weighted (dx, dy, dw, dh),
    sizes floored at 1e-6."""
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=1e-6)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=1e-6)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    bw = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)
    bx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    by = (boxes[..., 1] + boxes[..., 3]) * 0.5
    wx, wy, ww, wh = weights
    return torch.stack([wx * (bx - ax) / aw, wy * (by - ay) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)],
                       dim=-1)


def _decode_weighted(deltas: torch.Tensor, boxes: torch.Tensor,
                     weights: Tuple[float, ...]) -> torch.Tensor:
    return decode_boxes(deltas / constant(tuple(weights), deltas.device),
                        boxes)


# ---------------------------------------------------------------------------
# Heads.
# ---------------------------------------------------------------------------
class TwoMLPHead(nn.Module):
    """torchvision TwoMLPHead: flatten (y, x, c)-major -> fc6 -> fc7."""

    def __init__(self, in_features: int, generator: torch.Generator):
        super().__init__()
        self.fc6 = nn.Linear(in_features, 1024)
        self.fc7 = nn.Linear(1024, 1024)
        for fc, fan_in in ((self.fc6, in_features), (self.fc7, 1024)):
            torch_default_kernel(fc.weight, fan_in, generator)
            torch_default_bias(fc.bias, fan_in, generator)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = rois.reshape(rois.shape[0], -1).to(self.fc6.weight.dtype)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class BoxPredictor(nn.Module):
    """torchvision FastRCNNPredictor with num_classes outputs."""

    def __init__(self, num_classes: int, generator: torch.Generator):
        super().__init__()
        self.cls_score = nn.Linear(1024, num_classes)
        self.bbox_pred = nn.Linear(1024, 4 * num_classes)
        normal_std(self.cls_score.weight, 0.01, generator)
        normal_std(self.bbox_pred.weight, 0.001, generator)
        zeros(self.cls_score.bias)
        zeros(self.bbox_pred.bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class TransferMaskHead(nn.Module):
    """torchvision MaskRCNNHeads (4x conv3x3 + ReLU) and
    MaskRCNNPredictor (2x2/2 transposed conv + ReLU, 1x1 logits)."""

    def __init__(self, num_classes: int, generator: torch.Generator):
        super().__init__()
        for i in range(1, 5):
            conv = nn.Conv2d(256, 256, 3, padding=1)
            kaiming_normal_fan_out(conv.weight, 9 * 256, generator)
            zeros(conv.bias)
            self.add_module(f"mask_fcn{i}", conv)
        self.conv5_mask = nn.ConvTranspose2d(256, 256, 2, stride=2)
        kaiming_normal_fan_out(self.conv5_mask.weight, 4 * 256, generator)
        zeros(self.conv5_mask.bias)
        self.mask_fcn_logits = nn.Conv2d(256, num_classes, 1)
        kaiming_normal_fan_out(self.mask_fcn_logits.weight, num_classes,
                               generator)
        zeros(self.mask_fcn_logits.bias)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        """[K, 14, 14, 256] -> mask logits [K, 28, 28, num_classes], f32."""
        x = rois.to(self.mask_fcn1.weight.dtype).permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x).float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Proposals and targets, batched over images.
# ---------------------------------------------------------------------------
def image_proposals(cfg: TransferConfig, objs: List[torch.Tensor],
                    dlts: List[torch.Tensor], anchors: List[torch.Tensor],
                    img_hw: Tuple[int, int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchvision RegionProposalNetwork.filter_proposals: per level,
    top-k of the sigmoid scores -> decode -> clip -> min-size -> NMS;
    then the global top rpn_post_nms. objs [B, A_l], dlts [B, A_l, 4]
    per level -> (boxes [B, P, 4], valid [B, P]).

    The levels' candidates are padded to one width with invalid rows and
    suppressed in one batched NMS; a padded row is never picked and
    never suppresses, so each level's first min(k_l, post_nms) picks are
    those of its own NMS."""
    ks = [min(cfg.rpn_pre_topk_per_level, a.shape[0]) for a in anchors]
    kmax = max(ks)
    boxes, scores, valid = [], [], []
    for obj, dlt, anch, k in zip(objs, dlts, anchors, ks):
        s, idx = top_k_stable(torch.sigmoid(obj), k)
        bx = clip_boxes(decode_boxes(take_rows(dlt, idx), anch[idx]), img_hw)
        pad = kmax - k
        boxes.append(F.pad(bx, (0, 0, 0, pad)))
        scores.append(F.pad(s, (0, pad)))
        valid.append(F.pad(small_box_mask(bx, cfg.rpn_min_size), (0, pad)))
    boxes, scores, valid = (torch.stack(x, 1) for x in (boxes, scores, valid))
    nms = nms_iterated if cfg.rpn_nms_mode == "sweep" else nms_fixed
    keep = min(kmax, cfg.rpn_post_nms)
    kidx, kval = nms(boxes, scores, cfg.rpn_nms_thresh, keep, valid=valid)
    cand_b, cand_s = [], []
    for lvl, k in enumerate(ks):
        i, v = kidx[:, lvl, :min(k, cfg.rpn_post_nms)], \
            kval[:, lvl, :min(k, cfg.rpn_post_nms)]
        s = torch.gather(scores[:, lvl], 1, i)
        cand_b.append(take_rows(boxes[:, lvl], i))
        cand_s.append(torch.where(v, s, torch.full_like(s, -1.0)))
    cand_b, cand_s = torch.cat(cand_b, 1), torch.cat(cand_s, 1)
    top, idx = top_k_stable(cand_s, min(cfg.rpn_post_nms, cand_s.shape[1]))
    return take_rows(cand_b, idx), top > 0.0


def rpn_targets_from_match(cfg: TransferConfig, anchors: torch.Tensor,
                           max_iou: torch.Tensor, tgt_planar: torch.Tensor,
                           best_anchor: torch.Tensor, gt_boxes: torch.Tensor,
                           gt_valid: torch.Tensor, u_fg: torch.Tensor,
                           u_bg: torch.Tensor):
    """torchvision RPN matching and 256 @ 50% sampling from K4's outputs
    (max_iou [B,A], tgt_planar [B,4,A], best_anchor [B,I]) with each
    valid GT's first best anchor as a low-quality match. u_fg/u_bg [B,A]
    rank the candidates. Returns (rows, rval, labels, fi, fv, reg_t)."""
    fg = max_iou >= cfg.rpn_fg_iou
    ba = anchors[best_anchor]                                  # [B, I, 4]
    iw = (torch.minimum(ba[..., 2], gt_boxes[..., 2]) -
          torch.maximum(ba[..., 0], gt_boxes[..., 0])).clamp(min=0.0)
    ih = (torch.minimum(ba[..., 3], gt_boxes[..., 3]) -
          torch.maximum(ba[..., 1], gt_boxes[..., 1])).clamp(min=0.0)
    lq_ok = gt_valid & (iw * ih > 0.0)
    # Two GT may share a best anchor: a scatter with max, as .at[].max.
    forced = torch.zeros_like(max_iou, dtype=torch.int32).scatter_reduce(
        1, best_anchor, lq_ok.to(torch.int32), "amax")
    fg = fg | (forced > 0)
    bg = (max_iou < cfg.rpn_bg_iou) & ~fg
    fi, fv = sample_rows(u_fg, fg, cfg.rpn_pos)
    bi, bv = sample_rows(u_bg, bg, cfg.rpn_batch - cfg.rpn_pos)
    rows = torch.cat([fi, bi], 1)
    rval = torch.cat([fv, bv], 1)
    labels = torch.cat([fv.float(), torch.zeros_like(bv, dtype=torch.float32)],
                       1)
    reg_t = torch.gather(tgt_planar, 2, fi[:, None].expand(-1, 4, -1))
    return rows, rval, labels, fi, fv, reg_t.transpose(1, 2)


def box_targets(cfg: TransferConfig, prop_boxes: torch.Tensor,
                prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, u_fg: torch.Tensor,
                u_bg: torch.Tensor):
    """torchvision RoIHeads: the GT appended to the proposals, matched at
    IoU box_fg_iou, box_batch sampled at box_pos_fraction positive
    (fixed fg/bg slots). u_fg/u_bg [B, P+I] rank the candidates. Returns
    (sampled, rval, labels, matched_gt, reg_t, fv)."""
    boxes = torch.cat([prop_boxes, gt_boxes], 1)
    valid = torch.cat([prop_valid, gt_valid], 1)
    iou = box_iou(boxes, gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best, gidx = iou.amax(-1), iou.argmax(-1)
    fg = (best >= cfg.box_fg_iou) & valid
    bg = (best < cfg.box_fg_iou) & valid
    fi, fv = sample_rows(u_fg, fg, cfg.box_pos)
    bi, bv = sample_rows(u_bg, bg, cfg.box_batch - cfg.box_pos)
    rows = torch.cat([fi, bi], 1)
    rval = torch.cat([fv, bv], 1)
    labels = torch.cat([fv.long(), torch.zeros_like(bv, dtype=torch.long)], 1)
    sampled = take_rows(boxes, rows)
    matched_gt = torch.gather(gidx, 1, rows)
    reg_t = _encode_weighted(take_rows(gt_boxes, matched_gt), sampled,
                             cfg.box_reg_weights)
    return sampled, rval, labels, matched_gt, reg_t, fv


# ---------------------------------------------------------------------------
class TransferMaskRCNN(nn.Module):
    """The assembled detector. Images [B, th, tw, 3] in [0, 1] (the input
    tile); train_forward -> torchvision's loss dict, inference_forward ->
    Detections in tile coordinates. `data_axis` (parallel/mesh.py:
    shard_model) makes the losses' normalizers the global batch's."""

    data_axis = None

    def __init__(self, cfg: TransferConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.backbone = ResNetBackbone(g, depths=(3, 4, 6, 3),
                                       widths=(64, 128, 256, 512),
                                       bottleneck=True)
        self.fpn = FPN((256, 512, 1024, 2048), 256, g, relu_outputs=False,
                       extra_maxpool=True)
        self.rpn = RPNHead(256, len(c.anchor_ratios), g)
        self.box_head = TwoMLPHead(256 * c.roi_size * c.roi_size, g)
        self.box_predictor = BoxPredictor(c.num_classes, g)
        self.mask_head = TransferMaskHead(c.num_classes, g)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.frozen = True
        self._anchor_cache: Dict[torch.device, List[torch.Tensor]] = {}

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    @property
    def img_hw(self) -> Tuple[int, int]:
        """The resized (unpadded) canvas, which proposals are clipped to."""
        return self.cfg.image_height, self.cfg.resized_width

    @property
    def scale(self) -> Tuple[float, float]:
        """(y, x) scale from the input tile to the canvas."""
        c = self.cfg
        return (c.image_height / c.tile_height,
                c.resized_width / c.tile_width)

    def anchors(self, device: torch.device) -> List[torch.Tensor]:
        """Per-level [A_l, 4] f32 anchors, cached per device."""
        if device not in self._anchor_cache:
            c = self.cfg
            levels = torchvision_anchors(
                pyramid_shapes(c.image_height, c.image_width),
                c.anchor_sizes, c.anchor_ratios, c.level_strides)
            self._anchor_cache[device] = [torch.from_numpy(a).to(device)
                                          for a in levels]
        return self._anchor_cache[device]

    def transform(self, images: torch.Tensor) -> torch.Tensor:
        """GeneralizedRCNNTransform: ImageNet-normalize, resize the tile
        to the canvas (bilinear, f32), zero-pad the width. NHWC f32."""
        c = self.cfg
        mean = constant(_MEAN, images.device)
        std = constant(_STD, images.device)
        x = resize_bilinear((images.float() - mean) / std,
                            (c.image_height, c.resized_width))
        return F.pad(x, (0, 0, 0, c.image_width - c.resized_width))

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, th, tw, 3] -> P2..P6, NCHW on channels_last memory."""
        x = self.transform(images).to(self.compute_dtype).permute(0, 3, 1, 2)
        return self.fpn(self.backbone(x))

    def rpn_outputs(self, feats) -> Tuple[List[torch.Tensor], ...]:
        cls_out, box_out = self.rpn(feats)
        b = cls_out[0].shape[0]
        return ([o.reshape(b, -1).float() for o in cls_out],
                [d.reshape(b, -1, 4).float() for d in box_out])

    def ms_roi(self, feats, boxes: torch.Tensor, out_size: int
               ) -> torch.Tensor:
        """MultiScaleRoIAlign of [B, K, 4] boxes over P2..P5 (NCHW in,
        NHWC to the kernels) under cfg.roi_backend."""
        nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]
        return ms_roi_align(nhwc, boxes, out_size, 2,
                            backend=self.cfg.roi_backend)

    def match(self, anchors: torch.Tensor, gt_boxes: torch.Tensor,
              gt_valid: torch.Tensor):
        """K4, full, under cfg.rpn_match_backend ("auto": the kernel on
        CUDA tensors, its plain version on CPU tensors)."""
        backend = self.cfg.rpn_match_backend
        if backend == "plain":
            return match_anchors_plain(anchors, gt_boxes, gt_valid, True)
        if backend == "kernel" and gt_boxes.device.type != "cuda":
            raise ValueError("rpn_match_backend='kernel' needs CUDA tensors")
        return match_anchors(anchors, gt_boxes.contiguous(),
                             gt_valid.contiguous(), True)

    def proposal_count(self) -> int:
        c = self.cfg
        shapes = pyramid_shapes(c.image_height, c.image_width)
        per = [min(c.rpn_pre_topk_per_level, h * w * len(c.anchor_ratios),
                   c.rpn_post_nms) for h, w in shapes]
        return min(c.rpn_post_nms, sum(per))

    def sampling_noise(self, b: int, device,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """The uniforms of one training step of a batch of b, from
        `generator` (on `device`): [B, A] ranking the RPN's positive and
        negative candidates, [B, P + I] ranking the box head's."""
        c = self.cfg
        a = sum(x.shape[0] for x in self.anchors(torch.device(device)))
        p = self.proposal_count() + c.max_instances

        def draw(n):
            return torch.rand((b, n), generator=generator, device=device)

        return {"rpn_fg": draw(a), "rpn_bg": draw(a),
                "box_fg": draw(p), "box_bg": draw(p)}

    # -- training ----------------------------------------------------------
    def train_forward(self, images: torch.Tensor,
                      targets: Dict[str, torch.Tensor],
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      record: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """images [B, th, tw, 3] in [0, 1], targets {boxes [B,I,4] in tile
        coordinates, valid [B,I], mask28 [B,I,28,28] in [0, 1]} -> the
        five losses (f32 scalars, torchvision's names). `noise` holds the
        step's uniforms (`sampling_noise`), drawn from `generator` when
        None. `record`, when given, receives the sampled RPN rows, the
        proposals and the sampled box-head rows."""
        b, dev = images.shape[0], images.device
        if noise is None:
            noise = self.sampling_noise(b, dev, generator)
        on = self.compute_dtype != torch.float32
        with torch.autocast(dev.type, dtype=self.compute_dtype, enabled=on):
            return self._train_forward(images, targets, noise, record)

    def _train_forward(self, images, targets, noise, record):
        c = self.cfg
        with span("livecell.features"):
            feats = self.features(images)
        with span("livecell.rpn"):
            objs, dlts = self.rpn_outputs(feats)
            anchors = self.anchors(images.device)
            anchors_cat = torch.cat(anchors, 0)
            sy, sx = self.scale
            gt_boxes = targets["boxes"].float() * torch.tensor(
                [sx, sy, sx, sy], dtype=torch.float32, device=images.device)
            gt_valid = targets["valid"].bool()
            gt_mask28 = targets["mask28"].float()
            obj_cat = torch.cat(objs, 1)                       # [B, A]
            dlt_cat = torch.cat(dlts, 1)                       # [B, A, 4]

            max_iou, tgt, best = self.match(anchors_cat, gt_boxes, gt_valid)
            rows, rval, rlabels, fi, fv, rpn_reg_t = rpn_targets_from_match(
                c, anchors_cat, max_iou, tgt, best, gt_boxes, gt_valid,
                noise["rpn_fg"], noise["rpn_bg"])
            obj_s = torch.gather(obj_cat, 1, rows)
            rpn_reg_p = take_rows(dlt_cat, fi)
        with span("livecell.proposals"):
            # Proposals from detached scores (torchvision detaches them).
            pboxes, pvalid = image_proposals(
                c, [o.detach() for o in objs], [d.detach() for d in dlts],
                anchors, self.img_hw)
            sampled, sval, labels, matched_gt, reg_t, fgv = box_targets(
                c, pboxes, pvalid, gt_boxes, gt_valid, noise["box_fg"],
                noise["box_bg"])
            ms = c.mask_slots
            mb, mgt = sampled[:, :ms], matched_gt[:, :ms]
            src = take_rows(
                gt_mask28.reshape(gt_mask28.shape[:2] + (-1,)), mgt)
            mtargets = reproject_mask28(
                src.reshape(src.shape[:2] + gt_mask28.shape[2:]),
                take_rows(gt_boxes, mgt), mb)
            mvalid = fgv[:, :ms]
            if record is not None:
                record.update(rpn_rows=rows, rpn_valid=rval,
                              proposals=pboxes, proposal_valid=pvalid,
                              box_rows=sampled, box_valid=sval)
        with span("livecell.heads"):
            box_rois = self.ms_roi(feats, sampled, c.roi_size)
            mrois = self.ms_roi(feats, mb, c.mask_roi_size)
        with span("livecell.rpn"):
            # RPN losses, normalized by the sampled count like torchvision.
            count = local_count if self.data_axis is None \
                else self.data_axis.count
            rval_f = rval.float()
            n_sampled = count(rval_f.sum()).clamp(min=1.0)
            loss_obj = (bce_with_logits(obj_s, rlabels) * rval_f).sum() \
                / n_sampled
            reg = smooth_l1(rpn_reg_p.reshape(-1, 4),
                            rpn_reg_t.reshape(-1, 4), beta=1.0 / 9).sum(-1)
            loss_rpn_reg = (reg * fv.reshape(-1).float()).sum() / n_sampled
        with span("livecell.heads"):
            # Box head over all images' sampled ROIs.
            h = self.box_head(box_rois.reshape((-1,) + box_rois.shape[2:]))
            cls_logits, box_deltas = self.box_predictor(h)
            flat_labels = labels.reshape(-1)
            flat_sval = sval.reshape(-1).float()
            n_box = count(flat_sval.sum()).clamp(min=1.0)
            logp = F.log_softmax(cls_logits, dim=-1)
            ce = -torch.gather(logp, 1, flat_labels[:, None])[:, 0]
            loss_cls = (ce * flat_sval).sum() / n_box
            d1 = box_deltas.reshape(-1, c.num_classes, 4)[:, 1]
            reg = smooth_l1(d1, reg_t.reshape(-1, 4), beta=1.0 / 9).sum(-1)
            fg_flat = ((flat_labels > 0) & (flat_sval > 0)).float()
            loss_reg = (reg * fg_flat).sum() / n_box

            # Mask loss: BCE on the class-1 logits over the fg slots.
            mlogits = self.mask_head(mrois.reshape((-1,) + mrois.shape[2:]))
            m = c.mask_size
            per_roi = bce_with_logits(
                mlogits[..., 1].reshape(-1, m, m),
                mtargets.reshape(-1, m, m)).mean(dim=(1, 2))
            mv = mvalid.reshape(-1).float()
            loss_mask = (per_roi * mv).sum() / count(mv.sum()).clamp(min=1.0)
        return {"loss_objectness": loss_obj,
                "loss_rpn_box_reg": loss_rpn_reg,
                "loss_classifier": loss_cls,
                "loss_box_reg": loss_reg,
                "loss_mask": loss_mask}

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def inference_forward(self, images: torch.Tensor) -> Detections:
        """images [B, th, tw, 3] in [0, 1] -> Detections with
        max_detections slots per image, boxes in tile coordinates."""
        c = self.cfg
        b = images.shape[0]
        with span("livecell.features"):
            feats = self.features(images)
        with span("livecell.rpn"):
            objs, dlts = self.rpn_outputs(feats)
        with span("livecell.proposals"):
            pboxes, pvalid = image_proposals(c, objs, dlts,
                                             self.anchors(images.device),
                                             self.img_hw)
        with span("livecell.heads"):
            rois = self.ms_roi(feats, pboxes, c.roi_size)
            h = self.box_head(rois.reshape((-1,) + rois.shape[2:]))
            cls_logits, box_deltas = self.box_predictor(h)
            p = pboxes.shape[1]
            scores = torch.softmax(cls_logits.reshape(b, p, -1),
                                   dim=-1)[..., 1]
            d1 = box_deltas.reshape(b, p, c.num_classes, 4)[:, :, 1]
            refined = clip_boxes(
                _decode_weighted(d1, pboxes, c.box_reg_weights), self.img_hw)
            keep = (scores > c.score_thresh) & pvalid & \
                small_box_mask(refined, c.det_min_size)
            nms = nms_iterated if c.rpn_nms_mode == "sweep" else nms_fixed
            idx, det_valid = nms(refined, scores, c.det_nms_thresh,
                                 c.max_detections, valid=keep)
            det_boxes = take_rows(refined, idx)
            det_scores = torch.gather(scores, 1, idx)

            # Mask branch on the final boxes (torchvision's eval path).
            mrois = self.ms_roi(feats, det_boxes, c.mask_roi_size)
            mlogits = self.mask_head(mrois.reshape((-1,) + mrois.shape[2:]))
            m = c.mask_size
            mask_probs = torch.sigmoid(
                mlogits[..., 1].reshape(b, c.max_detections, m, m))

            # Back to tile coordinates
            # (GeneralizedRCNNTransform.postprocess).
            sy, sx = self.scale
            unscale = constant((1 / sx, 1 / sy, 1 / sx, 1 / sy),
                               images.device)
            det_boxes = clip_boxes(det_boxes * unscale,
                                   (c.tile_height, c.tile_width))
            return Detections(
                boxes=det_boxes, scores=det_scores,
                labels=torch.ones((b, c.max_detections), dtype=torch.int32,
                                  device=images.device),
                valid=det_valid, mask_probs=mask_probs)

    def forward(self, images: torch.Tensor) -> Detections:
        return self.inference_forward(images)


def create_transfer_model(cfg: Optional[TransferConfig] = None,
                          generator: Optional[torch.Generator] = None,
                          device=None, train: bool = False
                          ) -> TransferMaskRCNN:
    """Build the transfer model with weights drawn from `generator` (seed
    0 when None) on channels_last memory, on `device` (the card unless
    the caller passes "cpu"). train=False: eval mode, the weights in
    cfg.compute_dtype, batch norm's in f32 (create_model's rule). train
    =True: f32 parameters (the master copy an optimizer updates), train
    mode; `train_forward` computes in cfg.compute_dtype under autocast.
    Weights from a torchvision checkpoint come in through
    models/torch_import.py, a JAX model's through models/convert.py."""
    dev = resolve_device(device)
    model = TransferMaskRCNN(cfg or TransferConfig(), generator)
    if train:
        model.to(device=dev, memory_format=torch.channels_last)
        return model.train()
    model.to(device=dev, dtype=model.compute_dtype,
             memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return model.eval()
