"""Custom Mask R-CNN (counterpart of livecell_tpu/models/mask_rcnn.py:
CustomMaskRCNN.extract_features, _match_anchors, _roi_align,
train_forward, inference_forward; create_model).

Images and feature maps are NHWC at the public boundary; inside, the
convolutions run NCHW on channels_last memory, so a feature map's NHWC
view is contiguous and goes to the RoIAlign kernels without a copy.
Inference is batched over images: one forward serves a frame's tiles.

Training keeps f32 parameters (`create_train_model`) and runs the
convolutions and matmuls in the compute dtype under autocast, as flax
casts an f32 parameter to `dtype=bf16` inside each op. The step's
random draws are explicit uniforms (`sampling_noise`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.device import constant, resolve_device
from livecell_tpu_torch.models.cbam import CBAM
from livecell_tpu_torch.models.detector import (
    Detections, HeadTargets, box_losses, local_count, mask_loss, mask_loss_on,
    match_head_targets, rpn_loss_single, rpn_reg_loss_from_match, rpn_sample)
from livecell_tpu_torch.models.fpn import FPN
from livecell_tpu_torch.models.heads import BoxHead, MaskHead
from livecell_tpu_torch.models.resnet import BatchNorm, ResNetBackbone
from livecell_tpu_torch.models.rpn import RPNHead
from livecell_tpu_torch.ops.anchors import generate_anchors
from livecell_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from livecell_tpu_torch.ops.cuda_match import (
    match_anchors, match_anchors_plain)
from livecell_tpu_torch.ops.cuda_roi_align import roi_align
from livecell_tpu_torch.ops.nms import nms_fixed
from livecell_tpu_torch.ops.proposals import (
    inference_proposals, take_rows, top_k_stable, training_proposals)
from livecell_tpu_torch.utils.profiling import span


class CustomMaskRCNN(nn.Module):
    """ResNet-18 + serial CBAM + FPN + RPN + box/mask heads. Module
    names mirror the JAX parameter tree (backbone, cbam1..4, fpn, rpn,
    box_head, mask_head).

    `data_axis` (parallel/mesh.py:shard_model) makes the training losses
    those of the global batch split over the data ranks: fixed mode
    divides by the global normalizers and the global image count; quirk
    mode reads the whole global batch's GT and keeps its losses on data
    rank 0, which holds image 0."""

    data_axis = None

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.backbone = ResNetBackbone(g, widths=c.backbone_channels)
        for i, ch in enumerate(c.backbone_channels):
            self.add_module(f"cbam{i + 1}", CBAM(
                ch, c.cbam_reduction, c.cbam_spatial_kernel, g))
        self.fpn = FPN(c.backbone_channels, c.fpn_channels, g)
        self.rpn = RPNHead(c.fpn_channels, c.num_anchors_per_cell, g)
        self.box_head = BoxHead(c.fpn_channels, c.num_classes,
                                c.roi_output_size, g)
        self.mask_head = MaskHead(c.fpn_channels, c.num_classes,
                                  c.mask_size, g)
        self._anchor_cache: Dict[torch.device, torch.Tensor] = {}
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.frozen = c.frozen_bn

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def anchors(self, device: torch.device) -> torch.Tensor:
        """[A, 4] f32 anchors in (y, x, a) order, cached per device."""
        if device not in self._anchor_cache:
            c = self.cfg
            self._anchor_cache[device] = torch.from_numpy(generate_anchors(
                (c.feature_height, c.feature_width), c.anchor_stride,
                c.anchor_sizes, c.anchor_ratios)).to(device)
        return self._anchor_cache[device]

    def extract_features(self, images: torch.Tensor,
                         levels: Optional[int] = None
                         ) -> Tuple[torch.Tensor, ...]:
        """images [B, H, W, 3] -> the first `levels` (default all) FPN
        maps, NHWC. CBAM is chained serially: each stage consumes the
        previous stage's attended output."""
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        cbams = [getattr(self, f"cbam{i + 1}")
                 for i in range(len(self.cfg.backbone_channels))]
        stages = self.backbone(x, post_stage=cbams)
        feats = self.fpn(stages, levels)
        return tuple(f.permute(0, 2, 3, 1) for f in feats)

    def _match_anchors(self, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                       full: bool = True):
        """K4 over this model's anchors under cfg.match_backend: "auto"
        (the kernel on CUDA tensors, its plain version on CPU tensors),
        "kernel" (CUDA tensors only) or "plain"."""
        backend = self.cfg.match_backend
        anchors = self.anchors(gt_boxes.device)
        if backend == "plain":
            return match_anchors_plain(anchors, gt_boxes, gt_valid, full)
        if backend == "kernel" and gt_boxes.device.type != "cuda":
            raise ValueError("match_backend='kernel' needs CUDA tensors")
        return match_anchors(anchors, gt_boxes.float().contiguous(),
                             gt_valid.bool().contiguous(), full)

    def _roi_align(self, feats: torch.Tensor, boxes: torch.Tensor
                   ) -> torch.Tensor:
        """[B,H,W,C], [B,K,4] -> [B,K,s,s,C] through ops/cuda_roi_align
        under cfg.roi_backend. It runs in the compute dtype, or in f32
        when roi_precision is not "default" (the JAX package's f32
        einsum route)."""
        c = self.cfg
        dtype = self.compute_dtype if c.roi_precision == "default" \
            else torch.float32
        return roi_align(feats.to(dtype).contiguous(),
                         boxes.float().contiguous(), c.roi_output_size,
                         c.roi_spatial_scale, c.roi_sampling_ratio,
                         backend=c.roi_backend)

    def sampling_noise(self, b: int, device,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """The uniforms of one training step of a batch of b, drawn from
        `generator` (on `device`): per supervised image (image 0 in the
        reference's quirk mode, every image with heads_all_images) two
        [N] vectors ranking the RPN's positive and negative candidates
        and one [min(train_pre_topk, N)] vector sampling the proposals."""
        c = self.cfg
        m = b if c.heads_all_images else 1
        n = c.num_anchors

        def draw(k):
            return torch.rand((m, k), generator=generator, device=device)

        return {"rpn_pos": draw(n), "rpn_neg": draw(n),
                "proposals": draw(min(c.train_pre_topk, n))}

    def train_forward(self, images: torch.Tensor,
                      targets: Dict[str, torch.Tensor],
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      record: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] float in [0, 1], targets {boxes [B,I,4],
        valid [B,I], mask28 [B,I,28,28] in [0, 1]} -> the loss dict (f32
        scalars, in the JAX package's order). `noise` holds the step's
        uniforms (`sampling_noise`), drawn from `generator` when None.
        `record`, when given, receives the step's selections: the RPN's
        sampled positives and negatives, the proposals and the mask
        subset."""
        b, dev = images.shape[0], images.device
        if noise is None:
            noise = self.sampling_noise(b, dev, generator)
        on = self.compute_dtype != torch.float32
        with torch.autocast(dev.type, dtype=self.compute_dtype, enabled=on):
            return self._train_forward(images, targets, noise, record)

    def _train_forward(self, images, targets, noise, record):
        c = self.cfg
        b = images.shape[0]
        axis = self.data_axis
        n_images = b if axis is None else b * axis.size
        split = axis is not None and c.heads_all_images
        count = axis.count if split else local_count

        def batch_mean(per_image):
            if not split:
                return per_image.mean()
            return per_image.sum() / n_images
        img_size = (c.image_height, c.image_width)
        with span("livecell.features"):
            feat0 = self.extract_features(images, levels=1)[0]
        with span("livecell.rpn"):
            cls_scores, bbox_deltas = self.rpn([feat0.permute(0, 3, 1, 2)])
            obj = cls_scores[0].reshape(b, -1).float()          # [B, N]
            rpn_dlt = bbox_deltas[0].reshape(b, -1, 4)          # [B, N, 4]
            anchors = self.anchors(images.device)
            gt_boxes = targets["boxes"].float()
            gt_valid = targets["valid"].bool()
            mask28 = targets["mask28"].float()
            # Quirk mode (the reference's semantics): the RPN loss reads
            # image 0's scores against the GT of the whole batch
            # concatenated, the heads train on image 0. Fixed mode: every
            # image does both.
            s = slice(None) if c.heads_all_images else slice(0, 1)
            if c.heads_all_images:
                rpn_gt, rpn_valid = gt_boxes, gt_valid
            else:
                all_gt = (gt_boxes, gt_valid, mask28)
                if axis is not None:
                    all_gt = tuple(axis.gather(x) for x in all_gt)
                rpn_gt, rpn_valid = all_gt[0].reshape(1, -1, 4), \
                    all_gt[1].reshape(1, -1)
            full = c.decode_proposals and c.heads_all_images
            match = self._match_anchors(rpn_gt, rpn_valid, full=full)
            max_iou = match[0] if full else match
            loss_rpn = rpn_loss_single(obj[s], rpn_valid, max_iou,
                                       noise["rpn_pos"], noise["rpn_neg"], c)
        with span("livecell.proposals"):
            props = training_proposals(
                obj[s], anchors, img_size, noise["proposals"],
                c.train_pre_topk, c.train_score_thresh,
                c.train_min_box_size, c.train_num_samples,
                deltas=rpn_dlt[s] if c.decode_proposals else None)
            mask_gt = None
            if not c.heads_all_images and n_images > 1:
                # Reference quirk: mask targets are re-matched against
                # the whole batch's GT (mask_utils.py:88-108).
                mask_gt = (rpn_gt, rpn_valid,
                           all_gt[2].reshape((1, -1) + mask28.shape[2:]))
            t = match_head_targets(props.boxes, props.valid, gt_boxes[s],
                                   gt_valid[s], mask28[s], c, mask_gt=mask_gt)
        with span("livecell.heads"):
            rois = self._roi_align(feat0[s], props.boxes)     # [b', K, ...]
            flat_rois = rois.reshape((-1,) + rois.shape[2:])
            cls_logits, box_deltas = self.box_head(flat_rois)
            flat_t = HeadTargets(*(x.reshape((-1,) + x.shape[2:])
                                   for x in t))
            losses = box_losses(cls_logits, box_deltas, flat_t, count)

            m = c.mask_train_samples
            order = None
            if c.heads_all_images and 0 < m < c.train_num_samples:
                # The mask head runs on the top m of each image's
                # proposals, mask-fg first (stable: proposal order among
                # equals). A row gather computes the JAX package's
                # one-hot product exactly.
                order = top_k_stable(t.mask_weight, m)[1]      # [B, m]
                k = rois.shape[1]
                mrois = take_rows(rois.reshape(b, k, -1), order)
                mtargets = take_rows(t.mask_targets.reshape(b, k, -1), order)
                mask_logits = self.mask_head(
                    mrois.reshape((-1,) + rois.shape[2:]))
                losses["loss_mask"] = mask_loss_on(
                    mask_logits, mtargets.reshape((-1,) + mask28.shape[2:]),
                    torch.gather(t.mask_weight, 1, order).reshape(-1), count)
            else:
                losses["loss_mask"] = mask_loss(self.mask_head(flat_rois),
                                                flat_t, count)
        with span("livecell.rpn"):
            losses["loss_rpn_cls"] = batch_mean(loss_rpn)
            if c.decode_proposals:
                # Quirk mode regresses image 0's deltas on image 0's GT:
                # a second, full match.
                reg_match = match if full else self._match_anchors(
                    gt_boxes[s], gt_valid[s])
                losses["loss_rpn_reg"] = batch_mean(rpn_reg_loss_from_match(
                    rpn_dlt[s], *reg_match, gt_valid[s], c))
        if record is not None:
            pos, neg, _ = rpn_sample(max_iou, noise["rpn_pos"],
                                     noise["rpn_neg"], c)
            record.update(rpn_pos=pos, rpn_neg=neg, proposals=props.boxes,
                          proposal_valid=props.valid)
            if order is not None:
                record["mask_subset"] = order
        if axis is not None and not c.heads_all_images:
            # Every rank runs the same graph (the collectives of the
            # backward must match); only image 0's rank keeps its losses.
            keep = float(axis.rank == 0)
            losses = {k: v * keep for k, v in losses.items()}
        return losses

    @torch.no_grad()
    def inference_forward(self, images: torch.Tensor) -> Detections:
        """images [B, H, W, 3] float in [0, 1] -> Detections with
        max_detections slots per image."""
        c = self.cfg
        b = images.shape[0]
        img_size = (c.image_height, c.image_width)
        with span("livecell.features"):
            feat0 = self.extract_features(images, levels=1)[0]
        with span("livecell.rpn"):
            cls_scores, bbox_deltas = self.rpn([feat0.permute(0, 3, 1, 2)])
            obj = cls_scores[0].reshape(b, -1).float()
            rpn_dlt = bbox_deltas[0].reshape(b, -1, 4)
        with span("livecell.proposals"):
            props = inference_proposals(
                obj, self.anchors(images.device), img_size,
                c.infer_pre_topk, c.infer_score_thresh, c.infer_nms_thresh,
                c.infer_post_nms, c.infer_min_box_size,
                deltas=rpn_dlt if c.decode_proposals else None)
        with span("livecell.heads"):
            rois = self._roi_align(feat0, props.boxes)
            flat_rois = rois.reshape((-1,) + rois.shape[2:])
            cls_logits, head_deltas = self.box_head(flat_rois)
            d = c.infer_post_nms
            box_scores = torch.softmax(cls_logits.reshape(b, d, -1),
                                       dim=-1)[..., 1]
            boxes = props.boxes
            if c.decode_proposals:
                # Refine with the box head's class-1 deltas, undoing the
                # box-coder weights the targets were scaled by.
                w = constant(tuple(c.box_reg_weights), boxes.device)
                boxes = clip_boxes(decode_boxes(
                    head_deltas.reshape(b, d, -1)[..., 4:8] / w, boxes),
                    img_size)
            keep = (box_scores > c.det_score_thresh) & props.valid
            det_idx, det_valid = nms_fixed(boxes, box_scores,
                                           c.det_nms_thresh,
                                           c.max_detections, valid=keep)
            det_boxes = take_rows(boxes, det_idx)
            det_scores = torch.gather(box_scores, 1, det_idx)

            m = c.mask_size
            if c.decode_proposals:
                # Second mask pass at the final (refined) boxes, so masks
                # are predicted and pasted in the same frame.
                mrois = self._roi_align(feat0, det_boxes)
                mask_logits = self.mask_head(
                    mrois.reshape((-1,) + mrois.shape[2:]))
                mask_probs = torch.sigmoid(
                    mask_logits[..., 1].reshape(b, c.max_detections, m, m))
            else:
                # Reference behaviour: mask logits of the proposal ROIs,
                # gathered through the detection NMS.
                mask_logits = self.mask_head(flat_rois)
                probs_all = torch.sigmoid(
                    mask_logits[..., 1].reshape(b, d, m, m))
                rows = torch.arange(b, device=images.device)[:, None]
                mask_probs = probs_all[rows, det_idx]

            return Detections(
                boxes=det_boxes, scores=det_scores,
                labels=torch.ones((b, c.max_detections), dtype=torch.int32,
                                  device=images.device),
                valid=det_valid, mask_probs=mask_probs)

    def forward(self, images: torch.Tensor) -> Detections:
        return self.inference_forward(images)


def create_train_model(cfg: ModelConfig,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> CustomMaskRCNN:
    """Build the model for training: weights drawn from `generator`
    (seed 0 when None), f32 parameters and batch-norm statistics (the
    master copy an optimizer updates), channels_last memory, train mode,
    on `device` (the card unless the caller passes "cpu").
    `train_forward` computes in cfg.compute_dtype."""
    dev = resolve_device(device)
    model = CustomMaskRCNN(cfg, generator)
    model.to(device=dev, memory_format=torch.channels_last)
    return model.train()


def create_model(cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> CustomMaskRCNN:
    """Build the model with weights drawn from `generator` (seed 0 when
    None), in eval mode, in cfg.compute_dtype, on channels_last memory,
    on `device` (the card unless the caller passes "cpu").

    Batch norm keeps its parameters and running statistics in f32, as
    the JAX model does: a bf16 activation is normalized in f32 and
    rounded once to bf16 (F.batch_norm takes the mixed types)."""
    dev = resolve_device(device)
    model = CustomMaskRCNN(cfg, generator)
    model.to(device=dev, dtype=model.compute_dtype,
             memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return model.eval()


def count_parameters(model: nn.Module) -> Dict[str, Any]:
    """Per-subsystem parameter counts (the JAX package's
    count_parameters, same keys): parameters only, not batch norm's
    running statistics."""
    groups = {"backbone": 0, "cbam": 0, "fpn": 0, "rpn": 0, "box_head": 0,
              "mask_head": 0, "roi_align": 0}
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        for g in groups:
            if g in name:
                groups[g] += n
                break
    custom = total - groups["backbone"]
    return {
        "total": total, **groups, "custom": custom,
        "custom_percentage": 100.0 * custom / total if total else 0.0,
        "memory_mb": total * 4 / (1024 ** 2),
    }
