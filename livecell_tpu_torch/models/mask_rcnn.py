"""Custom Mask R-CNN, inference path (counterpart of
livecell_tpu/models/mask_rcnn.py: CustomMaskRCNN.extract_features,
_roi_align, inference_forward; create_model).

Images and feature maps are NHWC at the public boundary; inside, the
convolutions run NCHW on channels_last memory, so a feature map's NHWC
view is contiguous and goes to the RoIAlign kernels without a copy.
Inference is batched over images: one forward serves a frame's tiles.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.cbam import CBAM
from livecell_tpu_torch.models.detector import Detections
from livecell_tpu_torch.models.fpn import FPN
from livecell_tpu_torch.models.heads import BoxHead, MaskHead
from livecell_tpu_torch.models.resnet import ResNetBackbone
from livecell_tpu_torch.models.rpn import RPNHead
from livecell_tpu_torch.ops.anchors import generate_anchors
from livecell_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from livecell_tpu_torch.ops.cuda_roi_align import roi_align
from livecell_tpu_torch.ops.nms import nms_fixed
from livecell_tpu_torch.ops.proposals import inference_proposals, take_rows


class CustomMaskRCNN(nn.Module):
    """ResNet-18 + serial CBAM + FPN + RPN + box/mask heads. Module
    names mirror the JAX parameter tree (backbone, cbam1..4, fpn, rpn,
    box_head, mask_head)."""

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

    @torch.no_grad()
    def inference_forward(self, images: torch.Tensor) -> Detections:
        """images [B, H, W, 3] float in [0, 1] -> Detections with
        max_detections slots per image."""
        c = self.cfg
        b = images.shape[0]
        img_size = (c.image_height, c.image_width)
        feats = self.extract_features(images, levels=1)
        feat0 = feats[0]
        cls_scores, bbox_deltas = self.rpn([feat0.permute(0, 3, 1, 2)])
        obj = cls_scores[0].reshape(b, -1).float()
        rpn_dlt = bbox_deltas[0].reshape(b, -1, 4)

        props = inference_proposals(
            obj, self.anchors(images.device), img_size, c.infer_pre_topk,
            c.infer_score_thresh, c.infer_nms_thresh, c.infer_post_nms,
            c.infer_min_box_size,
            deltas=rpn_dlt if c.decode_proposals else None)
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
            w = torch.tensor(c.box_reg_weights, dtype=torch.float32,
                             device=boxes.device)
            boxes = clip_boxes(decode_boxes(
                head_deltas.reshape(b, d, -1)[..., 4:8] / w, boxes), img_size)
        keep = (box_scores > c.det_score_thresh) & props.valid
        det_idx, det_valid = nms_fixed(boxes, box_scores, c.det_nms_thresh,
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
            probs_all = torch.sigmoid(mask_logits[..., 1].reshape(b, d, m, m))
            rows = torch.arange(b, device=images.device)[:, None]
            mask_probs = probs_all[rows, det_idx]

        return Detections(
            boxes=det_boxes, scores=det_scores,
            labels=torch.ones((b, c.max_detections), dtype=torch.int32,
                              device=images.device),
            valid=det_valid, mask_probs=mask_probs)

    def forward(self, images: torch.Tensor) -> Detections:
        return self.inference_forward(images)


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
