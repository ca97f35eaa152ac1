"""The reference's configurations: the port's ModelConfig, TransferConfig
and TileConfig fields, read from the benchmark's configuration files
(unknown keys ignored)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TileConfig:
    frame_width: int = 704
    frame_height: int = 520
    tiles_per_image: int = 25
    window_size: int = 3

    @property
    def grid_size(self) -> int:
        return int(self.tiles_per_image ** 0.5) + 2

    @property
    def mini_tile_width(self) -> int:
        return self.frame_width // self.grid_size

    @property
    def mini_tile_height(self) -> int:
        return self.frame_height // self.grid_size

    @property
    def tile_width(self) -> int:
        return self.mini_tile_width * self.window_size

    @property
    def tile_height(self) -> int:
        return self.mini_tile_height * self.window_size

    @property
    def tiles_per_row(self) -> int:
        return self.grid_size - self.window_size + 1

    @property
    def num_tiles(self) -> int:
        return self.tiles_per_row ** 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 2
    image_height: int = 224
    image_width: int = 304
    backbone_channels: Tuple[int, int, int, int] = (64, 128, 256, 512)
    fpn_channels: int = 256
    cbam_reduction: int = 16
    cbam_spatial_kernel: int = 7
    anchor_sizes: Tuple[int, ...] = (32, 64, 128)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_stride: int = 4
    roi_output_size: int = 7
    roi_spatial_scale: float = 0.25
    roi_sampling_ratio: int = 2
    mask_size: int = 28
    rpn_pos_iou: float = 0.5
    rpn_neg_iou: float = 0.3
    rpn_pos_per_image: int = 128
    rpn_batch_per_image: int = 256
    train_pre_topk: int = 500
    train_score_thresh: float = 0.01
    train_min_box_size: float = 5.0
    train_num_samples: int = 128
    infer_pre_topk: int = 250
    infer_score_thresh: float = 0.3
    infer_nms_thresh: float = 0.4
    infer_post_nms: int = 50
    infer_min_box_size: float = 10.0
    det_score_thresh: float = 0.4
    det_nms_thresh: float = 0.5
    max_detections: int = 50
    box_fg_iou: float = 0.4
    mask_fg_iou: float = 0.3
    max_instances: int = 128
    mask_train_samples: int = 0
    frozen_bn: bool = False
    compute_dtype: str = "float32"
    heads_all_images: bool = False
    decode_proposals: bool = False
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    rpn_force_best_anchor: bool = True

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_ratios)

    @property
    def feature_height(self) -> int:
        h = (self.image_height + 2 * 3 - 7) // 2 + 1
        return (h + 2 * 1 - 3) // 2 + 1

    @property
    def feature_width(self) -> int:
        w = (self.image_width + 2 * 3 - 7) // 2 + 1
        return (w + 2 * 1 - 3) // 2 + 1

    @property
    def num_anchors(self) -> int:
        return (self.feature_height * self.feature_width
                * self.num_anchors_per_cell)


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    num_classes: int = 2
    tile_height: int = 224
    tile_width: int = 304
    image_height: int = 800
    resized_width: int = 1086
    image_width: int = 1088
    max_instances: int = 128
    mask_size: int = 28
    mask_roi_size: int = 14
    roi_size: int = 7
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    level_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    rpn_pre_topk_per_level: int = 1000
    rpn_post_nms: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 1e-3
    rpn_nms_mode: str = "sweep"
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch: int = 256
    rpn_pos_fraction: float = 0.5
    box_fg_iou: float = 0.5
    box_batch: int = 512
    box_pos_fraction: float = 0.25
    box_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    mask_slots: int = 128
    score_thresh: float = 0.05
    det_nms_thresh: float = 0.5
    det_min_size: float = 1e-2
    max_detections: int = 100
    compute_dtype: str = "float32"

    @property
    def box_pos(self) -> int:
        return int(self.box_batch * self.box_pos_fraction)

    @property
    def rpn_pos(self) -> int:
        return int(self.rpn_batch * self.rpn_pos_fraction)


def from_dict(cls, d: dict):
    """`cls` from a configuration file's keys (lists as tuples), in
    float32 whatever the file states: the reference's precision."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in fields}
    kw["compute_dtype"] = "float32"
    return cls(**kw)
