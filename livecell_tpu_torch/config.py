"""Typed configuration for the PyTorch port.

The port's own copy of the configuration dataclasses of the JAX package
(livecell_tpu/config.py), so that the port imports nothing of it. Field
names, defaults and the JSON sidecar format are the same, so a
`model_config.json` written by either package loads in the other.

One field changes meaning: `roi_backend` selects the RoIAlign route of
ops/cuda_roi_align.py ("auto": the hand-written kernels on CUDA tensors
and their plain PyTorch versions on CPU tensors; "kernel"; "plain").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Tiling geometry: a frame is cut into a grid_size x grid_size
    lattice of mini tiles, and a window_size x window_size window of
    them slides over all positions, giving (grid_size - window_size +
    1)^2 overlapping tiles."""

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
    """Custom Mask R-CNN architecture + detection hyperparameters
    (the same fields and defaults as the JAX package's ModelConfig)."""

    num_classes: int = 2

    # Padded network input; a 300x222 tile is zero-padded right/bottom.
    image_height: int = 224
    image_width: int = 304

    # Backbone / FPN.
    backbone_channels: Tuple[int, int, int, int] = (64, 128, 256, 512)
    fpn_channels: int = 256
    cbam_reduction: int = 16
    cbam_spatial_kernel: int = 7

    # Anchors (stride-4 level).
    anchor_sizes: Tuple[int, ...] = (32, 64, 128)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_stride: int = 4

    # RoIAlign.
    roi_output_size: int = 7
    roi_spatial_scale: float = 0.25
    roi_sampling_ratio: int = 2

    # Mask head.
    mask_size: int = 28

    # RPN loss sampling.
    rpn_pos_iou: float = 0.5
    rpn_neg_iou: float = 0.3
    rpn_pos_per_image: int = 128
    rpn_batch_per_image: int = 256

    # Training proposals.
    train_pre_topk: int = 500
    train_score_thresh: float = 0.01
    train_min_box_size: float = 5.0
    train_num_samples: int = 128

    # Inference proposals.
    infer_pre_topk: int = 250
    infer_score_thresh: float = 0.3
    infer_nms_thresh: float = 0.4
    infer_post_nms: int = 50
    infer_min_box_size: float = 10.0

    # Detection head postprocess.
    det_score_thresh: float = 0.4
    det_nms_thresh: float = 0.5
    max_detections: int = 50

    # Second-stage matching thresholds.
    box_fg_iou: float = 0.4
    mask_fg_iou: float = 0.3

    max_instances: int = 128
    mask_train_samples: int = 0
    frozen_bn: bool = False

    # A space-to-depth form of the stem conv in the JAX package; the
    # same function, so the port computes the plain 7x7/2 stem for both.
    # Accepted and ignored, so that a JAX model_config.json sidecar loads.
    stem_s2d: bool = False

    # Compute dtype for the conv/matmul path.
    compute_dtype: str = "bfloat16"

    # "default": RoIAlign runs in the compute dtype. Anything else runs
    # it in float32 whatever the compute dtype.
    roi_precision: str = "default"

    # RoIAlign route: "auto" (kernels on CUDA tensors, plain PyTorch on
    # CPU tensors), "kernel" (always the kernels; CUDA tensors only) or
    # "plain" (always the plain PyTorch version).
    roi_backend: str = "auto"

    match_backend: str = "auto"
    topk_backend: str = "auto"
    heads_all_images: bool = False

    # Decode the RPN deltas into proposals, refine the final boxes with
    # the box head's class-1 deltas and run a second mask pass at them.
    decode_proposals: bool = False
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    rpn_force_best_anchor: bool = True

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_ratios)

    @property
    def feature_height(self) -> int:
        """Stride-4 feature height: conv1 (k7 s2 p3), maxpool (k3 s2 p1)."""
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


def model_config_to_dict(mcfg: ModelConfig) -> dict:
    """JSON-serializable dict of a ModelConfig (tuples become lists)."""
    d = dataclasses.asdict(mcfg)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def model_config_from_dict(d: dict) -> ModelConfig:
    """Inverse of model_config_to_dict; unknown keys are ignored."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in fields}
    return ModelConfig(**kw)


def apply_dense_flags(mcfg: ModelConfig, dets: int = 0,
                      infer_nms: float = 0.0, det_nms: float = 0.0
                      ) -> ModelConfig:
    """Lift the reference's detection caps for dense scenes: `dets=N`
    sets infer_post_nms = max_detections = N and infer_pre_topk = 5N;
    `infer_nms`/`det_nms` override the NMS IoU thresholds. Zero values
    keep the reference behaviour."""
    if dets:
        mcfg = dataclasses.replace(
            mcfg, infer_pre_topk=5 * dets, infer_post_nms=dets,
            max_detections=dets)
    if infer_nms or det_nms:
        mcfg = dataclasses.replace(
            mcfg, infer_nms_thresh=infer_nms or mcfg.infer_nms_thresh,
            det_nms_thresh=det_nms or mcfg.det_nms_thresh)
    return mcfg


def add_dense_flags(parser) -> None:
    """Attach the shared --dets/--infer_nms/--det_nms CLI flags."""
    parser.add_argument("--dets", type=int, default=0,
                        help="detection budget per tile (sets "
                             "infer_post_nms = max_detections = N and "
                             "infer_pre_topk = 5N; 0 keeps the "
                             "reference's 50-detection cap)")
    parser.add_argument("--infer_nms", type=float, default=0.0,
                        help="proposal NMS IoU (reference 0.4)")
    parser.add_argument("--det_nms", type=float, default=0.0,
                        help="final detection NMS IoU (reference 0.5)")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    tile: TileConfig = dataclasses.field(default_factory=TileConfig)
