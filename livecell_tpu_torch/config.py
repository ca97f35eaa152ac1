"""Typed configuration for the PyTorch port.

The port's own copy of the configuration dataclasses of the JAX package
(livecell_tpu/config.py), so that the port imports nothing of it. Field
names, defaults and the JSON sidecar format are the same, so a
`model_config.json` written by either package loads in the other; the
port's sidecar also names its model (`config_to_dict`'s `model_type`),
so a transfer checkpoint carries its `TransferConfig`.

Three fields change meaning. `roi_backend` and `match_backend` select
the route of ops/cuda_roi_align.py and ops/cuda_match.py ("auto": the
hand-written kernels on CUDA tensors and their plain PyTorch versions
on CPU tensors; "kernel"; "plain"); `TransferConfig`'s `roi_backend`
and `rpn_match_backend` select those of ops/cuda_ms_roi_align.py and
ops/cuda_match.py the same way. `topk_backend` is "exact" or "auto"
(exact too): JAX's approximate top-k is a TPU instruction. A JAX sidecar's
route names ("einsum"/"pallas", "xla"/"pallas", "approx") are a choice
of deployment, not of semantics, and load as the port's routes.
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


ROUTES = ("auto", "kernel", "plain")

# JAX route names in a model_config.json sidecar -> the port's routes.
JAX_ROUTES = {"roi_backend": {"einsum": "auto", "pallas": "auto"},
              "match_backend": {"xla": "auto", "pallas": "auto"},
              "topk_backend": {"approx": "exact"}}


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

    # Anchor-matcher route: the same three values as roi_backend.
    match_backend: str = "auto"
    # "exact" or "auto" (exact).
    topk_backend: str = "auto"
    heads_all_images: bool = False

    # Decode the RPN deltas into proposals, refine the final boxes with
    # the box head's class-1 deltas and run a second mask pass at them.
    decode_proposals: bool = False
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    rpn_force_best_anchor: bool = True

    def __post_init__(self):
        for name, allowed in (("roi_backend", ROUTES),
                              ("match_backend", ROUTES),
                              ("topk_backend", ("auto", "exact"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")

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


def model_config_from_dict(d: dict) -> ModelConfig:
    """A ModelConfig from a sidecar dict (config_to_dict's, or the JAX
    package's model_config_to_dict's); unknown keys are ignored and the
    JAX package's route names map onto the port's (JAX_ROUTES)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in fields}
    for k, names in JAX_ROUTES.items():
        if k in kw:
            kw[k] = names.get(kw[k], kw[k])
    return ModelConfig(**kw)


def strict_equivalence_config(mcfg: ModelConfig) -> ModelConfig:
    """A deterministic variant of `mcfg` (the counterpart of the JAX
    package's, livecell_tpu/config.py:241-269): f32 compute, exact
    top-k, f32 RoIAlign, frozen batch norm. The routes stay as they are:
    every kernel of the port and its plain version sums in a fixed
    order, so each gives the same result in every run."""
    return dataclasses.replace(
        mcfg, compute_dtype="float32", topk_backend="exact",
        roi_precision="highest", frozen_bn=True)


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


def add_train_shape_flags(parser) -> None:
    """Attach the training-side dense-scene flags (the JAX package's,
    same names and defaults): anchor geometry and the proposal and RPN
    sampling budgets, stored in the checkpoint's sidecar so evaluation
    rebuilds the same model."""
    parser.add_argument("--anchor_sizes", type=str, default=None,
                        help="comma-separated anchor sizes (reference "
                             "32,64,128)")
    parser.add_argument("--anchor_ratios", type=str, default=None,
                        help="comma-separated anchor aspect ratios "
                             "(reference 0.5,1,2)")
    parser.add_argument("--train_topk", type=int, default=0,
                        help="training proposals kept before sampling "
                             "(reference 500)")
    parser.add_argument("--train_samples", type=int, default=0,
                        help="proposals sampled into the box/mask heads "
                             "per image (reference 128)")
    parser.add_argument("--rpn_batch", type=int, default=0,
                        help="anchors sampled into the RPN loss per "
                             "image (reference 256)")
    parser.add_argument("--rpn_pos", type=int, default=0,
                        help="positive-anchor cap within --rpn_batch "
                             "(reference 128)")
    parser.add_argument("--stem_s2d", action="store_true",
                        help="recorded in the sidecar; the port computes "
                             "the same stem either way")


def apply_train_shape_flags(mcfg: ModelConfig, args) -> ModelConfig:
    """Apply add_train_shape_flags' values onto a ModelConfig."""
    kw = {}
    if getattr(args, "anchor_sizes", None):
        kw["anchor_sizes"] = tuple(
            int(s) for s in args.anchor_sizes.split(","))
    if getattr(args, "anchor_ratios", None):
        kw["anchor_ratios"] = tuple(
            float(s) for s in args.anchor_ratios.split(","))
    if getattr(args, "train_topk", 0):
        kw["train_pre_topk"] = args.train_topk
    if getattr(args, "train_samples", 0):
        kw["train_num_samples"] = args.train_samples
    if getattr(args, "rpn_batch", 0):
        kw["rpn_batch_per_image"] = args.rpn_batch
    if getattr(args, "rpn_pos", 0):
        kw["rpn_pos_per_image"] = args.rpn_pos
    if getattr(args, "stem_s2d", False):
        kw["stem_s2d"] = True
    return dataclasses.replace(mcfg, **kw) if kw else mcfg


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    """The transfer R50-FPN Mask R-CNN (the JAX package's
    livecell_tpu/models/transfer.py:TransferConfig, same fields and
    defaults): torchvision maskrcnn_resnet50_fpn at the LIVECell tile
    shape. A 224x304 input tile is resized to the 800x1086 canvas and
    padded to 800x1088; the RPN runs over P2-P6 with one anchor size per
    level and 3 ratios."""

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
    # "sweep": ops/nms.py:nms_iterated; "scan": nms_fixed.
    rpn_nms_mode: str = "sweep"
    # MultiScaleRoIAlign route (ops/cuda_ms_roi_align.py) and anchor
    # matcher route (ops/cuda_match.py): "auto", "kernel" or "plain".
    roi_backend: str = "auto"
    rpn_match_backend: str = "auto"
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

    compute_dtype: str = "bfloat16"

    # Batch norm normalizes with its running statistics in every mode on
    # this model (torchvision's FrozenBatchNorm2d), so the flag changes
    # nothing in the forward (as in the JAX model).
    frozen_bn: bool = False

    def __post_init__(self):
        for name in ("roi_backend", "rpn_match_backend"):
            if getattr(self, name) not in ROUTES:
                raise ValueError(f"{name} must be one of {ROUTES}, got "
                                 f"{getattr(self, name)!r}")
        if self.rpn_nms_mode not in ("sweep", "scan"):
            raise ValueError(f"rpn_nms_mode must be 'sweep' or 'scan', got "
                             f"{self.rpn_nms_mode!r}")

    @property
    def box_pos(self) -> int:
        return int(self.box_batch * self.box_pos_fraction)

    @property
    def rpn_pos(self) -> int:
        return int(self.rpn_batch * self.rpn_pos_fraction)


MODEL_TYPES = {"custom": ModelConfig, "transfer": TransferConfig}


def model_type(cfg) -> str:
    """"custom" for a ModelConfig, "transfer" for a TransferConfig."""
    return next(k for k, t in MODEL_TYPES.items() if isinstance(cfg, t))


def config_to_dict(cfg) -> dict:
    """The checkpoint sidecar of a ModelConfig or a TransferConfig: its
    fields (tuples as lists) and its `model_type`. A custom sidecar is
    the JAX package's format, which its reader takes (it skips the key
    it does not know)."""
    d = dataclasses.asdict(cfg)
    return {"model_type": model_type(cfg), **{
        k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}}


def config_from_dict(d: dict):
    """(model_type, config) of a sidecar. One without `model_type` (the
    JAX package's, and the port's before it recorded one) is custom."""
    kind = d.get("model_type", "custom")
    if kind == "custom":
        return kind, model_config_from_dict(d)
    if kind not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {kind!r}")
    fields = {f.name for f in dataclasses.fields(TransferConfig)}
    return kind, TransferConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (the JAX package's TrainConfig): AdamW with
    a StepLR(lr_step_size, lr_gamma) decay per epoch."""

    batch_size: int = 2
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    num_epochs: int = 5
    lr_step_size: int = 2
    lr_gamma: float = 0.1
    seed: int = 0
    eval_score_thresh: float = 0.5
    eval_iou_thresh: float = 0.5


@dataclasses.dataclass(frozen=True)
class TransferTrainConfig:
    """The two-stage transfer schedule (the JAX package's
    TransferTrainConfig): stage 1 trains the heads with the backbone,
    FPN and RPN frozen, stage 2 everything; SGD with momentum and
    weight decay."""

    batch_size: int = 2
    stage1_lr: float = 5e-3
    stage1_epochs: int = 3
    stage2_lr: float = 1e-3
    stage2_epochs: int = 2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    transfer: TransferTrainConfig = dataclasses.field(
        default_factory=TransferTrainConfig)
    tile: TileConfig = dataclasses.field(default_factory=TileConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
