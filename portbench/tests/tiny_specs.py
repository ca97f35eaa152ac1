"""The cells of BENCHMARK.json cut to a size the CPU tests hold: the
published widths stay, the input tiles, slot counts and batches shrink,
and the program computes in float32, where it and the reference agree
to rounding."""

from __future__ import annotations

import copy

from portbench import spec as spec_mod

CUSTOM = dict(image_height=64, image_width=96, max_instances=8,
              train_pre_topk=64, train_num_samples=16, rpn_pos_per_image=16,
              rpn_batch_per_image=32)
TRANSFER = dict(tile_height=64, tile_width=96, image_height=128,
                image_width=192, resized_width=192,
                rpn_pre_topk_per_level=32, rpn_post_nms=32, box_batch=32,
                mask_slots=8, max_detections=8, max_instances=8,
                rpn_batch=32)
TRAIN = dict(batch=2, tiles=8, boxes={"count": 4, "min_side": 12,
                                      "max_side": 30})
FRAME = dict(tile={"frame_width": 210, "frame_height": 140,
                   "tiles_per_image": 25, "window_size": 3},
             frames=2, warmup_frames=1, check_frames=1, sample_from=1)


def tiny(workload: str, dtype: str = "float32") -> dict:
    """spec.load(workload) at the CPU tests' size."""
    sp = copy.deepcopy(spec_mod.load(workload))
    kind = sp["config"]["model_type"]
    sp["config"].update(CUSTOM if kind == "custom" else TRANSFER,
                        compute_dtype=dtype)
    if sp["traffic"]["driver"] == "train":
        sp["traffic"].update(TRAIN)
        model = sp["traffic"].get("model", {})
        if "mask_train_samples" in model:
            model["mask_train_samples"] = 8
        for k in ("rpn_pre_topk_per_level", "rpn_post_nms"):
            if k in model:
                model[k] = TRANSFER[k]
    else:
        sp["traffic"].update(FRAME)
    return sp
