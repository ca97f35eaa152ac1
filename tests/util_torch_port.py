"""Shared set-up of the PyTorch-port equivalence tests: one small f32
model, built by the JAX package and carried into the port through
models/convert.py, so both hold the same weights."""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np

from livecell_tpu.config import ModelConfig as JaxModelConfig
from livecell_tpu.models.mask_rcnn import CustomMaskRCNN as JaxMaskRCNN
from livecell_tpu.models.mask_rcnn import create_model as jax_create_model
from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.models.convert import from_jax_variables
from livecell_tpu_torch.models.mask_rcnn import create_model

# 64x96 input -> 16x24 stride-4 map, 3456 anchors. f32 everywhere; the
# JAX side takes its exact einsum RoIAlign.
CFG_KW = dict(image_height=64, image_width=96, compute_dtype="float32",
              roi_precision="highest", infer_pre_topk=64, infer_post_nms=16,
              max_detections=16, det_score_thresh=0.3)
JAX_CFG = JaxModelConfig(roi_backend="einsum", **CFG_KW)
PORT_CFG = ModelConfig(**CFG_KW)

# Freshly initialized predictors give nearly equal scores everywhere
# (weights of std 0.01); scaling them spreads the scores, so the
# selections (top-k, NMS order, thresholds) have margins well above f32
# rounding. The tests assert those margins before comparing.
PREDICTOR_SCALE = {("rpn", "cls_logits", "kernel"): 300.0,
                   ("box_head", "cls_score", "kernel"): 30.0,
                   ("mask_head", "mask_fcn_logits", "kernel"): 3.0}


@functools.lru_cache(maxsize=1)
def jax_variables():
    """Nested dicts of numpy arrays (the JAX {params, batch_stats})."""
    _, v = jax_create_model(JAX_CFG, jax.random.key(0))
    v = jax.tree.map(lambda x: np.array(x, np.float32), v)
    for path, s in PREDICTOR_SCALE.items():
        node = v["params"]
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = node[path[-1]] * np.float32(s)
    return v


def port_model():
    """The port model on the CPU holding the JAX weights."""
    m = create_model(PORT_CFG, device="cpu")
    m.load_state_dict(from_jax_variables(jax_variables()), strict=True)
    return m


def jax_model(**overrides):
    return JaxMaskRCNN(dataclasses.replace(JAX_CFG, **overrides))


def jax_call(fn, *args):
    """Run a JAX function, jitted, at f32 matmul precision (JAX's default
    precision may round f32 dot inputs to bf16, even on the CPU); numpy
    out."""
    with jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def images(seed: int, b: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(b, CFG_KW["image_height"],
                             CFG_KW["image_width"], 3)).astype(np.float32)


def min_gap(values: np.ndarray) -> float:
    """Smallest distance between consecutive sorted values."""
    v = np.sort(np.asarray(values, np.float64).ravel())
    return float(np.diff(v).min()) if v.size > 1 else np.inf
