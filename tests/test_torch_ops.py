"""PyTorch port ops vs the JAX package's ops, on the same numpy inputs.

Box, interpolation and mask ops are f32 elementwise/matrix arithmetic
in both packages: they must agree to f32 rounding (rtol 1e-6, atol 1e-5
on pixel-scale values). Selections (anchors, NMS, proposals) must agree
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.ops import anchors as j_anchors
from livecell_tpu.ops import boxes as j_boxes
from livecell_tpu.ops import interp as j_interp
from livecell_tpu.ops import mask_ops as j_mask
from livecell_tpu.ops import nms as j_nms
from livecell_tpu.ops import proposals as j_prop
from livecell_tpu_torch.ops import anchors as t_anchors
from livecell_tpu_torch.ops import boxes as t_boxes
from livecell_tpu_torch.ops import interp as t_interp
from livecell_tpu_torch.ops import mask_ops as t_mask
from livecell_tpu_torch.ops import nms as t_nms
from livecell_tpu_torch.ops import proposals as t_prop


def random_boxes(rng, n, lo=-10.0, hi=120.0, min_wh=0.5, max_wh=40.0):
    x1 = rng.uniform(lo, hi, n)
    y1 = rng.uniform(lo, hi, n)
    return np.stack([x1, y1, x1 + rng.uniform(min_wh, max_wh, n),
                     y1 + rng.uniform(min_wh, max_wh, n)], 1
                    ).astype(np.float32)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(a, b, rtol=1e-6, atol=1e-5):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", ["box_iou", "encode_boxes", "decode_boxes",
                                "clip_boxes", "small_box_mask"])
def test_box_ops_match_jax(fn):
    rng = np.random.default_rng(0)
    a = random_boxes(rng, 40)
    b = random_boxes(rng, 40)
    # Large dw/dh hit decode's log-space clamp (4.135).
    d = rng.normal(0, 2.5, (40, 4)).astype(np.float32)
    args = {"box_iou": (a, b), "encode_boxes": (a, b),
            "decode_boxes": (d, b), "clip_boxes": (a, (100, 90)),
            "small_box_mask": (a, 10.0)}[fn]
    to_j = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]
    to_t = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            for x in args]
    want = getattr(j_boxes, fn)(*to_j)
    got = getattr(t_boxes, fn)(*to_t)
    if fn == "small_box_mask":
        np.testing.assert_array_equal(np_(got), np_(want))
    else:
        close(got, want)                # f32 elementwise: rounding only


def test_box_iou_zero_area_union():
    z = np.zeros((3, 4), np.float32)
    got = np_(t_boxes.box_iou(torch.from_numpy(z), torch.from_numpy(z)))
    assert np.isfinite(got).all() and (got == 0).all()


@pytest.mark.parametrize("feature_size,sizes,ratios", [
    ((16, 24), (32, 64, 128), (0.5, 1.0, 2.0)),
    ((56, 76), (12, 24, 48), (0.5, 1.0, 2.0)),
])
def test_anchors_match_jax(feature_size, sizes, ratios):
    want = j_anchors.generate_anchors(feature_size, 4, sizes, ratios)
    got = t_anchors.generate_anchors(feature_size, 4, sizes, ratios)
    np.testing.assert_array_equal(got, want)        # same numpy code: exact


def test_interp_weights_match_jax():
    rng = np.random.default_rng(1)
    coords = rng.uniform(-3, 20, (5, 7)).astype(np.float32)
    valid = rng.uniform(size=(5, 7)) > 0.3
    want = j_interp.interp_weights(jnp.asarray(coords), 17,
                                   jnp.asarray(valid))
    got = t_interp.interp_weights(torch.from_numpy(coords), 17,
                                  torch.from_numpy(valid))
    close(got, want)


@pytest.mark.parametrize("src,dst", [(14, 28), (7, 5), (28, 100)])
def test_resize_weight_matrix_match_jax(src, dst):
    np.testing.assert_array_equal(t_interp.resize_weight_matrix(src, dst),
                                  j_interp.resize_weight_matrix(src, dst))


def test_roi_sample_matrices_match_jax():
    rng = np.random.default_rng(2)
    boxes = random_boxes(rng, 9, lo=-20.0, hi=90.0, min_wh=0.2)
    want = j_interp.roi_sample_matrices(jnp.asarray(boxes), (14, 19), 7, 2,
                                        0.25)
    got = t_interp.roi_sample_matrices(torch.from_numpy(boxes), (14, 19), 7,
                                       2, 0.25)
    for g, w in zip(got, want):
        close(g, w)


def test_paste_matrices_match_jax():
    rng = np.random.default_rng(3)
    # Negative and fractional coords: int truncation is toward zero.
    boxes = random_boxes(rng, 12, lo=-8.0, hi=60.0, min_wh=0.3, max_wh=30.0)
    want = j_interp.paste_matrices(jnp.asarray(boxes), (48, 64), 28)
    got = t_interp.paste_matrices(torch.from_numpy(boxes), (48, 64), 28)
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    np.testing.assert_array_equal(np_(got[2]), np_(want[2]))


def nms_case(seed, ties):
    rng = np.random.default_rng(seed)
    b, n = 3, 60
    # Dense: centers in a 40 px square, so most pairs overlap.
    boxes = np.stack([random_boxes(rng, n, lo=0.0, hi=40.0, min_wh=8.0,
                                   max_wh=30.0) for _ in range(b)])
    scores = rng.uniform(size=(b, n)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4      # 5 levels: many exact ties
    valid = rng.uniform(size=(b, n)) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thresh,max_keep", [(0.4, 20), (0.7, 60)])
def test_nms_fixed_matches_jax(ties, thresh, max_keep):
    boxes, scores, valid = nms_case(4, ties)
    got_idx, got_val = t_nms.nms_fixed(
        torch.from_numpy(boxes), torch.from_numpy(scores), thresh, max_keep,
        valid=torch.from_numpy(valid))
    for i in range(len(boxes)):
        want_idx, want_val = j_nms.nms_fixed(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thresh, max_keep,
            valid=jnp.asarray(valid[i]))
        want_val = np_(want_val)
        np.testing.assert_array_equal(np_(got_val[i]), want_val)
        # Greedy picks are an exact selection: same indices, same order.
        np.testing.assert_array_equal(np_(got_idx[i])[want_val],
                                      np_(want_idx)[want_val])


@pytest.mark.parametrize("decode", [False, True])
def test_inference_proposals_match_jax(decode):
    rng = np.random.default_rng(5)
    anchors = j_anchors.generate_anchors((16, 24), 4)
    a = len(anchors)
    b = 2
    obj = rng.normal(0, 2, (b, a)).astype(np.float32)
    # Exact ties in the objectness: the top-k must keep the lowest index
    # first among equal scores, as jax.lax.top_k does.
    obj[:, ::7] = obj[:, :1]
    deltas = rng.normal(0, 0.3, (b, a, 4)).astype(np.float32)
    kw = dict(image_size=(64, 96), pre_topk=64, score_thresh=0.3,
              nms_thresh=0.5, post_nms=16, min_size=10.0)
    got = t_prop.inference_proposals(
        torch.from_numpy(obj), torch.from_numpy(anchors),
        deltas=torch.from_numpy(deltas) if decode else None, **kw)
    for i in range(b):
        want = j_prop.inference_proposals(
            jnp.asarray(obj[i]), jnp.asarray(anchors),
            deltas=jnp.asarray(deltas[i]) if decode else None, **kw)
        np.testing.assert_array_equal(np_(got.valid[i]), np_(want.valid))
        v = np_(want.valid)
        close(np_(got.boxes[i])[v], np_(want.boxes)[v])
        close(np_(got.scores[i])[v], np_(want.scores)[v])


def test_top_k_stable_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = t_prop.top_k_stable(x, 4)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(np_(x)), 4)
    np.testing.assert_array_equal(np_(idx), np_(want_idx))
    np.testing.assert_array_equal(np_(vals), np_(want_vals))


@pytest.mark.parametrize("shape,out_hw", [((3, 14, 14, 2), (28, 28)),
                                          ((2, 9, 5, 3), (4, 11))])
def test_resize_bilinear_matches_jax(shape, out_hw):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = j_mask.resize_bilinear(jnp.asarray(x), out_hw)
    got = t_mask.resize_bilinear(torch.from_numpy(x), out_hw)
    close(got, want)


@pytest.mark.parametrize("with_valid", [False, True])
def test_paste_masks_match_jax(with_valid):
    rng = np.random.default_rng(7)
    k = 10
    boxes = random_boxes(rng, k, lo=-10.0, hi=70.0, min_wh=0.5, max_wh=40.0)
    # Probabilities away from the 0.5 threshold, so f32 rounding cannot
    # flip a pixel: the binary masks must be equal.
    probs = rng.uniform(size=(k, 28, 28)).astype(np.float32)
    probs = np.where(np.abs(probs - 0.5) < 0.05, 0.9, probs)
    probs = np.repeat(np.repeat(probs[:, ::4, ::4], 4, 1), 4, 2)
    valid = rng.uniform(size=k) > 0.3 if with_valid else None
    want = j_mask.paste_masks(
        jnp.asarray(probs), jnp.asarray(boxes), (64, 80),
        valid=None if valid is None else jnp.asarray(valid))
    got = t_mask.paste_masks(
        torch.from_numpy(probs), torch.from_numpy(boxes), (64, 80),
        valid=None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.uint8
    g, w = np_(got), np_(want)
    # Interpolated values can still land within f32 rounding of 0.5 at
    # a blend between a low and a high block: allow at most 0.1% of
    # pixels to differ.
    assert (g != w).mean() <= 1e-3, (g != w).mean()
