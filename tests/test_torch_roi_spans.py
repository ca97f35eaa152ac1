"""The pre-passes of the tiled RoIAlign backward kernels (K3, K6):
`roi_spans_plain` and `ms_roi_spans_plain` (ops/cuda_roi_align.py,
ops/cuda_ms_roi_align.py), what their wrappers compute on CPU tensors.

A span is the inclusive row and column range where a ROI's pooled
weights are non-zero. The backward kernels walk, for each tile of the
map, only the ROIs whose spans meet it, so a span must cover every
non-zero tap; these plain spans are exact (both ends are taps), and the
kernels' spans are held against them on the card by chip_smoke.py (wider
is allowed, a missed tap is not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from livecell_tpu.ops.pallas_ms_roi import assign_levels as j_assign_levels
from livecell_tpu.ops.pallas_roi_align import roi_weights as j_roi_weights
from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
from livecell_tpu_torch.ops import cuda_roi_align as cra
from tests.test_torch_ms_roi import CASES, case
from tests.test_torch_roi_align import make_case

DTYPES = [torch.bfloat16, torch.float32]
HW = (14, 19)


def assert_exact_spans(spans, wy, wx):
    """spans [..., 4] cover every non-zero tap of Wy [..., n, H] and Wx
    [..., n, W], each end is a tap, and an axis without taps is (size,
    -1)."""
    spans = spans.numpy()
    for axis, wt in ((0, wy), (1, wx)):
        nz = (wt.float() != 0).any(dim=-2).numpy()       # [..., size]
        size = nz.shape[-1]
        lo, hi = spans[..., 2 * axis], spans[..., 2 * axis + 1]
        idx = np.arange(size)
        covered = (idx >= lo[..., None]) & (idx <= hi[..., None])
        assert not (nz & ~covered).any(), "a non-zero tap lies outside"
        some = nz.any(-1)
        np.testing.assert_array_equal(lo[~some], size)
        np.testing.assert_array_equal(hi[~some], -1)
        ends = np.take_along_axis(nz, np.stack([lo, hi], -1).clip(
            0, size - 1), -1)
        assert ends[some].all(), "a span's end is not a tap"


def edge_boxes():
    """[1, 8, 4] boxes on the 56x76 input of a 14x19 map: thinner than a
    pixel on each axis, across each border, wholly outside on each side,
    a point, and the whole map."""
    return np.array([[[10.0, 12.0, 11.5, 40.0], [20.0, 8.0, 50.0, 9.0],
                      [-30.0, -20.0, 12.0, 9.0], [60.0, 44.0, 90.0, 70.0],
                      [-90.0, 10.0, -40.0, 30.0], [10.0, 120.0, 40.0, 160.0],
                      [33.0, 21.0, 33.0, 21.0], [0.0, 0.0, 76.0, 56.0]]],
                    np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("boxes", ["make_case", "edges"])
def test_roi_spans_cover_the_weights_exactly(dtype, boxes):
    bx = make_case(b=2, k=6)[1] if boxes == "make_case" else edge_boxes()
    wy, wx = cra.roi_weights_plain(torch.from_numpy(bx), HW, 7, 2, 0.25,
                                   dtype)
    spans = cra.roi_spans_plain(wy, wx)
    assert spans.dtype == torch.int32
    assert tuple(spans.shape) == bx.shape[:2] + (4,)
    assert_exact_spans(spans, wy, wx)


def test_roi_spans_of_edge_boxes():
    wy, wx = cra.roi_weights_plain(torch.from_numpy(edge_boxes()), HW)
    s = cra.roi_spans_plain(wy, wx)[0].tolist()
    # Thinner than a pixel: one or two columns (the side floors at 1).
    assert s[0][3] - s[0][2] <= 2 and s[1][1] - s[1][0] <= 2
    # Across the top-left border: starts at row and column 0.
    assert s[2][0] == 0 and s[2][2] == 0
    # Wholly outside (left, below): that axis is empty; the ROI meets no
    # tile.
    assert s[4][2:] == [19, -1] and s[5][:2] == [14, -1]
    # The whole map.
    assert s[7] == [0, 13, 0, 18]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(*[st.floats(-120.0, 220.0, width=32)] * 2,
                          *[st.floats(0.0, 150.0, width=32)] * 2),
                min_size=1, max_size=6),
       st.sampled_from(DTYPES), st.sampled_from([7, 14]))
def test_roi_spans_cover_random_boxes(rows, dtype, n):
    bx = np.array([[[x, y, x + w, y + h] for x, y, w, h in rows]],
                  np.float32)
    wy, wx = cra.roi_weights_plain(torch.from_numpy(bx), HW, n, 2, 0.25,
                                   dtype)
    assert_exact_spans(cra.roi_spans_plain(wy, wx), wy, wx)


def test_roi_spans_cover_the_pallas_weights():
    """The same boxes' weights from the JAX package's Pallas `roi_weights`
    (interpret mode): every non-zero tap lies in the port's span."""
    _, boxes = make_case(k=6)
    boxes_p = np.concatenate([boxes, np.zeros((1, 2, 4), np.float32)], 1)
    wy_j, wx_j = j_roi_weights(jnp.asarray(boxes_p), *HW, 8, 7, 2, 0.25,
                               interpret=True)
    spans = cra.roi_spans_plain(*cra.roi_weights_plain(
        torch.from_numpy(boxes), HW)).numpy()
    for axis, wt in ((0, wy_j), (1, wx_j)):
        nz = np.asarray(wt[:, :6, :7].astype(jnp.float32)) != 0
        nz = nz.any(-2)
        idx = np.arange(nz.shape[-1])
        inside = (idx >= spans[..., 2 * axis, None]) \
            & (idx <= spans[..., 2 * axis + 1, None])
        assert not (nz & ~inside).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,out_size", CASES)
def test_ms_roi_spans_cover_each_level(name, out_size, dtype):
    feats, boxes = case(name)
    bt = torch.from_numpy(boxes)
    levels = cms.assign_levels(bt)
    hw = [f.shape[1:3] for f in feats]
    spans = cms.ms_roi_spans_plain(bt, levels, hw, out_size, 2, dtype)
    assert spans.dtype == torch.int32
    assert tuple(spans.shape) == (4,) + boxes.shape[:2] + (4,)
    for lvl in range(4):
        wy, wx = cms.level_weights(bt, levels, lvl, hw[lvl], out_size, 2,
                                   dtype)
        assert_exact_spans(spans[lvl], wy, wx)
        # Every other level's ROIs have an empty span here.
        other = (levels != lvl).numpy()
        h, w = hw[lvl]
        assert (spans[lvl].numpy()[other] == [h, -1, w, -1]).all()
    # Each ROI has a span on its own level only (these boxes all reach
    # their maps).
    own = (spans[..., 1] >= 0).numpy()                   # [4, B, K]
    np.testing.assert_array_equal(own.argmax(0), levels.numpy())
    assert (own.sum(0) == 1).all()


def test_ms_roi_spans_follow_the_jax_levels():
    """The level whose span is non-empty is the JAX package's LevelMapper
    level."""
    feats, boxes = case("mixed")
    hw = [f.shape[1:3] for f in feats]
    want = np.asarray(j_assign_levels(jnp.asarray(boxes)))
    bt = torch.from_numpy(boxes)
    spans = cms.ms_roi_spans_plain(bt, cms.assign_levels(bt), hw)
    np.testing.assert_array_equal((spans[..., 1] >= 0).numpy().argmax(0),
                                  want)


def test_span_wrappers_take_plain_on_cpu():
    _, boxes = make_case(b=2, k=6)
    wy, wx = cra.roi_weights_plain(torch.from_numpy(boxes), HW)
    assert torch.equal(cra.roi_spans(wy, wx), cra.roi_spans_plain(wy, wx))
    feats, mboxes = case("elongated")
    bt = torch.from_numpy(mboxes)
    levels = cms.assign_levels(bt)
    hw = [f.shape[1:3] for f in feats]
    assert torch.equal(cms.ms_roi_spans(bt, levels, hw, 14),
                       cms.ms_roi_spans_plain(bt, levels, hw, 14))


def test_span_wrappers_refuse_non_cuda_tensors():
    wy, wx = cra.roi_weights_plain(torch.from_numpy(edge_boxes()), HW)
    with pytest.raises(ValueError, match="CUDA"):
        cra.roi_spans(wy.to("meta"), wx.to("meta"))
    with pytest.raises(ValueError, match="dtype"):
        cra.roi_spans(wy.to("meta"), wx.float().to("meta"))
    bt = torch.from_numpy(edge_boxes()).to("meta")
    lv = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    hw = [(14, 19), (7, 10), (4, 5), (2, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        cms.ms_roi_spans(bt, lv, hw)
    with pytest.raises(ValueError, match="int32"):
        cms.ms_roi_spans(bt, lv.long(), hw)
