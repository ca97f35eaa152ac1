"""The tap lists of the forward RoIAlign kernels (K2, K5):
`roi_taps_plain` (ops/cuda_roi_align.py) and `ms_roi_bin_windows_plain`
(ops/cuda_ms_roi_align.py), the plain versions of what each kernel block
builds in shared memory before it gathers.

A tap list holds, for one weight row of one ROI, the pixels whose pooled
weight is non-zero, in ascending order, with their weights. K2 reads them
off K1's rows; K5 computes the weights from the box only over a window
per bin, so the window must cover every non-zero weight of the row. The
kernels' lists are held against the plain versions on the card by
chip_smoke.py through their outputs (equal to the plain forward bit for
bit).
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
from livecell_tpu_torch.ops import cuda_roi_align as cra
from tests.test_torch_ms_roi import CASES, case
from tests.test_torch_roi_align import make_case
from tests.test_torch_roi_spans import edge_boxes

DTYPES = [torch.bfloat16, torch.float32]
HW = (14, 19)


def assert_lists(wy, wx, ratio):
    """roi_taps_plain's lists of Wy [..., n, H], Wx [..., n, W]: scattered
    back they give the rows exactly, each holds at most 2 * ratio taps,
    in ascending pixel order, and nothing but non-zero weights."""
    index, weight, count = cra.roi_taps_plain(wy, wx)
    n = wy.shape[-2]
    assert index.dtype == count.dtype == torch.int32
    assert weight.dtype == torch.float32
    assert tuple(count.shape) == tuple(wy.shape[:-2]) + (2 * n,)
    assert int(count.max()) <= 2 * ratio
    live = index >= 0
    np.testing.assert_array_equal(live.sum(-1).numpy(), count.numpy())
    # Live entries first, in strictly ascending pixel order.
    assert not (~live[..., :-1] & live[..., 1:]).any()
    steps = index[..., 1:] - index[..., :-1]
    assert (steps[live[..., 1:]] > 0).all()
    assert (weight[live] != 0).all() and (weight[~live] == 0).all()
    for rows, part in ((wy, slice(0, n)), (wx, slice(n, 2 * n))):
        back = torch.zeros(rows.shape, dtype=torch.float32)
        idx, wt = index[..., part, :], weight[..., part, :]
        # Entries past a row's end add 0 to pixel 0.
        back.scatter_add_(-1, idx.clamp(min=0).long(), wt)
        assert torch.equal(back, rows.float())
    return index, count


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("boxes", ["make_case", "edges"])
def test_taps_scatter_back_to_the_weights(dtype, boxes):
    """Boxes thinner than a pixel, across the border and wholly outside
    the map (edge_boxes), and make_case's boxes."""
    bx = make_case(b=2, k=6)[1] if boxes == "make_case" else edge_boxes()
    wy, wx = cra.roi_weights_plain(torch.from_numpy(bx), HW, 7, 2, 0.25,
                                   dtype)
    assert_lists(wy, wx, 2)


def test_taps_of_edge_boxes():
    wy, wx = cra.roi_weights_plain(torch.from_numpy(edge_boxes()), HW)
    _, count = assert_lists(wy, wx, 2)
    count = count[0]
    # Wholly outside (left; below): that axis has no tap in any bin.
    assert (count[4, 7:] == 0).all() and (count[5, :7] == 0).all()
    # Thinner than a pixel along x: the side floors at one pixel, so each
    # bin's two samples lie within one pixel and touch at most 2 or 3.
    assert (count[0, 7:] <= 3).all() and (count[0, 7:] >= 1).all()


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(*[st.floats(-120.0, 220.0, width=32)] * 2,
                          *[st.floats(0.0, 150.0, width=32)] * 2),
                min_size=1, max_size=6),
       st.sampled_from(DTYPES), st.sampled_from([7, 14]),
       st.sampled_from([1, 2]))
def test_taps_of_random_boxes(rows, dtype, n, ratio):
    bx = np.array([[[x, y, x + w, y + h] for x, y, w, h in rows]],
                  np.float32)
    wy, wx = cra.roi_weights_plain(torch.from_numpy(bx), HW, n, ratio, 0.25,
                                   dtype)
    assert_lists(wy, wx, ratio)


def test_lists_are_not_cut_above_the_kernel_ratio():
    """Weights of sampling ratio 6 on wide bins have rows of up to 12
    taps, more than a kernel list holds (2 * MAX_RATIO): the plain lists
    keep them all, and K2 gathers such a ROI from its weight rows."""
    # Bins of about 11 pixels: six samples 1.8 pixels apart.
    boxes = torch.tensor([[[0.0, 0.0, 300.0, 220.0]]])
    wy, wx = cra.roi_weights_plain(boxes, (56, 76), 7, 6)
    index, count = assert_lists(wy, wx, 6)
    assert int(count.max()) > 2 * cra.MAX_RATIO
    assert index.shape[-1] == int(count.max())


def assert_windows_cover(boxes, levels, hw, n, ratio, dtype, bounded=True):
    """Every non-zero weight of a ROI's rows on its own level lies in the
    row's window, and (`bounded`) a row has at most 2 * ratio of them;
    returns the windows [B, K, 2n, 2]."""
    win = cms.ms_roi_bin_windows_plain(boxes, levels, hw, n, ratio)
    assert win.dtype == torch.int32
    assert tuple(win.shape) == tuple(boxes.shape[:2]) + (2 * n, 2)
    lo, hi = win[..., 0, None], win[..., 1, None]
    assert (lo <= hi).all()
    for lvl, (h, w) in enumerate(hw):
        on = levels == lvl
        if not on.any():
            continue
        wy, wx = cms.level_weights(boxes, levels, lvl, (h, w), n, ratio,
                                   dtype)
        for rows, part, size in ((wy, slice(0, n), h), (wx, slice(n, None),
                                                         w)):
            pix = torch.arange(size)
            inside = (pix >= lo[..., part, :]) & (pix <= hi[..., part, :])
            nz = rows.float() != 0
            assert not (nz & ~inside)[on].any(), "a tap lies outside"
            assert (lo[..., part, :][on] >= 0).all()
            assert (hi[..., part, :][on] <= size - 1).all()
        if bounded:
            # At most 2 * ratio taps a row: the kernel's lists hold them.
            _, count = assert_lists(wy, wx, ratio)
            assert int(count[on].max()) <= 2 * ratio
    return win


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,out_size", CASES)
def test_bin_windows_cover_each_level(name, out_size, dtype):
    """test_torch_ms_roi.py's mixed boxes (every level) and elongated
    boxes, at 7x7 and 14x14."""
    feats, boxes = case(name)
    bt = torch.from_numpy(boxes)
    hw = [tuple(f.shape[1:3]) for f in feats]
    assert_windows_cover(bt, cms.assign_levels(bt), hw, out_size, 2, dtype)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(*[st.floats(-200.0, 700.0, width=32)] * 2,
                          *[st.floats(0.0, 900.0, width=32)] * 2,
                          st.integers(0, 3)),
                min_size=1, max_size=6),
       st.sampled_from(DTYPES), st.sampled_from([7, 14]),
       st.sampled_from([1, 2]))
def test_bin_windows_cover_random_boxes(rows, dtype, n, ratio):
    """Any box on any level: thin, past the border, outside the map."""
    feats, _ = case("mixed")
    hw = [tuple(f.shape[1:3]) for f in feats]
    bx = torch.tensor([[[x, y, x + w, y + h] for x, y, w, h, _ in rows]])
    lv = torch.tensor([[lv for *_, lv in rows]], dtype=torch.int32)
    assert_windows_cover(bx, lv, hw, n, ratio, dtype)


def test_bin_windows_of_edge_boxes():
    hw = [(14, 19), (7, 10), (4, 5), (2, 3)]
    bt = torch.from_numpy(edge_boxes())
    lv = torch.zeros((1, 8), dtype=torch.int32)
    win = assert_windows_cover(bt, lv, hw, 7, 2, torch.bfloat16)[0]
    # A window is its bin's samples widened by two pixels.
    width = win[..., 1] - win[..., 0] + 1
    assert (width >= 1).all()
    assert (width[6] <= 6).all()                 # a point
    # Wholly left of the map: each x window is its first pixels.
    assert (win[4, 7:, 0] == 0).all() and (win[4, 7:, 1] <= 2).all()
    # The whole map: the windows of the 7 bins cover it.
    assert win[7, 0, 0] == 0 and win[7, 6, 1] == 13
    assert win[7, 7, 0] == 0 and win[7, 13, 1] == 18


def test_nan_box_window_is_the_whole_axis():
    """A NaN end point: the window is the whole axis (the plain weights
    are NaN on every pixel, the kernel's pooled_weight 0: no tap)."""
    hw = [(14, 19), (7, 10), (4, 5), (2, 3)]
    bt = torch.tensor([[[math.nan, 3.0, 20.0, math.nan]]])
    lv = torch.tensor([[1]], dtype=torch.int32)
    win = assert_windows_cover(bt, lv, hw, 7, 2, torch.float32,
                               bounded=False)[0, 0]
    assert win[:, 0].tolist() == [0] * 14
    assert win[:, 1].tolist() == [6] * 7 + [9] * 7


def test_fwd_wrappers_refuse_what_the_kernels_cannot_take():
    """On the meta device (no data) K2's and K5's wrappers take the
    kernel's road: they check the gather's limits (at most 16 bins,
    channels in 16-byte vectors of 8, K5 a sampling ratio of 1 to
    MAX_RATIO), then reject a non-CUDA tensor before any launch. No map
    is too large any more: the lists do not grow with it."""
    _, boxes = make_case(k=3)
    bt = torch.from_numpy(boxes)

    def k2(n=7, c=8, hw=HW):
        wy, wx = cra.roi_weights_plain(bt, hw, n)
        feat = torch.zeros((1,) + tuple(hw) + (c,), dtype=torch.bfloat16,
                           device="meta")
        return [feat, wy.to("meta"), wx.to("meta")]

    with pytest.raises(ValueError, match="CUDA"):
        cra.roi_align_fwd(*k2())
    # 14 rows of 10,000 pixels: 0.5 MB of full weight rows.
    with pytest.raises(ValueError, match="CUDA"):
        cra.roi_align_fwd(*k2(hw=(2000, 8000)))
    with pytest.raises(ValueError, match="multiples of 8"):
        cra.roi_align_fwd(*k2(c=12))
    with pytest.raises(ValueError, match="at most 16 bins"):
        cra.roi_align_fwd(*k2(n=17))
    feat, wy, wx = k2()
    with pytest.raises(ValueError, match="same dtype"):
        cra.roi_align_fwd(feat, wy.float(), wx)

    mb = bt.to("meta")
    lv = torch.zeros((1, 3), dtype=torch.int32, device="meta")

    def pyramid(c=8, h=200, w=4000):
        return [torch.zeros((1, h >> i, w >> i, c), dtype=torch.bfloat16,
                            device="meta") for i in range(4)]

    with pytest.raises(ValueError, match="CUDA"):
        cms.ms_roi_align_fwd(pyramid(), mb, lv, 14)
    with pytest.raises(ValueError, match="multiples of 8"):
        cms.ms_roi_align_fwd(pyramid(c=20), mb, lv)
    with pytest.raises(ValueError, match="at most 16 bins"):
        cms.ms_roi_align_fwd(pyramid(), mb, lv, 17)
    for ratio in (0, cra.MAX_RATIO + 1):
        with pytest.raises(ValueError, match="sampling_ratio"):
            cms.ms_roi_align_fwd(pyramid(), mb, lv, 7, ratio)
    with pytest.raises(ValueError, match="int32 levels"):
        cms.ms_roi_align_fwd(pyramid(), mb, lv.long())


def test_fwd_wrappers_take_plain_on_cpu_at_any_ratio():
    """On CPU tensors neither limit applies: the plain versions run."""
    feats, boxes = case("elongated")
    fs = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    bt = torch.from_numpy(boxes)
    lv = cms.assign_levels(bt)
    before = (cra.roi_align_fwd.launches, cms.ms_roi_align_fwd.launches)
    got = cms.ms_roi_align_fwd(fs, bt, lv, 7, 3)
    assert torch.equal(got, cms.ms_roi_align_fwd_plain(fs, bt, lv, 7, 3))
    wy, wx = cra.roi_weights_plain(bt, fs[0].shape[1:3], 7, 3, 0.25,
                                   torch.bfloat16)
    assert torch.equal(cra.roi_align_fwd(fs[0], wy, wx),
                       cra.roi_align_fwd_plain(fs[0], wy, wx))
    assert (cra.roi_align_fwd.launches,
            cms.ms_roi_align_fwd.launches) == before
