"""K1's decomposition on the CPU: `roi_weights_rows_plain`
(ops/cuda_roi_align.py) replays what csrc/roi_align.cu:roi_weights_kernel
computes (each weight row's constants once, the taps only on the pixels
its valid samples lie within one pixel of, +0 elsewhere) and must equal
the plain version `roi_weights_plain` bit for bit, in f32 and bf16, at
sampling ratios 1-6. On boxes with a NaN or infinite end point the plain
version gives NaN weights while the kernel's fmaxf floors a NaN side at
one pixel: there the replay is held against the first kernel's
per-element formula (roi_common.cuh:pooled_weight), replayed in numpy.
The kernel is held against the plain version and against its parent on
the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from livecell_tpu_torch.ops import cuda_roi_align as cra
from tests.test_torch_roi_align import make_case
from tests.test_torch_roi_spans import edge_boxes

DTYPES = [torch.bfloat16, torch.float32]
HW = (14, 19)
RATIOS = [1, 2, 3, 4, 5, 6]


def assert_equal(boxes, hw, n, ratio, dtype):
    bt = torch.from_numpy(np.asarray(boxes, np.float32))
    got = cra.roi_weights_rows_plain(bt, hw, n, ratio, 0.25, dtype)
    want = cra.roi_weights_plain(bt, hw, n, ratio, 0.25, dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and torch.equal(g, w)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("boxes", ["make_case", "edges"])
def test_rows_equal_plain(boxes, ratio, dtype):
    """make_case's boxes, and edge_boxes: thinner than a pixel, across
    each border, wholly outside, a point, the whole map."""
    bx = make_case(b=2, k=6)[1] if boxes == "make_case" else edge_boxes()
    for n in (7, 14):
        assert_equal(bx, HW, n, ratio, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_at_the_training_map(dtype):
    """The 56x76 map of the custom model's 224x304 input, map-sized and
    larger boxes at sampling ratio 6 (rows of up to 12 taps) too."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-40, 280, (2, 40, 2))
    wh = rng.uniform(0, 150, (2, 40, 2))
    bx = np.concatenate([xy, xy + wh], -1)
    bx[0, :3] = [[0, 0, 304, 224], [-100, -60, 394, 294], [30, 20, 250, 190]]
    for ratio in (2, 6):
        assert_equal(bx, (56, 76), 7, ratio, dtype)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(*[st.floats(-120.0, 220.0, width=32)] * 2,
                          *[st.floats(0.0, 150.0, width=32)] * 2),
                min_size=1, max_size=6),
       st.sampled_from(DTYPES), st.sampled_from([1, 7, 14]),
       st.sampled_from(RATIOS), st.sampled_from([(14, 19), (3, 5), (1, 9)]))
def test_rows_of_random_boxes(rows, dtype, n, ratio, hw):
    """Any finite box, on maps narrower than a 16-byte vector too (rows
    of 1, 3 and 5 pixels: a vector spans several rows)."""
    bx = [[[x, y, x + w, y + h] for x, y, w, h in rows]]
    assert_equal(bx, hw, n, ratio, dtype)


def pooled_weight(lo, hi, scale, n, size, ratio, p, g):
    """roi_common.cuh:pooled_weight in numpy float32: the first kernel's
    weight of bin p on pixel g, one element at a time."""
    f = np.float32
    start = f(lo) * f(scale)
    bin_sz = np.fmax(f(hi) * f(scale) - start, f(1)) / f(n)
    acc = f(0)
    for s in range(ratio):
        c = start + (f(p) + f((s + 0.5) / ratio)) * bin_sz
        if c >= -1 and c <= size:
            cc = min(max(c, f(0)), f(size - 1))
            acc = acc + np.fmax(f(0), f(1) - abs(cc - f(g)))
    return acc / f(ratio)


@pytest.mark.parametrize("ratio", [2, 6])
def test_non_finite_boxes_follow_the_kernel(ratio):
    """A NaN or infinite end point: a NaN sample fails c >= -1 and weighs
    0, an infinite side leaves no sample on the map, and a NaN upper end
    floors the side at one pixel (fmaxf). The plain version gives NaN
    wherever a sample is NaN."""
    nan, inf = math.nan, math.inf
    bx = [[[nan, 3.0, 20.0, nan], [-inf, 4.0, 30.0, inf],
           [5.0, -inf, inf, 40.0], [inf, 8.0, -inf, 12.0],
           [6.0, 9.0, nan, 14.0]]]
    n = 7
    got = cra.roi_weights_rows_plain(torch.tensor(bx), HW, n, ratio, 0.25,
                                     torch.float32)
    with np.errstate(invalid="ignore"):
        for axis, (lo_i, hi_i, size) in enumerate(((1, 3, HW[0]),
                                                   (0, 2, HW[1]))):
            want = np.array([[[[pooled_weight(b[lo_i], b[hi_i], 0.25, n,
                                              size, ratio, p, g)
                                for g in range(size)] for p in range(n)]
                              for b in bx[0]]], np.float32)
            np.testing.assert_array_equal(got[axis].numpy(), want)
    # A NaN upper end: finite, non-zero weights one pixel wide a bin.
    wx = got[1][0, 4]
    assert torch.isfinite(wx).all() and (wx != 0).any()
    assert torch.isnan(cra.roi_weights_plain(torch.tensor(bx), HW, n, ratio,
                                             0.25, torch.float32)[1][0, 4]
                       ).all()


def test_weights_wrapper_refuses_what_the_kernel_cannot_take():
    """On the meta device (no data) K1's wrapper takes the kernel's road:
    a sampling ratio below 1 and tensors of 2^31 weights or more are
    refused, then any non-CUDA tensor; CPU tensors take the plain
    version at any ratio."""
    bt = torch.from_numpy(edge_boxes())
    with pytest.raises(ValueError, match="sampling_ratio"):
        cra.roi_weights(bt.to("meta"), HW, 7, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        cra.roi_weights(torch.zeros((64, 4096, 4), device="meta"),
                        (1024, 2048), 7, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cra.roi_weights(bt.to("meta"), HW, 7, 6)
    before = cra.roi_weights.launches
    for got, want in zip(cra.roi_weights(bt, HW, 7, 3),
                         cra.roi_weights_plain(bt, HW, 7, 3)):
        assert torch.equal(got, want)
    assert cra.roi_weights.launches == before
