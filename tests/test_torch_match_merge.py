"""K4's decomposition on the CPU: `match_anchors_emulated`
(ops/cuda_match.py) replays what csrc/match.cu computes (each chunk of GT
slots staged as its valid GT only, an anchor's max over the pairs with a
positive intersection, chunk results and each GT's warp reports merged as
packed 64-bit keys, key 0 meaning anchor 0) and must equal the plain
version `match_anchors_plain` bit for bit (`torch.equal` on max IoU,
targets and best anchor) at any chunk size. The kernel itself is held
against the plain version and against its parent on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from livecell_tpu_torch.ops import cuda_match as cm
from livecell_tpu_torch.ops.anchors import generate_anchors
from tests.test_torch_match import N_GRID, make_case

CHUNKS = [1, 7, 256, None]          # None: one chunk of every slot


def assert_equal(anchors, gt, valid, full, chunk):
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (anchors, gt, valid)]
    got = cm.match_anchors_emulated(*args, full=full, chunk=chunk)
    want = cm.match_anchors_plain(*args, full=full)
    if not full:
        got, want = (got,), (want,)
    for name, g, w in zip(("max_iou", "targets", "best"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    return got


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n,b,i", [(N_GRID, 2, 8), (N_GRID, 2, 13),
                                   (700, 2, 13)])
@pytest.mark.parametrize("full", [True, False])
def test_emulation_equals_plain(n, b, i, full, chunk):
    """make_case: an anchor-equal GT, a duplicate GT, a box between two
    anchor centres (ties both ways) and an all-invalid last image."""
    anchors, gt, valid = make_case(n + i, n, b, i)
    assert_equal(anchors, gt, valid, full, chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_quirk_shape(chunk):
    """Quirk mode's one [1, B*I] call: the GT of every image in one row,
    the chunked path of the kernel."""
    anchors, gt, valid = make_case(5, N_GRID, 2, 13)
    assert_equal(anchors, gt.reshape(1, -1, 4), valid.reshape(1, -1), True,
                 chunk)


def test_all_invalid_image_is_minus_one_and_gt_zero():
    anchors, gt, valid = make_case(3, 700, 2, 13)
    mx, tgt, best = assert_equal(anchors, gt, valid, True, 7)
    assert (mx[1] == -1.0).all() and (best[1] == 0).all()
    # Every anchor of the empty image encodes GT 0.
    one = cm.match_anchors_plain(
        torch.from_numpy(anchors), torch.from_numpy(gt[1:, :1]).expand(
            1, 13, 4).contiguous(), torch.ones((1, 13), dtype=torch.bool))
    assert torch.equal(tgt[1], one[1][0])


@pytest.mark.parametrize("chunk", [1, 2, None])
def test_gt_that_meets_no_anchor(chunk):
    """A valid GT far outside every anchor keeps key 0: its best anchor is
    anchor 0 (its IoU is +0 everywhere). As the image's first valid GT it
    is also the match of every anchor that overlaps nothing."""
    anchors = generate_anchors((40, 40)).copy()
    gt = np.array([[[900.0, 900.0, 950.0, 940.0], [4.0, 4.0, 20.0, 24.0],
                    [10.0, 2.0, 30.0, 12.0]]], np.float32)
    valid = np.ones((1, 3), bool)
    mx, tgt, best = assert_equal(anchors, gt, valid, True, chunk)
    assert best[0, 0] == 0 and best[0, 1] > 0
    alone = (mx[0] == 0).nonzero()[:, 0]
    assert len(alone) > 0
    # Their targets are GT 0's.
    far = cm.match_anchors_plain(torch.from_numpy(anchors),
                                 torch.from_numpy(gt[:, :1]),
                                 torch.ones((1, 1), dtype=torch.bool))
    assert torch.equal(tgt[0][:, alone], far[1][0][:, alone])


@pytest.mark.parametrize("chunk", [1, 2, None])
def test_first_valid_slot_is_the_default_match(chunk):
    """Slots 0 and 1 invalid (one overlapping the anchors), slot 2 valid
    and far away: an anchor that overlaps no valid GT matches slot 2, the
    image's first valid one (per chunk, then merged by atomicMin)."""
    anchors = generate_anchors((40, 40)).copy()
    gt = np.array([[[4.0, 4.0, 20.0, 24.0], [6.0, 6.0, 30.0, 30.0],
                    [900.0, 900.0, 950.0, 940.0], [10.0, 2.0, 30.0, 12.0]]],
                  np.float32)
    valid = np.array([[False, False, True, True]])
    mx, tgt, best = assert_equal(anchors, gt, valid, True, chunk)
    alone = (mx[0] == 0).nonzero()[:, 0]
    far = cm.match_anchors_plain(torch.from_numpy(anchors),
                                 torch.from_numpy(gt[:, 2:3]),
                                 torch.ones((1, 1), dtype=torch.bool))
    assert len(alone) > 0
    assert torch.equal(tgt[0][:, alone], far[1][0][:, alone])
    assert best[0, :3].tolist() == [0, 0, 0] and best[0, 3] > 0


@pytest.mark.parametrize("chunk", [1, 3, None])
def test_zero_area_and_duplicate_gt(chunk):
    """A zero-area GT (never a positive intersection), a zero-area GT on
    an anchor's corner, and duplicates: ties go to the first slot."""
    anchors = generate_anchors((10, 12)).copy()
    a = anchors[137]
    gt = np.array([[[20.0, 20.0, 20.0, 40.0], [a[0], a[1], a[0], a[1]],
                    [8.0, 8.0, 40.0, 30.0], [8.0, 8.0, 40.0, 30.0],
                    list(a), list(a), [30.0, 5.0, 44.0, 5.0]]], np.float32)
    valid = np.array([[True, True, True, True, False, True, True]])
    mx, _, best = assert_equal(anchors, gt, valid, True, chunk)
    assert best[0, 0] == 0 and best[0, 1] == 0 and best[0, 6] == 0
    assert best[0, 2] == best[0, 3]
    assert best[0, 5] == 137 and mx[0, 137] == 1.0
    assert best[0, 4] == 0                       # invalid


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(*[st.floats(-20.0, 100.0, width=32)] * 2,
                          *[st.floats(-5.0, 60.0, width=32)] * 2,
                          st.booleans()),
                min_size=1, max_size=20),
       st.integers(1, 3), st.sampled_from([1, 3, 7, 128, None]),
       st.booleans(), st.integers(0, 2 ** 16))
def test_random_boxes(rows, b, chunk, full, seed):
    """Any finite boxes (inverted and empty ones too), any validity."""
    rng = np.random.default_rng(seed)
    anchors = np.zeros((300, 4), np.float32)
    anchors[:, :2] = rng.uniform(-10, 90, (300, 2))
    anchors[:, 2:] = anchors[:, :2] + rng.uniform(0, 50, (300, 2))
    one = np.array([[x, y, x + w, y + h] for x, y, w, h, _ in rows],
                   np.float32)
    gt = np.stack([np.roll(one, k, axis=0) for k in range(b)])
    valid = np.stack([np.roll([v for *_, v in rows], k) for k in range(b)])
    assert_equal(anchors, gt, valid.astype(bool), full, chunk)


def test_order_bits_is_monotone():
    """-1 (an invalid GT), -0, +0, subnormals, normals up to 1: larger
    floats get larger keys, and the packed key puts the lower index first
    among equal IoU."""
    tiny = np.finfo(np.float32).smallest_subnormal
    vals = np.array([-1.0, -0.0, 0.0, tiny, 2 * tiny, 1e-40,
                     np.finfo(np.float32).tiny, 1e-30, 0.25,
                     np.nextafter(np.float32(1), np.float32(0)), 1.0],
                    np.float32)
    bits = cm.order_bits(vals)
    assert bits.dtype == np.uint32
    assert (np.diff(bits.astype(np.int64)) > 0).all()
    # The positive ones come back from their bits (finalize's inverse).
    pos = vals > 0
    back = (bits[pos] & np.uint32(0x7fffffff)).view(np.float32)
    np.testing.assert_array_equal(back, vals[pos])
    keys = cm.pack_key(bits[[8, 8, 9]], np.array([5, 3, 9]))
    assert keys[1] > keys[0] and keys[2] > keys[1]


def test_wrapper_refuses_non_cuda_tensors():
    """The wrapper refuses non-CUDA tensors before any library call."""
    anchors, gt, valid = make_case(1, 700, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cm.match_anchors(*(torch.from_numpy(x).to("meta")
                           for x in (anchors, gt, valid)))
