"""K4's plain version (ops/cuda_match.py:match_anchors_plain, what the
wrapper computes on CPU tensors) vs the JAX package's matcher: the
Pallas kernel in interpret mode and the XLA path.

Tolerances are the JAX kernel's own (tests/test_pallas_match.py:45-47):
max IoU 1e-6 absolute, targets 1e-5, best anchor exact. The kernel is
held against the same plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.ops.pallas_match import (
    match_anchors_pallas, match_anchors_xla)
from livecell_tpu_torch.ops import cuda_match as cm
from livecell_tpu_torch.ops.anchors import generate_anchors
from livecell_tpu_torch.ops.boxes import box_iou

N_GRID = 16 * 24 * 9          # the anchors of the 64x96 test input


def make_case(seed, n, b, i):
    """Anchors (the 16x24 grid's, or n random ones) and b images of i GT
    slots. Image 0 holds a GT equal to an anchor, a duplicate of another
    GT and a box centred between two anchor centres (exact IoU ties
    between anchors); the last image has every slot invalid."""
    rng = np.random.default_rng(seed)
    if n == N_GRID:
        anchors = generate_anchors((16, 24)).copy()
    else:
        anchors = np.zeros((n, 4), np.float32)
        anchors[:, :2] = rng.uniform(0, 80, (n, 2))
        anchors[:, 2:] = anchors[:, :2] + rng.uniform(4, 60, (n, 2))
    gt = np.zeros((b, i, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 70, (b, i, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(8, 40, (b, i, 2))
    valid = rng.uniform(size=(b, i)) < 0.7
    gt[0, 0] = anchors[n // 3]
    gt[0, 1] = gt[0, 2]
    gt[0, 3] = [18.0, 10.0, 50.0, 42.0]     # centre x 34 = 2 mod 4
    valid[0, :4] = True
    valid[-1] = False
    return anchors, gt.astype(np.float32), valid


def jax_match(fn, anchors, gt, valid, full, **kw):
    out = jax.jit(fn, static_argnames=("full",) + tuple(kw))(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
        full=full, **kw)
    return jax.tree.map(np.asarray, out)


def port_match(anchors, gt, valid, full):
    out = cm.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gt),
                           torch.from_numpy(valid), full)
    return out.numpy() if not full else tuple(x.numpy() for x in out)


def assert_matches(got, want, full):
    if not full:
        got, want = (got,), (want,)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    if full:
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("n,b,i", [(N_GRID, 2, 8), (N_GRID, 2, 13),
                                   (700, 2, 13)])
@pytest.mark.parametrize("full", [True, False])
def test_plain_matches_pallas_and_xla(n, b, i, full):
    anchors, gt, valid = make_case(n + i, n, b, i)
    got = port_match(anchors, gt, valid, full)
    for want in (jax_match(match_anchors_pallas, anchors, gt, valid, full,
                           interpret=True),
                 jax_match(match_anchors_xla, anchors, gt, valid, full)):
        assert_matches(got, want, full)


@pytest.mark.parametrize("full", [True, False])
def test_quirk_shape_matches_pallas(full):
    """Quirk mode matches image 0's anchors against the batch's GT
    concatenated: one [1, B*I] call."""
    anchors, gt, valid = make_case(5, N_GRID, 2, 13)
    gt, valid = gt.reshape(1, -1, 4), valid.reshape(1, -1)
    assert_matches(port_match(anchors, gt, valid, full),
                   jax_match(match_anchors_pallas, anchors, gt, valid, full,
                             interpret=True), full)


def test_case_has_ties_and_an_empty_image():
    anchors, gt, valid = make_case(N_GRID + 8, N_GRID, 2, 8)
    ious = box_iou(torch.from_numpy(anchors), torch.from_numpy(gt[0])).numpy()
    # The box between two anchor centres: two anchors at its max IoU.
    assert (ious[:, 3] == ious[:, 3].max()).sum() >= 2
    # The duplicate GT: every anchor ties between slots 1 and 2.
    np.testing.assert_array_equal(ious[:, 1], ious[:, 2])
    mx, tgt, best = port_match(anchors, gt, valid, True)
    assert best[0, 0] == N_GRID // 3 and mx[0, N_GRID // 3] == 1.0
    tie = np.nonzero(ious[:, 3] == ious[:, 3].max())[0]
    assert best[0, 3] == tie[0]                       # the first anchor
    assert (mx[1] == -1.0).all() and (best[1] == 0).all()


def test_wrapper_takes_plain_on_cpu():
    anchors, gt, valid = make_case(1, 700, 2, 8)
    before = cm.match_anchors.launches
    got = port_match(anchors, gt, valid, True)
    want = cm.match_anchors_plain(torch.from_numpy(anchors),
                                  torch.from_numpy(gt),
                                  torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert cm.match_anchors.launches == before == 0
