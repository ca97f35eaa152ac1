"""The multiscale RoIAlign of the port (ops/cuda_ms_roi_align.py: the
level assignment and the plain versions of K5 and K6) vs the JAX package:
the Pallas composition `ms_roi_align_pallas` in interpret mode (bf16) and
the f32 gather `multiscale_roi_align`, forward and backward.

On these CPU tensors the wrappers take the plain versions; the kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.ops.pallas_ms_roi import assign_levels as j_assign_levels
from livecell_tpu.ops.pallas_ms_roi import ms_roi_align_pallas
from livecell_tpu.ops.roi_align import multiscale_roi_align as j_ms_roi
from livecell_tpu_torch.ops import cuda_ms_roi_align as cms
from livecell_tpu_torch.ops.roi_align import multiscale_roi_align

# Thin-but-long ROIs on a 160x256 canvas (tests/test_pallas_ms_roi.py:76-96):
# the LevelMapper bounds sqrt(area), not each axis, so a low level's ROI
# can span most of the map.
ELONGATED = [[4.0, 10.0, 250.0, 18.0], [30.0, 2.0, 38.0, 155.0],
             [0.0, 0.0, 256.0, 160.0], [100.0, 50.0, 140.0, 90.0]]


def make_pyramid(rng, b, h2, w2, c=8):
    feats, h, w = [], h2, w2
    for _ in range(4):
        feats.append(rng.normal(size=(b, h, w, c)).astype(np.float32))
        h, w = -(-h // 2), -(-w // 2)
    return feats


def mixed_boxes(rng, b, k, img_h, img_w):
    """Sides from 4 to 700 px, some past the canvas, so every level is
    used."""
    out = np.zeros((b, k, 4), np.float32)
    for bi in range(b):
        for ki in range(k):
            scale = rng.choice([30, 100, 250, 500, 700])
            x1 = rng.uniform(-20, img_w - 20)
            y1 = rng.uniform(-20, img_h - 20)
            out[bi, ki] = [x1, y1, x1 + rng.uniform(0.5, 1.0) * scale,
                           y1 + rng.uniform(0.5, 1.0) * scale]
    return out


@functools.lru_cache(maxsize=None)
def case(name):
    """(pyramid [4 x [B,H,W,C]], boxes [B,K,4]) as numpy."""
    rng = np.random.default_rng({"mixed": 0, "elongated": 1}[name])
    if name == "mixed":
        return make_pyramid(rng, 2, 32, 48), mixed_boxes(rng, 2, 16, 128, 192)
    return make_pyramid(rng, 1, 40, 64), np.array([ELONGATED], np.float32)


CASES = [("mixed", 7), ("mixed", 14), ("elongated", 7), ("elongated", 14)]


def port(feats, dtype):
    return [torch.from_numpy(f).to(dtype) for f in feats]


def levels_used(boxes):
    return set(np.asarray(j_assign_levels(jnp.asarray(boxes))).ravel())


def test_cases_use_every_level():
    assert levels_used(case("mixed")[1]) == {0, 1, 2, 3}
    assert len(levels_used(case("elongated")[1])) >= 2


@pytest.mark.parametrize("name,out_size", CASES)
def test_forward_bf16_matches_pallas(name, out_size):
    feats, boxes = case(name)
    want = np.asarray(ms_roi_align_pallas(
        tuple(jnp.asarray(f, jnp.bfloat16) for f in feats),
        jnp.asarray(boxes), out_size, 2, True).astype(jnp.float32))
    got = cms.ms_roi_align(port(feats, torch.bfloat16),
                           torch.from_numpy(boxes), out_size)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == boxes.shape[:2] + (out_size, out_size, 8)
    # K2's tolerance: the same rounding points (bf16 weights, bf16 row
    # result, bf16 output) after f32 sums in another order, which can flip
    # a bf16 rounding: 2 bf16 ulps at the output's magnitude.
    tol = 2 * 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("name,out_size", CASES)
def test_forward_f32_matches_gather(name, out_size):
    feats, boxes = case(name)
    want = np.asarray(jax.vmap(
        lambda fs, bx: j_ms_roi(fs, bx, out_size))(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes)))
    got = cms.ms_roi_align(port(feats, torch.float32),
                           torch.from_numpy(boxes), out_size).numpy()
    ref = multiscale_roi_align(port(feats, torch.float32),
                               torch.from_numpy(boxes), out_size).numpy()
    # Both sum the same bilinear taps in f32 in another order: 1e-5 of
    # the output's magnitude.
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert np.abs(ref - want).max() <= tol


def loss_weights(shape, seed=3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name,out_size", [("mixed", 7), ("elongated", 14)])
def test_backward_bf16_matches_pallas_vjp(name, out_size):
    feats, boxes = case(name)
    wts = loss_weights(boxes.shape[:2] + (out_size, out_size, 8))

    def loss(fs):
        out = ms_roi_align_pallas(fs, jnp.asarray(boxes), out_size, 2, True)
        return jnp.sum(out.astype(jnp.float32) * wts)

    want = jax.grad(loss)(tuple(jnp.asarray(f, jnp.bfloat16) for f in feats))
    fs = [f.requires_grad_() for f in port(feats, torch.bfloat16)]
    out = cms.ms_roi_align(fs, torch.from_numpy(boxes), out_size)
    (out.float() * torch.from_numpy(wts)).sum().backward()
    for f, w in zip(fs, want):
        w = np.asarray(w.astype(jnp.float32))
        assert f.grad.dtype == torch.bfloat16
        # K3's tolerance: g and u rounded to bf16, dF summed in f32 and
        # rounded once, in both; the f32 sums run in another order: 2 bf16
        # ulps at the gradient's magnitude.
        tol = 2 * 2.0 ** -7 * max(np.abs(w).max(), 1e-6)
        assert np.abs(f.grad.float().numpy() - w).max() <= tol


@pytest.mark.parametrize("name,out_size", [("mixed", 7), ("elongated", 14)])
def test_backward_f32_matches_gather_grad(name, out_size):
    feats, boxes = case(name)
    wts = loss_weights(boxes.shape[:2] + (out_size, out_size, 8))

    def loss(fs):
        out = jax.vmap(lambda f, bx: j_ms_roi(f, bx, out_size))(
            fs, jnp.asarray(boxes))
        return jnp.sum(out * wts)

    want = jax.grad(loss)(tuple(jnp.asarray(f) for f in feats))
    fs = [f.requires_grad_() for f in port(feats, torch.float32)]
    boxes_t = torch.from_numpy(boxes).requires_grad_()
    out = cms.ms_roi_align(fs, boxes_t, out_size)
    (out * torch.from_numpy(wts)).sum().backward()
    assert boxes_t.grad is None            # boxes get no gradient
    for f, w in zip(fs, want):
        w = np.asarray(w)
        # f32 sums over the same taps in another order: 1e-5 of the
        # gradient's magnitude.
        tol = 1e-5 * max(np.abs(w).max(), 1e-6)
        assert np.abs(f.grad.numpy() - w).max() <= tol


def boundary_boxes():
    """Squares whose sqrt(area)/224 is exactly 1/4, 1/2, 1, 2, 4 (the
    LevelMapper's level boundaries), their neighbours a pixel either
    side, degenerate and clamped sizes, and random boxes."""
    sides = [56.0, 112.0, 224.0, 448.0, 896.0]
    rows = []
    for s in sides:
        for d in (-1.0, 0.0, 1.0):
            rows.append([10.0, 20.0, 10.0 + s + d, 20.0 + s + d])
    rows += [[5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 2000.0, 2000.0],
             [3.0, 4.0, 3.5, 900.0], [0.0, 0.0, 112.0, 448.0]]
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 400, (40, 2))
    wh = np.exp(rng.uniform(np.log(2.0), np.log(900.0), (40, 2)))
    rows += np.concatenate([xy, xy + wh], axis=1).tolist()
    return np.asarray(rows, np.float32)[None]


def test_assign_levels_matches_jax():
    boxes = boundary_boxes()
    want = np.asarray(j_assign_levels(jnp.asarray(boxes)))
    got = cms.assign_levels(torch.from_numpy(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The exact boundaries land on the upper level, as in torchvision
    # (56 px is the lowest level's own boundary; 896 px clamps to P5).
    assert want[0, 1:15:3].tolist() == [0, 1, 2, 3, 3]
    assert want[0, 3:12:3].tolist() == [0, 1, 2]


def test_plain_forward_is_the_per_level_composition():
    """K5's plain version gives each ROI the single-level RoIAlign (K1 then
    K2, plain) of its own level at scale 0.25 / 2^l."""
    from livecell_tpu_torch.ops.cuda_roi_align import roi_align_plain

    feats, boxes = case("mixed")
    bt = torch.from_numpy(boxes)
    levels = cms.assign_levels(bt).numpy()
    ts = port(feats, torch.float32)
    got = cms.ms_roi_align_fwd_plain(ts, bt, torch.from_numpy(levels))
    for lvl, f in enumerate(ts):
        want = roi_align_plain(f, bt, 7, 0.25 / 2 ** lvl)
        on = levels == lvl
        # The same f32 contraction per ROI: equal up to the matmul's
        # blocking, 1e-6 of the magnitude.
        np.testing.assert_allclose(got.numpy()[on], want.numpy()[on],
                                   rtol=0, atol=1e-6 * want.abs().max())


def test_wrappers_take_plain_on_cpu_and_count_no_launch():
    feats, boxes = case("elongated")
    before = (cms.ms_roi_align_fwd.launches, cms.ms_roi_align_bwd.launches)
    for backend in ("auto", "plain"):
        fs = [f.requires_grad_() for f in port(feats, torch.bfloat16)]
        cms.ms_roi_align(fs, torch.from_numpy(boxes), 7,
                         backend=backend).float().sum().backward()
        assert all(f.grad is not None for f in fs)
    assert (cms.ms_roi_align_fwd.launches,
            cms.ms_roi_align_bwd.launches) == before
    with pytest.raises(ValueError):
        cms.ms_roi_align(port(feats, torch.bfloat16),
                         torch.from_numpy(boxes), backend="kernel")
    with pytest.raises(ValueError):
        cms.ms_roi_align(port(feats, torch.bfloat16),
                         torch.from_numpy(boxes), backend="pallas")


def test_bwd_wrapper_refuses_what_the_kernel_cannot_take():
    """On the meta device (no data) K6's wrapper takes the kernel's road:
    it checks the tiled kernel's limits (at most 16 bins, channels in
    16-byte vectors of 8, four maps), then rejects a non-CUDA tensor
    before any launch. No level is too wide any more."""
    _, boxes = case("elongated")
    bt = torch.from_numpy(boxes).to("meta")
    lv = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    hw = [(200, 4000), (100, 2000), (50, 1000), (25, 500)]

    def g(n=7, c=8):
        return torch.zeros((1, 4, n, n, c), dtype=torch.bfloat16,
                           device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        cms.ms_roi_align_bwd(g(), bt, lv, hw)
    with pytest.raises(ValueError, match="multiples of 8"):
        cms.ms_roi_align_bwd(g(c=20), bt, lv, hw)
    with pytest.raises(ValueError, match="at most 16 bins"):
        cms.ms_roi_align_bwd(g(n=17), bt, lv, hw)
    with pytest.raises(ValueError, match="4 maps"):
        cms.ms_roi_align_bwd(g(), bt, lv, hw[:3])
    with pytest.raises(ValueError, match="int32 levels"):
        cms.ms_roi_align_bwd(g(), bt, lv.long(), hw)
