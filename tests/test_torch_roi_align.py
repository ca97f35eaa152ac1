"""The RoIAlign kernels' plain versions (ops/cuda_roi_align.py) and the
plain f32 RoIAlign (ops/roi_align.py) vs the JAX package: the Pallas
kernels in interpret mode and the f32 einsum path.

On these CPU tensors the wrappers take the plain versions; the kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.ops.pallas_roi_align import roi_align_pallas, roi_weights
from livecell_tpu.ops.roi_align import roi_align as j_roi_align_single
from livecell_tpu.ops.roi_align import roi_align_batched as j_roi_align
from livecell_tpu_torch.ops import cuda_roi_align as cra
from livecell_tpu_torch.ops.roi_align import roi_align, roi_align_batched

BF16_ULP_BELOW_1 = 2.0 ** -8    # one bf16 ulp in [0.5, 1)


def make_case(seed=0, b=1, h=14, w=19, c=128, k=6):
    """The small case of tests/test_pallas_roi_align.py, plus boxes that
    cross the map's border and boxes thinner than one feature pixel."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    boxes = np.zeros((b, k, 4), np.float32)
    x1 = rng.uniform(0, 60, (b, k))
    y1 = rng.uniform(0, 40, (b, k))
    boxes[..., 0] = x1
    boxes[..., 1] = y1
    boxes[..., 2] = x1 + rng.uniform(5, 30, (b, k))
    boxes[..., 3] = y1 + rng.uniform(5, 30, (b, k))
    boxes[:, 0] = [-12.0, -7.5, 20.0, 15.0]              # crosses top-left
    boxes[:, 1] = [4 * w - 9.0, 4 * h - 6.0, 4 * w + 20, 4 * h + 9]
    if k > 2:
        boxes[:, 2, 2] = boxes[:, 2, 0] + 1.5             # < 1 feature px
    return feat, boxes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_weights_plain_matches_pallas_weights(dtype):
    _, boxes = make_case()
    k = boxes.shape[1]
    # The Pallas kernel pads K to a multiple of 8 and n 7 -> 8.
    boxes_p = np.concatenate([boxes, np.zeros((1, 8 - k, 4), np.float32)], 1)
    wy_j, wx_j = roi_weights(jnp.asarray(boxes_p), 14, 19, 8, 7, 2, 0.25,
                             interpret=True)
    wy, wx = cra.roi_weights_plain(torch.from_numpy(boxes), (14, 19), 7, 2,
                                   0.25, dtype)
    assert wy.dtype == dtype and tuple(wy.shape) == (1, k, 7, 14)
    for got, want in ((wy, wy_j), (wx, wx_j)):
        want = np.asarray(want[:, :k, :7].astype(jnp.float32))
        # Both compute in f32 and round once to bf16 (the JAX weights are
        # always bf16); f32 reassociation can flip one bf16 ulp.
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_ULP_BELOW_1)


@pytest.mark.parametrize("k", [6, 3])
def test_roi_align_plain_matches_pallas(k):
    feat, boxes = make_case(k=k)
    want = np.asarray(roi_align_pallas(jnp.asarray(feat), jnp.asarray(boxes),
                                       interpret=True).astype(jnp.float32))
    got = cra.roi_align_plain(torch.from_numpy(feat).to(torch.bfloat16),
                              torch.from_numpy(boxes))
    assert got.dtype == torch.bfloat16 and got.shape == (1, k, 7, 7, 128)
    # Same rounding points (bf16 weights, bf16 row result, bf16 out);
    # the f32 sums run in another order, which can flip a bf16 rounding:
    # allow 2 bf16 ulps at the output's magnitude.
    tol = 2 * 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("k", [6, 3])
def test_roi_align_plain_f32_matches_einsum(k):
    feat, boxes = make_case(k=k)
    want = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                                  precision="highest"))
    got = cra.roi_align_plain(torch.from_numpy(feat), torch.from_numpy(boxes))
    assert got.dtype == torch.float32
    # f32 throughout: reassociation only.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_roi_align_plain_bf16_error_bound():
    """The JAX package's own bound for its bf16 kernel: error at most 3x
    that of the bf16-input default-precision einsum."""
    feat, boxes = make_case()
    f, bx = jnp.asarray(feat), jnp.asarray(boxes)
    out_hi = np.asarray(j_roi_align(f, bx, precision="highest"))
    out_df = np.asarray(j_roi_align(f.astype(jnp.bfloat16), bx,
                                    precision="default").astype(jnp.float32))
    got = cra.roi_align_plain(torch.from_numpy(feat).to(torch.bfloat16),
                              torch.from_numpy(boxes)).float().numpy()
    err = np.abs(got - out_hi).max()
    err_df = np.abs(out_df - out_hi).max()
    assert err < 3 * max(err_df, 1e-3), (err, err_df)


@pytest.mark.parametrize("b", [1, 2])
def test_port_roi_align_f32_matches_jax(b):
    feat, boxes = make_case(seed=b, b=b)
    want = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                                  precision="highest"))
    got = roi_align_batched(torch.from_numpy(feat), torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    single = roi_align(torch.from_numpy(feat[-1]), torch.from_numpy(boxes[-1]))
    want1 = np.asarray(j_roi_align_single(
        jnp.asarray(feat[-1]), jnp.asarray(boxes[-1]), precision="highest"))
    np.testing.assert_allclose(single.numpy(), want1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_takes_plain_on_cpu(backend, dtype):
    feat, boxes = make_case()
    before = (cra.roi_weights.launches, cra.roi_align_fwd.launches)
    f = torch.from_numpy(feat).to(dtype)
    got = cra.roi_align(f, torch.from_numpy(boxes), backend=backend)
    want = cra.roi_align_plain(f, torch.from_numpy(boxes))
    assert torch.equal(got, want)
    # No kernel ran: the counters count kernel launches only.
    assert (cra.roi_weights.launches, cra.roi_align_fwd.launches) == before
    assert before == (0, 0)


def test_kernel_backend_refuses_cpu_tensors():
    feat, boxes = make_case()
    with pytest.raises(ValueError, match="CUDA"):
        cra.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                      backend="kernel")
    with pytest.raises(ValueError, match="roi_backend"):
        cra.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                      backend="einsum")
