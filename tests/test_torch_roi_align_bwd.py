"""K3's plain version (ops/cuda_roi_align.py:roi_align_bwd_plain, what
the wrapper computes on CPU tensors) and the autograd Function around
K1/K2 vs the JAX package's RoIAlign gradients: the Pallas custom VJP in
interpret mode (bf16) and the f32 einsum path at "highest".

The kernel is held against the same plain version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.ops.pallas_roi_align import roi_align_pallas
from livecell_tpu.ops.roi_align import roi_align_batched as j_roi_align
from livecell_tpu_torch.ops import cuda_roi_align as cra
from tests.test_torch_roi_align import make_case


def grad_out(seed, b, k, c, dtype=np.float32):
    return np.random.default_rng(seed).normal(
        size=(b, k, 7, 7, c)).astype(dtype)


def plain_bwd(g, boxes, dtype, hw=(14, 19)):
    wy, wx = cra.roi_weights_plain(torch.from_numpy(boxes), hw, 7, 2, 0.25,
                                   dtype)
    return cra.roi_align_bwd_plain(torch.from_numpy(g).to(dtype), wy, wx, hw)


@pytest.mark.parametrize("k", [6, 3])
def test_bwd_plain_bf16_matches_pallas_vjp(k):
    feat, boxes = make_case(k=k)
    g = grad_out(1, 1, k, 128)
    _, vjp = jax.vjp(lambda f: roi_align_pallas(f, jnp.asarray(boxes),
                                                interpret=True),
                     jnp.asarray(feat).astype(jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(g).astype(jnp.bfloat16))[0]
                      .astype(jnp.float32))
    got = plain_bwd(g, boxes, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 14, 19, 128)
    # Same rounding points (bf16 g and weights, u rounded to bf16, dF
    # summed in f32 and rounded once); the f32 sums run in another order,
    # which can flip a bf16 rounding: 2 bf16 ulps at the output's scale.
    tol = 2 * 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("k,b", [(6, 1), (3, 2)])
def test_bwd_plain_f32_matches_einsum_grad(k, b):
    feat, boxes = make_case(seed=b, b=b, k=k)
    g = grad_out(2, b, k, 128)
    _, vjp = jax.vjp(lambda f: j_roi_align(f, jnp.asarray(boxes),
                                           precision="highest"),
                     jnp.asarray(feat))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = plain_bwd(g, boxes, torch.float32)
    # f32 throughout: reassociation of the sums over ROIs and taps.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_runs_the_plain_backward(backend, dtype):
    feat, boxes = make_case(k=3)
    f = torch.from_numpy(feat).to(dtype).requires_grad_()
    bx = torch.from_numpy(boxes).requires_grad_()
    out = cra.roi_align(f, bx, backend=backend)
    assert torch.equal(out.detach(), cra.roi_align_plain(f.detach(),
                                                         bx.detach()))
    g = torch.from_numpy(grad_out(3, 1, 3, 128)).to(dtype)
    dfeat, dboxes = torch.autograd.grad(out, (f, bx), g, allow_unused=True)
    # Boxes get no gradient (the custom VJP's zeros, torchvision's none).
    assert dboxes is None
    assert torch.equal(dfeat, plain_bwd(g.float().numpy(), boxes, dtype))
    assert cra.roi_align_bwd.launches == 0


def test_wrapper_refuses_what_the_kernel_cannot_take():
    _, boxes = make_case(k=3)
    wy, wx = cra.roi_weights_plain(torch.from_numpy(boxes), (14, 19))
    g = torch.zeros((1, 3, 7, 7, 8), dtype=torch.bfloat16)
    # On the CPU the plain version runs whatever the dtype mix ...
    assert cra.roi_align_bwd(g, wy.float(), wx, (14, 19)).shape == \
        (1, 14, 19, 8)
    # ... on the meta device (no data) the wrapper takes the kernel's
    # road and rejects a non-CUDA tensor before any launch.
    with pytest.raises(ValueError, match="CUDA"):
        cra.roi_align_bwd(g.to("meta"), wy.to("meta"), wx.to("meta"),
                          (14, 19))
