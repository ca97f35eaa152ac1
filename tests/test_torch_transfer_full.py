"""The transfer model at its full geometry, port vs JAX, on the CPU in
f32: TransferConfig()'s 224x304 input tile resized 3.57x to 800x1086
and padded to the 800x1088 canvas, R50-FPN over P2-P6, 1,000
proposals, 100 detections. tests/test_torch_transfer.py holds the
slice at a TINY geometry, which skips that resize and the pad. One
tile, JAX's seed-0 weights converted (models/convert.py) with that
file's predictor scaling; JAX runs its gather MultiScaleRoIAlign and
matmuls at "highest", the port its plain versions (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from livecell_tpu.models import transfer as jtr
from livecell_tpu_torch.config import TransferConfig
from livecell_tpu_torch.models import transfer as tr
from livecell_tpu_torch.models.convert import from_jax_variables
from tests.test_torch_transfer import PREDICTOR_SCALE

JCFG = jtr.TransferConfig(roi_backend="xla", rpn_match_backend="xla",
                          compute_dtype="float32")
PCFG = TransferConfig(compute_dtype="float32")


def jax_variables():
    _, v = jtr.create_transfer_model(rng=jax.random.key(0), cfg=JCFG)
    v = jax.tree.map(lambda x: np.array(x, np.float32), v)
    for path, s in PREDICTOR_SCALE.items():
        node = v["params"]
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = node[path[-1]] * np.float32(s)
    return v


def test_full_geometry_inference_matches_jax():
    assert (PCFG.image_height, PCFG.resized_width, PCFG.image_width) == (
        800, 1086, 1088)
    assert (PCFG.tile_height, PCFG.tile_width) == (224, 304)
    v = jax_variables()
    x = np.random.default_rng(0).uniform(size=(1, 224, 304, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.tree.map(np.asarray, jax.jit(
            lambda v, x: jtr.TransferMaskRCNN(JCFG).apply(v, x, train=False)
        )(v, jnp.asarray(x)))
    model = tr.create_transfer_model(PCFG, device="cpu")
    model.load_state_dict(from_jax_variables(v), strict=True)
    got = model.inference_forward(torch.from_numpy(x))

    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    ok = want.valid
    assert ok.sum() == 100
    # f32 through R50-FPN at the canvas, the heads and the decoders, and
    # the unscale by 304/1086: boxes within 2e-3 px of a 304 px tile
    # (measured 1.007e-3), scores within 1e-5 (measured 3.8e-6), mask
    # probabilities within 1e-4 (measured 8.6e-5).
    np.testing.assert_allclose(got.boxes.numpy()[ok], want.boxes[ok],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.scores.numpy()[ok], want.scores[ok],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.mask_probs.numpy()[ok],
                               want.mask_probs[ok], rtol=0, atol=1e-4)
