"""The port's FLOP counter (livecell_tpu_torch/utils/flops.py) against
the JAX package's (livecell_tpu/utils/flops.py), on the CPU.

JAX's four toy cases (tests/test_flops.py) must count the same, and
the TINY train steps (custom quirk and flagship modes, transfer) and
inference forwards must count what JAX's count_flops charges the same
step traced with its Pallas routes (roi_backend / match_backend
"pallas", whose kernels JAX charges as grid x body): to 1e-9 relative,
once the named terms below are taken out. Each is work JAX's traced
program holds and the port does not run:

  * DEAD_LEVELS: the custom model's forwards (training and inference)
    in JAX compute
    the FPN output convolutions and the RPN (its 3x3 convolution and
    its 1x1 heads, an einsum there) on pyramid levels 1-3, whose
    outputs no loss reads: make_jaxpr keeps that dead code, XLA drops
    it when it compiles. The port computes level 0 only. Per level of
    h x w: 2 B h w C (9 C) for each 3x3 convolution and 2 B h w C (5 A)
    for the heads (A anchors a cell: A logits, 4 A deltas).
  * MASK_SUBSET: the flagship mode's mask head runs on m of the K
    sampled ROIs, which JAX selects with a one-hot dot_general
    (mask_rcnn.py:285-291) and its transpose in the backward: 2 x
    2 B m K (s s C). The port gathers the rows.

and one the port charges that JAX computes without a dot_general:

  * NMS_SWEEPS: the transfer model's iterated NMS (ops/nms.py:
    nms_iterated) finds the suppressed boxes of a sweep with a 0/1
    product [1, N] x [N, N] where JAX takes jnp.any; it runs all 32
    sweeps: 2 M N N x 32 for M problems of N boxes (the proposals' B x
    5 levels, and at inference also the detections' B of P).

The plain route (roi_backend / match_backend "plain", the plain
versions called directly) counts the same as the kernel wrappers'
charges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from livecell_tpu.models import transfer as jtr
from livecell_tpu.models.mask_rcnn import CustomMaskRCNN as JaxMaskRCNN
from livecell_tpu.parallel.train_step import TrainState
from livecell_tpu.parallel.train_step import make_step_fn as jax_step_fn
from livecell_tpu.utils.flops import count_flops as jax_count
from livecell_tpu_torch.parallel.train_step import (
    build_optimizer, make_step_fn)
from livecell_tpu_torch.utils.flops import FlopCounter, count_flops
from tests import test_torch_train as ttrain
from tests import test_torch_transfer as ttransfer
from tests.util_torch_port import images as port_images

REL = 1e-9


# ---------------------------------------------------------------------------
# JAX's toy cases.
# ---------------------------------------------------------------------------

def test_matmul_flops():
    a, b = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    want = jax_count(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert want == 2 * 8 * 16 * 4
    assert count_flops(lambda x, y: x @ y, torch.from_numpy(a),
                       torch.from_numpy(b)) == want


def test_conv_flops():
    def jconv(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = jax_count(jconv, jnp.ones((2, 10, 10, 5)), jnp.ones((3, 3, 5, 7)))
    assert want == 2 * (2 * 10 * 10 * 7) * (3 * 3 * 5)
    got = count_flops(lambda x, k: F.conv2d(x, k, padding=1),
                      torch.ones(2, 5, 10, 10), torch.ones(7, 5, 3, 3))
    assert got == want


def test_grad_counts_backward():
    def jloss(w, x):
        return ((x @ w) ** 2).sum()

    w, x = np.ones((16, 4), np.float32), np.ones((8, 16), np.float32)
    f_fwd = jax_count(jloss, jnp.asarray(w), jnp.asarray(x))
    f_grad = jax_count(jax.grad(jloss), jnp.asarray(w), jnp.asarray(x))

    def grad(w, x):
        w = w.clone().requires_grad_(True)
        return torch.autograd.grad(((x @ w) ** 2).sum(), w)[0]

    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    assert count_flops(lambda w, x: ((x @ w) ** 2).sum(), tw, tx) == f_fwd
    assert count_flops(grad, tw, tx) == f_grad >= 2 * f_fwd


def test_nested_call_counted():
    inner = jax.jit(lambda a, b: a @ b)
    want = jax_count(lambda a, b: inner(a, b).sum(), jnp.ones((8, 16)),
                     jnp.ones((16, 4)))

    def inner_t(a, b):
        return torch.nn.functional.linear(a, b.t())

    got = count_flops(lambda a, b: inner_t(a, b).sum(), torch.ones(8, 16),
                      torch.ones(16, 4))
    assert got == want == 2 * 8 * 16 * 4


@pytest.mark.parametrize("transposed", [False, True])
def test_strided_conv_backward_follows_jax(transposed):
    """A stride-2 convolution's input gradient is charged over the
    input's shape (4x the forward at equal widths), its weight gradient
    as the forward; the transposed convolution (lhs-dilated in JAX) in
    the mirror image. Both against JAX's autodiff of the same layer."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    k = rng.normal(size=(2, 2, 6, 6) if transposed else (3, 3, 6, 6)
                   ).astype(np.float32)

    def jconv(x, k):
        if transposed:
            y = jax.lax.conv_transpose(x, k, (2, 2), "VALID",
                                       dimension_numbers=("NHWC", "HWIO",
                                                          "NHWC"))
        else:
            y = jax.lax.conv_general_dilated(
                x, k, (2, 2), ((1, 1), (1, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return (y ** 2).sum()

    want = jax_count(jax.grad(jconv, argnums=(0, 1)), jnp.asarray(x),
                     jnp.asarray(k))

    def tconv(x, k):
        x = x.requires_grad_(True)
        k = k.requires_grad_(True)
        if transposed:
            y = F.conv_transpose2d(x, k, stride=2)
        else:
            y = F.conv2d(x, k, stride=2, padding=1)
        return torch.autograd.grad((y ** 2).sum(), (x, k))

    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    # HWIO -> torch: [out, in, kh, kw], transposed [in, out, kh, kw]; the
    # values do not matter to the count.
    tk = torch.from_numpy(k).permute(2, 3, 0, 1).contiguous()
    assert count_flops(tconv, tx, tk) == want


# ---------------------------------------------------------------------------
# The TINY steps and forwards.
# ---------------------------------------------------------------------------

def dead_levels(model, b: int) -> float:
    """DEAD_LEVELS of the custom model: the FPN output and RPN
    convolutions and the RPN heads on levels 1-3."""
    c = model.cfg
    with torch.no_grad():
        feats = model.extract_features(torch.zeros(
            1, c.image_height, c.image_width, 3))
    ch, a = c.fpn_channels, c.num_anchors_per_cell
    return sum(2.0 * b * f.shape[1] * f.shape[2] * ch * (2 * 9 * ch + 5 * a)
               for f in feats[1:])


def mask_subset(cfg, b: int) -> float:
    s = cfg.roi_output_size
    return 2 * 2.0 * b * cfg.mask_train_samples * cfg.train_num_samples \
        * s * s * cfg.fpn_channels


def nms_sweeps(model, b: int, inference: bool = False) -> float:
    """NMS_SWEEPS of the transfer model."""
    c = model.cfg
    ks = [min(c.rpn_pre_topk_per_level, a.shape[0])
          for a in model.anchors(torch.device("cpu"))]
    total = 2.0 * b * len(ks) * max(ks) ** 2 * 32
    if inference:
        total += 2.0 * b * model.proposal_count() ** 2 * 32
    return total


def jax_custom_step_flops(mode, images, targets) -> float:
    cfg = dataclasses.replace(ttrain.jax_cfg(**mode), roi_backend="pallas",
                              match_backend="pallas",
                              roi_precision="default")
    model = JaxMaskRCNN(cfg)
    v = ttrain.variables()
    tx = optax.adamw(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    return jax_count(jax_step_fn(model, tx), state, jnp.asarray(images),
                     {k: jnp.asarray(x) for k, x in targets.items()},
                     jax.random.key(0))


def port_step_flops(model, images, targets, **routes) -> float:
    for k, v in routes.items():
        model.cfg = dataclasses.replace(model.cfg, **{k: v})
    opt = build_optimizer(model, 1e-3, 1e-4, 1)
    step = make_step_fn(model, opt)
    return count_flops(step, images, targets,
                       generator=torch.Generator().manual_seed(0))


MODES = {"quirk": ttrain.QUIRK,
         "flagship": dict(ttrain.FIXED, frozen_bn=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_custom_train_step_matches_jax(mode):
    images, targets = ttrain.make_batch(3)
    want = jax_custom_step_flops(MODES[mode], images, targets)
    model = ttrain.port_model(ttrain.port_cfg(**MODES[mode]))
    terms = dead_levels(model, 2)
    if mode == "flagship":
        terms += mask_subset(model.cfg, 2)
    got = port_step_flops(model, *ttrain.to_torch(images, targets))
    assert got == pytest.approx(want - terms, rel=REL)
    # The plain route calls the plain versions themselves.
    plain = port_step_flops(
        ttrain.port_model(ttrain.port_cfg(**MODES[mode])),
        *ttrain.to_torch(images, targets), roi_backend="plain",
        match_backend="plain")
    assert plain == got


def test_custom_step_charges_the_kernels():
    images, targets = ttrain.make_batch(3)
    model = ttrain.port_model(ttrain.port_cfg(**MODES["flagship"]))
    opt = build_optimizer(model, 1e-3, 1e-4, 1)
    with FlopCounter() as counter:
        make_step_fn(model, opt)(*ttrain.to_torch(images, targets),
                                 generator=torch.Generator().manual_seed(0))
    by_op = dict(counter.by_op)
    # K2 and K3 share one charge; K4 is charged for its full call; K1
    # and the plain einsums inside the wrappers add nothing.
    assert by_op["roi_align_fwd"] == by_op["roi_align_bwd"] > 0
    assert by_op["match_anchors"] > 0 and by_op["roi_weights"] == 0
    assert counter.total == pytest.approx(sum(by_op.values()), rel=REL)


def test_custom_inference_matches_jax():
    x = port_images(5)
    cfg = dataclasses.replace(ttrain.jax_cfg(), roi_backend="pallas",
                              roi_precision="default")
    v = ttrain.variables()
    want = jax_count(lambda v, x: JaxMaskRCNN(cfg).apply(v, x, train=False),
                     v, jnp.asarray(x))
    model = ttrain.port_model(ttrain.port_cfg()).eval()
    got = count_flops(model.inference_forward, torch.from_numpy(x))
    assert got == pytest.approx(want - dead_levels(model, len(x)), rel=REL)


def test_transfer_train_step_matches_jax():
    images, targets = ttransfer.batch(1)
    v = ttransfer.jax_variables()
    jmodel = jtr.TransferMaskRCNN(dataclasses.replace(
        ttransfer.JCFG, roi_backend="pallas", rpn_match_backend="pallas"))
    tx = optax.sgd(5e-3, momentum=0.9)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    want = jax_count(jax_step_fn(jmodel, tx), state, jnp.asarray(images),
                     {k: jnp.asarray(x) for k, x in targets.items()},
                     jax.random.key(1))

    def step_flops(**routes):
        model = ttransfer.port_model(train=True)
        model.cfg = dataclasses.replace(model.cfg, **routes)
        opt = torch.optim.SGD(model.parameters(), lr=5e-3, momentum=0.9)
        return count_flops(make_step_fn(model, opt),
                           torch.from_numpy(images),
                           ttransfer.torch_targets(targets),
                           generator=torch.Generator().manual_seed(0))

    got = step_flops()
    model = ttransfer.port_model()
    assert got == pytest.approx(want + nms_sweeps(model, len(images)),
                                rel=REL)
    assert step_flops(roi_backend="plain", rpn_match_backend="plain") == got


def test_transfer_inference_matches_jax():
    images, _ = ttransfer.batch(0)
    jmodel = jtr.TransferMaskRCNN(dataclasses.replace(
        ttransfer.JCFG, roi_backend="pallas"))
    want = jax_count(lambda v, x: jmodel.apply(v, x, train=False),
                     ttransfer.jax_variables(), jnp.asarray(images))
    model = ttransfer.port_model()
    got = count_flops(model.inference_forward, torch.from_numpy(images))
    assert got == pytest.approx(
        want + nms_sweeps(model, len(images), inference=True), rel=REL)
    model.cfg = dataclasses.replace(model.cfg, roi_backend="plain")
    assert count_flops(model.inference_forward,
                       torch.from_numpy(images)) == got


def test_inference_mode_counts_the_same():
    """Under torch.inference_mode (the frame predictor's) the composite
    ops reach the counter whole and are counted through their
    decompositions: the same count as under no_grad."""
    x = torch.from_numpy(port_images(5))
    model = ttrain.port_model(ttrain.port_cfg()).eval()
    want = count_flops(model.inference_forward, x)
    with torch.inference_mode():
        assert count_flops(model.inference_forward, x) == want > 0
