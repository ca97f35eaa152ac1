"""The port's training slice vs the JAX package's, on the CPU at 64x96 and
f32: the detector losses and proposal sampling with JAX's own random
draws replayed, `train_forward`'s loss dict in quirk and fixed mode, the
gradients (carried into the port's layout by models/convert.py), the
batch-norm running statistics, the AdamW/StepLR update against optax,
a bf16 step, and a checkpoint round trip.

JAX runs its exact routes (XLA matcher, f32 einsum RoIAlign at
"highest", exact top-k), the port its plain versions (CPU tensors).
Selections (the proposal top-k above all) are asserted to have margins
well above the frameworks' f32 disagreement before losses are compared.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livecell_tpu.config import ModelConfig as JaxModelConfig
from livecell_tpu.config import TrainConfig as JaxTrainConfig
from livecell_tpu.models import detector as jdet
from livecell_tpu.models.mask_rcnn import CustomMaskRCNN as JaxMaskRCNN
from livecell_tpu.ops import proposals as jprop
from livecell_tpu.ops.pallas_match import match_anchors_xla
from livecell_tpu.parallel.train_step import _normalize_batch
from livecell_tpu.train.train_custom import build_optimizer as jax_optimizer
from livecell_tpu_torch.config import (
    ModelConfig, TrainConfig, strict_equivalence_config)
from livecell_tpu_torch.models import detector as det
from livecell_tpu_torch.models.convert import from_jax_variables
from livecell_tpu_torch.models.mask_rcnn import create_train_model
from livecell_tpu_torch.ops.anchors import generate_anchors
from livecell_tpu_torch.ops.cuda_match import match_anchors_plain
from livecell_tpu_torch.ops.proposals import sample_rows, training_proposals
from livecell_tpu_torch.parallel.train_step import (
    apply_update, build_optimizer, make_step_fn)
from livecell_tpu_torch.serve.app import InferenceEngine, load_model
from livecell_tpu_torch.train import checkpoint
from tests.util_torch_port import CFG_KW, jax_variables, min_gap

TRAIN_KW = dict(CFG_KW, max_instances=8, train_pre_topk=64,
                train_num_samples=32)
QUIRK = {}
# The flagship mode, deterministic: strict_equivalence_config keeps
# batch norm frozen.
FIXED = dict(heads_all_images=True, decode_proposals=True,
             mask_train_samples=16, frozen_bn=True)
N = 16 * 24 * 9
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)   # f32 through ~20 layers
# The proposal top-k must not flip between the frameworks, whose scores
# differ by ~3e-7.
MIN_GAP = 2e-6


def jax_cfg(**kw):
    return JaxModelConfig(roi_backend="einsum", match_backend="xla",
                          topk_backend="exact", **{**TRAIN_KW, **kw})


def port_cfg(**kw):
    return ModelConfig(**{**TRAIN_KW, **kw})


@functools.lru_cache(maxsize=1)
def variables():
    """The shared test weights with the RPN's objectness predictor at 30x
    its initial scale (util_torch_port's 300x saturates the sigmoid in
    train mode, giving exact score ties)."""
    v = jax.tree.map(np.array, jax_variables())
    v["params"]["rpn"]["cls_logits"]["kernel"] *= np.float32(0.1)
    return v


def make_batch(seed, b=2, slots=8, n_inst=5):
    """uint8 images and mask targets (the training pool's types), GT
    boxes of 20-44 px, n_inst valid slots per image."""
    rng = np.random.default_rng(seed)
    images = (rng.uniform(size=(b, 64, 96, 3)) * 255).astype(np.uint8)
    boxes = np.zeros((b, slots, 4), np.float32)
    xy = rng.uniform(0, [56, 24], (b, slots, 2))
    boxes[..., :2] = xy
    boxes[..., 2:] = xy + rng.uniform(20, 40, (b, slots, 2))
    valid = np.zeros((b, slots), bool)
    valid[:, :n_inst] = True
    mask28 = ((rng.uniform(size=(b, slots, 28, 28)) > 0.5) * 255).astype(
        np.uint8)
    return images, {"boxes": boxes, "valid": valid,
                    "labels": valid.astype(np.int32), "mask28": mask28}


def to_torch(images, targets):
    return torch.from_numpy(images), {k: torch.from_numpy(v)
                                      for k, v in targets.items()}


def jax_noise(cfg, key, b):
    """JAX's draws of train_forward, as the port's `noise` dict: the
    `sampling` key (flax's make_rng at the root scope), split as
    mask_rcnn.py:134-135, 207-208, detector.py:120-122, proposals.py:40."""
    root = JaxMaskRCNN(cfg).apply(
        variables(), method=lambda m: m.make_rng("sampling"),
        rngs={"sampling": key})
    k_rpn, k_prop = jax.random.split(root)
    kp_len = min(cfg.train_pre_topk, N)
    if cfg.heads_all_images:
        rpn_keys = jax.random.split(k_rpn, b)
        prop_keys = jax.random.split(k_prop, b)
    else:
        rpn_keys, prop_keys = k_rpn[None], k_prop[None]
    pos, neg, prop = [], [], []
    for kr, kq in zip(rpn_keys, prop_keys):
        kp, kn = jax.random.split(kr)
        pos.append(jax.random.uniform(kp, (N,)))
        neg.append(jax.random.uniform(kn, (N,)))
        prop.append(jax.random.uniform(kq, (kp_len,)))
    return {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for k, v in (("rpn_pos", pos), ("rpn_neg", neg),
                         ("proposals", prop))}


@functools.lru_cache(maxsize=None)
def jax_grad_fn(mode):
    """Jitted (params, batch_stats, images, targets, key) -> (losses,
    grads, new batch_stats) of the JAX train step's loss function."""
    model = JaxMaskRCNN(jax_cfg(**dict(mode)))

    def fn(params, stats, images, targets, key):
        images, targets = _normalize_batch(images, targets)

        def loss_fn(p):
            losses, mut = model.apply(
                {"params": p, "batch_stats": stats}, images, targets,
                train=True, rngs={"sampling": key}, mutable=["batch_stats"])
            return sum(losses.values()), (losses, mut["batch_stats"])

        (_, (losses, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return losses, grads, new_stats

    return jax.jit(fn)


def run_jax(mode, params, stats, images, targets, key):
    with jax.default_matmul_precision("highest"):
        out = jax_grad_fn(tuple(sorted(mode.items())))(
            params, stats, jnp.asarray(images),
            {k: jnp.asarray(v) for k, v in targets.items()}, key)
    return jax.tree.map(np.asarray, out)


def port_model(cfg):
    m = create_train_model(cfg, device="cpu")
    m.load_state_dict(from_jax_variables(variables()), strict=True)
    return m


def assert_proposal_margins(model, images, cfg):
    """The sorted objectness around every image's top-k boundary (and
    the top-k itself, whose order assigns the sample's uniforms) is
    spread wider than MIN_GAP. Runs on a copy: a train-mode forward moves
    the batch-norm statistics."""
    model = copy.deepcopy(model)
    x = torch.from_numpy(images).float() / 255.0
    with torch.no_grad():
        feat = model.extract_features(x, levels=1)[0]
        cls, _ = model.rpn([feat.permute(0, 3, 1, 2)])
    scores = torch.sigmoid(cls[0].reshape(x.shape[0], -1)).numpy()
    for s in scores[:x.shape[0] if cfg.heads_all_images else 1]:
        top = np.sort(s)[::-1][:cfg.train_pre_topk + 1]
        assert min_gap(top) > MIN_GAP
        assert np.abs(top - cfg.train_score_thresh).min() > MIN_GAP


def assert_losses_match(got, want, tol=LOSS_TOL):
    assert list(got) == list(want)            # same keys, same order
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **tol,
                                   err_msg=k)


def grads_as_port(grads):
    """A JAX gradient tree in the port's layout (the mapping is linear)."""
    return from_jax_variables({"params": grads})


def assert_grads_match(model, jgrads):
    want = grads_as_port(jgrads)
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want[name].numpy()
        # Per tensor, relative to its largest entry: f32 sums in another
        # order through ~20 layers of backward (and batch norm's
        # normalization in quirk mode) leave ~1e-5 of the scale.
        scale = max(np.abs(w).max(), 1e-8)
        err = np.abs(got.numpy() - w).max() / scale
        assert err < 1e-3, (name, err)


# ---------------------------------------------------------------------------
# Detector functions against JAX's, with JAX's draws.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(6, 20), (24, 20)])
def test_sample_rows_matches_jax(k, n):
    rng = np.random.default_rng(k)
    valid = rng.uniform(size=n) < 0.5
    key = jax.random.key(k)
    want_idx, want_ok = map(np.asarray, jprop.sample_rows(
        key, jnp.asarray(valid), k))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    idx, ok = sample_rows(u[None], torch.from_numpy(valid)[None], k)
    np.testing.assert_array_equal(idx[0].numpy(), want_idx)
    np.testing.assert_array_equal(ok[0].numpy(), want_ok)


@pytest.mark.parametrize("decode", [False, True])
def test_training_proposals_match_jax(decode):
    rng = np.random.default_rng(3)
    obj = rng.normal(0, 1, N).astype(np.float32)
    deltas = rng.normal(0, 0.2, (N, 4)).astype(np.float32)
    anchors = generate_anchors((16, 24))
    key = jax.random.key(4)
    want = jax.tree.map(np.asarray, jprop.training_proposals(
        jnp.asarray(obj), jnp.asarray(anchors), (64, 96), key, 64, 0.01,
        5.0, 32, deltas=jnp.asarray(deltas) if decode else None))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
    got = training_proposals(
        torch.from_numpy(obj)[None], torch.from_numpy(anchors), (64, 96),
        u[None], 64, 0.01, 5.0, 32,
        deltas=torch.from_numpy(deltas)[None] if decode else None)
    assert min_gap(1 / (1 + np.exp(-np.sort(obj)[-65:]))) > MIN_GAP
    np.testing.assert_array_equal(got.valid[0].numpy(), want.valid)
    np.testing.assert_allclose(got.boxes[0].numpy(), want.boxes, rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got.scores[0].numpy(), want.scores,
                               rtol=1e-6, atol=1e-7)
    assert want.valid.sum() >= 16


def rpn_case(seed, b=2, i=6, caps=None):
    """Anchors, GT (image b-1 without valid GT when b > 2) and K4's
    outputs from the plain matcher."""
    rng = np.random.default_rng(seed)
    anchors = generate_anchors((16, 24))
    gt = np.zeros((b, i, 4), np.float32)
    gt[..., :2] = rng.uniform(0, [60, 30], (b, i, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(20, 40, (b, i, 2))
    gt[0, 1] = gt[0, 0]                     # two GT share a best anchor
    valid = rng.uniform(size=(b, i)) < 0.8
    valid[0, :2] = True
    if b > 2:
        valid[-1] = False
    cfg = port_cfg(**(caps or {}))
    return anchors, gt, valid, cfg


@pytest.mark.parametrize("caps", [None, dict(rpn_pos_per_image=8,
                                             rpn_batch_per_image=16)])
def test_rpn_loss_matches_jax(caps):
    anchors, gt, valid, cfg = rpn_case(5, b=3, caps=caps)
    jcfg = jax_cfg(**(caps or {}))
    rng = np.random.default_rng(6)
    scores = rng.normal(0, 2, (3, N)).astype(np.float32)
    mx = match_anchors_plain(torch.from_numpy(anchors), torch.from_numpy(gt),
                             torch.from_numpy(valid), full=False)
    for bi in range(3):
        key = jax.random.key(10 + bi)
        want = float(jdet.rpn_loss_single(
            jnp.asarray(scores[bi]), jnp.asarray(anchors),
            jnp.asarray(gt[bi]), jnp.asarray(valid[bi]), key, jcfg))
        kp, kn = jax.random.split(key)
        u_pos = torch.from_numpy(np.array(jax.random.uniform(kp, (N,))))
        u_neg = torch.from_numpy(np.array(jax.random.uniform(kn, (N,))))
        got = float(det.rpn_loss_single(
            torch.from_numpy(scores[bi]), torch.from_numpy(valid[bi]),
            mx[bi], u_pos, u_neg, cfg))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        if bi == 2:
            assert got == pytest.approx(0.1)     # no valid GT


def test_rpn_reg_loss_matches_jax():
    anchors, gt, valid, cfg = rpn_case(7)
    deltas = np.random.default_rng(8).normal(0, 0.5, (2, N * 4)).astype(
        np.float32)
    jm = jax.tree.map(np.asarray, match_anchors_xla(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid)))
    mx, tgt, best = match_anchors_plain(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.from_numpy(valid))
    assert best[0, 0] == best[0, 1]          # the shared best anchor
    got = det.rpn_reg_loss_from_match(torch.from_numpy(deltas), mx, tgt,
                                      best, torch.from_numpy(valid), cfg)
    for bi in range(2):
        want = float(jdet.rpn_reg_loss_from_match(
            jnp.asarray(deltas[bi]), jm[0][bi], jm[1][bi], jm[2][bi],
            jnp.asarray(valid[bi]), jax_cfg()))
        np.testing.assert_allclose(float(got[bi]), want, rtol=1e-5)


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("batch_gt", [False, True])
def test_head_targets_and_losses_match_jax(decode, batch_gt):
    rng = np.random.default_rng(9)
    k, i = 24, 6
    anchors, gt, valid, _ = rpn_case(11, b=2, i=i)
    props = anchors[rng.choice(N, k, replace=False)]
    # Proposals on or near GT of both images, so the batch re-match
    # picks image 1's GT for some of image 0's proposals.
    props[:6] = gt[0, :6] + rng.normal(0, 2, (6, 4))
    props[6:10] = gt[1, :4] + rng.normal(0, 2, (4, 4))
    props = props.astype(np.float32)
    pvalid = rng.uniform(size=k) < 0.9
    masks = rng.uniform(size=(2, i, 28, 28)).astype(np.float32)
    cfg, jcfg = port_cfg(decode_proposals=decode), jax_cfg(
        decode_proposals=decode)
    j_mask_gt = (jnp.asarray(gt.reshape(-1, 4)), jnp.asarray(
        valid.reshape(-1)), jnp.asarray(masks.reshape(-1, 28, 28))) \
        if batch_gt else None
    want = jax.tree.map(np.asarray, jdet.match_head_targets(
        jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt[0]),
        jnp.asarray(valid[0]), jnp.asarray(masks[0]), jcfg, j_mask_gt))
    t = torch.from_numpy
    mask_gt = (t(gt.reshape(1, -1, 4)), t(valid.reshape(1, -1)),
               t(masks.reshape(1, -1, 28, 28))) if batch_gt else None
    got = det.match_head_targets(t(props)[None], t(pvalid)[None],
                                 t(gt[:1]), t(valid[:1]), t(masks[:1]), cfg,
                                 mask_gt)
    for f in det.HeadTargets._fields:
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   getattr(want, f), rtol=1e-6, atol=1e-6,
                                   err_msg=f)
    assert want.reg_weight.sum() >= 4 and want.mask_weight.sum() >= 4
    if batch_gt:
        # Some mask target came from image 1's instances.
        own = det.match_head_targets(t(props)[None], t(pvalid)[None],
                                     t(gt[:1]), t(valid[:1]), t(masks[:1]),
                                     cfg)
        assert not torch.equal(own.mask_targets, got.mask_targets)

    logits = rng.normal(size=(k, 2)).astype(np.float32)
    deltas = rng.normal(size=(k, 8)).astype(np.float32)
    mlogits = rng.normal(size=(k, 28, 28, 2)).astype(np.float32)
    jt = jdet.HeadTargets(*map(jnp.asarray, want))
    flat = det.HeadTargets(*(x[0] for x in got))
    want_l = jdet.box_losses(jnp.asarray(logits), jnp.asarray(deltas), jt)
    want_l["loss_mask"] = jdet.mask_loss(jnp.asarray(mlogits), jt)
    got_l = det.box_losses(t(logits), t(deltas), flat)
    got_l["loss_mask"] = det.mask_loss(t(mlogits), flat)
    assert_losses_match(got_l, want_l, dict(rtol=1e-5, atol=1e-7))


# ---------------------------------------------------------------------------
# The model's training forward, its gradients and batch statistics.
# ---------------------------------------------------------------------------

def port_step(mode, seed):
    """One step of the port and of JAX from the same weights, batch
    (seed) and draws (key seed + 1): (port model after the step, its
    metrics, JAX's (losses, grads, new batch_stats), the selections)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, targets = make_batch(seed)
    v = variables()
    key = jax.random.key(seed + 1)
    want = run_jax(mode, v["params"], v["batch_stats"], images, targets,
                   key)
    model = port_model(port_cfg(**mode))
    assert_proposal_margins(model, images, model.cfg)
    record = {}
    opt = build_optimizer(model, 1e-3, 1e-4, 1)
    metrics = make_step_fn(model, opt)(
        *to_torch(images, targets), noise=jax_noise(jax_cfg(**mode), key, 2),
        record=record)
    return model, metrics, want, record


@pytest.fixture(scope="module")
def quirk_step():
    """One quirk-mode step, batch 2, batch norm in train mode."""
    return port_step(QUIRK, 20)


@pytest.fixture(scope="module")
def quirk_frozen_step():
    """The same quirk-mode step with batch norm frozen
    (strict_equivalence_config's setting)."""
    return port_step(dict(QUIRK, frozen_bn=True), 20)


@pytest.fixture(scope="module")
def quirk_decode_step():
    """The quirk-mode step with decoded proposals: the RPN's deltas are
    regressed on image 0's GT through a second, full matcher call."""
    return port_step(dict(QUIRK, decode_proposals=True), 20)


@pytest.fixture(scope="module")
def fixed_step():
    """One flagship fixed-mode step (decoded proposals, mask subset),
    batch 2, batch norm frozen."""
    return port_step(FIXED, 31)


@pytest.mark.parametrize("step", ["quirk_step", "quirk_decode_step"])
def test_quirk_loss_dict_matches_jax(step, request):
    _, metrics, (want, _, _), _ = request.getfixturevalue(step)
    got = {k: v for k, v in metrics.items() if k.startswith("loss_")}
    assert_losses_match(got, want)
    assert want["loss_box_reg"] > 0 and want["loss_mask"] > 0.1
    assert ("loss_rpn_reg" in want) == (step == "quirk_decode_step")
    np.testing.assert_allclose(float(metrics["total_loss"]),
                               sum(float(x) for x in want.values()),
                               **LOSS_TOL)


def test_fixed_loss_dict_matches_jax(fixed_step):
    _, metrics, (want, _, _), record = fixed_step
    got = {k: v for k, v in metrics.items() if k.startswith("loss_")}
    assert_losses_match(got, want)
    assert set(want) == {"loss_box_cls", "loss_box_reg", "loss_mask",
                         "loss_rpn_cls", "loss_rpn_reg"}
    assert want["loss_box_reg"] > 0 and want["loss_mask"] > 0.1
    # The mask subset (16 of 32 proposals) holds every mask-fg row first.
    assert record["mask_subset"].shape == (2, 16)


@pytest.mark.parametrize("step", ["quirk_frozen_step", "fixed_step"])
def test_gradients_match_jax(step, request):
    """With frozen batch norm. In train mode at this size (12 values per
    channel at layer4) JAX's own gradients move by up to 70% of their
    scale when the input moves by 1e-6, so no tolerance could hold the
    port to them; train-mode batch norm is held by the loss dict and the
    running statistics instead."""
    model, metrics, (_, grads, _) = request.getfixturevalue(step)[:3]
    assert_grads_match(model, grads)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(grads)), rtol=1e-4)


def test_bn_running_statistics_match_jax(quirk_step):
    """flax's update: 0.9 running + 0.1 batch, with the batch's biased
    variance. nn.BatchNorm2d's unbiased update misses by n/(n-1), 9% at
    layer4 (12 values per channel) - far outside the tolerance."""
    model, _, (_, _, new_stats), _ = quirk_step
    v = variables()
    want = from_jax_variables({"params": v["params"],
                               "batch_stats": new_stats})
    old = from_jax_variables(v)
    sd = model.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
    assert len(stat_keys) == 2 * 20
    for k in stat_keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    k = "backbone.layer4_1.conv2.bn.running_var"
    batch_var = (sd[k] - 0.9 * old[k]) / 0.1
    unbiased = 0.9 * old[k] + 0.1 * batch_var * 12 / 11
    assert not np.allclose(unbiased.numpy(), want[k].numpy(), rtol=1e-4,
                           atol=1e-6)


def test_adamw_steplr_matches_optax():
    """Both optimizers take the same JAX gradients for 3 updates (1 step
    per epoch, StepLR(2, 0.1): lr 1e-3, 1e-3, 1e-4), so any difference is
    the update rule's. The FPN output convs the loss does not reach get
    no port gradient and must decay as optax decays them."""
    images, targets = make_batch(40)
    v = variables()
    tx, schedule = jax_optimizer(1e-3, 1e-4, steps_per_epoch=1)
    assert [float(schedule(t)) for t in range(3)] == pytest.approx(
        [1e-3, 1e-3, 1e-4])
    params, opt_state = v["params"], tx.init(v["params"])
    model = port_model(port_cfg(**FIXED))
    opt = build_optimizer(model, 1e-3, 1e-4, 1)
    unreached = {f"fpn.output{i}.{w}" for i in (1, 2, 3)
                 for w in ("weight", "bias")}
    w0 = model.fpn.output1.weight.detach().clone()
    for t in range(3):
        _, grads, _ = run_jax(FIXED, params, v["batch_stats"], images,
                              targets, jax.random.key(50 + t))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(np.asarray,
                              optax.apply_updates(params, updates))
        g = grads_as_port(grads)
        for name, p in model.named_parameters():
            if name in unreached:
                assert g[name].abs().max() == 0, name
            p.grad = None if name in unreached else g[name].clone()
        apply_update(opt)
        if t in (0, 2):
            want = from_jax_variables({"params": params})
            for name, p in model.named_parameters():
                # f32 rounding of the same update; 1e-7 of a unit weight.
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[name].numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=name)
    decay = (1 - 1e-3 * 1e-4) ** 2 * (1 - 1e-4 * 1e-4)
    np.testing.assert_allclose(model.fpn.output1.weight.detach().numpy(),
                               (w0 * decay).numpy(), rtol=1e-6)
    assert opt.param_groups[0]["schedule_step"] == 3


def test_take_all_losses_do_not_depend_on_the_draws():
    """Caps at or above the 144 anchors and proposals of a 16x16 input
    (tests/test_parity_torch.py:28-35): every sample keeps everything,
    so the port's own draws give JAX's losses."""
    kw = dict(image_height=16, image_width=16, max_instances=4,
              rpn_pos_per_image=144, rpn_batch_per_image=288,
              train_pre_topk=144, train_num_samples=144)
    jcfg = dataclasses.replace(jax_cfg(), **kw)
    rng = np.random.default_rng(60)
    b = 4
    images = rng.uniform(size=(b, 16, 16, 3)).astype(np.float32)
    xy = rng.uniform(0, 3, (b, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 13, (b, 4, 2))], -1)
    targets = {"boxes": boxes.astype(np.float32),
               "valid": np.array([[1, 1, 1, 0]] * b, bool),
               "mask28": (rng.uniform(size=(b, 4, 28, 28)) > 0.5).astype(
                   np.float32)}
    model, v = JaxMaskRCNN(jcfg), variables()
    with jax.default_matmul_precision("highest"):
        want = jax.tree.map(np.asarray, jax.jit(lambda x, t: model.apply(
            v, x, t, train=True, rngs={"sampling": jax.random.key(0)},
            mutable=["batch_stats"])[0])(images, targets))
    port = create_train_model(dataclasses.replace(port_cfg(), **kw),
                              device="cpu")
    port.load_state_dict(from_jax_variables(v), strict=True)
    got = port.train_forward(*to_torch(images, targets),
                             generator=torch.Generator().manual_seed(1))
    assert_losses_match(got, want)
    assert want["loss_mask"] > 0.1 and want["loss_box_reg"] > 0


# ---------------------------------------------------------------------------
# Port-only properties.
# ---------------------------------------------------------------------------

def test_bf16_step_keeps_f32_state():
    """bf16 compute, f32 masters: parameters, Adam moments and batch-norm
    statistics stay f32 while the convolutions run in bf16."""
    model = create_train_model(port_cfg(compute_dtype="bfloat16"),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    seen = []
    model.backbone.conv1.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    opt = build_optimizer(model, 1e-3, 1e-4, 1)
    step = make_step_fn(model, opt)
    images, targets = to_torch(*make_batch(70))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        metrics = step(images, targets,
                       generator=torch.Generator().manual_seed(2))
    assert seen == [torch.bfloat16] * 2
    assert all(torch.isfinite(v) for v in metrics.values())
    for k, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, k
    moved = [k for k, t in model.state_dict().items()
             if t.is_floating_point() and not torch.equal(t, before[k])]
    assert "backbone.bn1.running_var" in moved and "rpn.conv.weight" in moved
    for st in opt.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


def test_config_matches_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JaxTrainConfig())
    s = strict_equivalence_config(ModelConfig())
    assert (s.compute_dtype, s.topk_backend, s.roi_precision, s.frozen_bn) \
        == ("float32", "exact", "highest", True)
    with pytest.raises(ValueError, match="topk_backend"):
        ModelConfig(topk_backend="approx")
    with pytest.raises(ValueError, match="match_backend"):
        ModelConfig(match_backend="xla")


def test_checkpoint_round_trip(tmp_path):
    """Train, save, serve the checkpoint, and resume training from it
    exactly where it stopped."""
    cfg = port_cfg(**FIXED)
    model = port_model(cfg)
    opt = build_optimizer(model, 1e-3, 1e-4, 2)
    images, targets = to_torch(*make_batch(80))
    noise = [model.sampling_noise(2, "cpu", torch.Generator().manual_seed(s))
             for s in range(2)]
    make_step_fn(model, opt)(images, targets, noise=noise[0])
    path = checkpoint.save(str(tmp_path / "ckpt"), model, opt, epoch=1,
                           train_losses=[1.5])

    served = load_model(path, device="cpu")
    assert served.cfg == cfg and not served.training
    tile = (np.asarray(images[0]))[:42, :60]
    got = InferenceEngine(path, device="cpu").predict(tile, 0.0)
    want = InferenceEngine(model=served, device="cpu").predict(tile, 0.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    resumed, ropt, meta = checkpoint.restore(path, device="cpu")
    assert meta == {"epoch": 1, "train_losses": [1.5]}
    assert ropt.param_groups[0]["schedule_step"] == 1
    m1 = make_step_fn(model, opt)(images, targets, noise=noise[1])
    m2 = make_step_fn(resumed, ropt)(images, targets, noise=noise[1])
    assert float(m1["total_loss"]) == float(m2["total_loss"])
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              resumed.state_dict().items()):
        assert torch.equal(a, b), k
