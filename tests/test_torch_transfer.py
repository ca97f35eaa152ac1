"""The port's transfer slice vs the JAX package's, on the CPU in f32 at
the TINY geometry of tests/test_transfer.py: nms_iterated,
reproject_mask28, the RPN and box-head targets, inference_forward, the
five training losses with JAX's draws replayed, every gradient, the
stage optimizer against optax, the torchvision importer, the frame
predictor's input tile, and the conversion of JAX weights.

JAX runs the f32 gather MultiScaleRoIAlign and matmuls at "highest";
its training forward runs the Pallas matcher in interpret mode (the
route it takes on the TPU, first best anchor per GT, as K4); the port
runs its plain versions (CPU tensors). The test weights scale the
predictors so that every top-k, NMS and threshold decision has a margin
above the two frameworks' f32 disagreement; the margins are asserted
first.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from livecell_tpu.config import TileConfig as JaxTileConfig
from livecell_tpu.models import transfer as jtr
from livecell_tpu.models.detector import Detections as JaxDetections
from livecell_tpu.models.torch_import import (
    load_torchvision_weights as jax_load_torchvision)
from livecell_tpu.ops.mask_ops import reproject_mask28 as j_reproject
from livecell_tpu.ops import pallas_match
from livecell_tpu.ops.nms import nms_iterated as j_nms_iterated
from livecell_tpu.ops.pallas_match import match_anchors_xla
from livecell_tpu.serve.stitch import make_frame_predictor as jax_predictor
from livecell_tpu.train.train_transfer import (
    stage_optimizer as jax_stage_optimizer)
from livecell_tpu_torch.config import TileConfig, TransferConfig
from livecell_tpu_torch.models import transfer as tr
from livecell_tpu_torch.models.convert import _kernel, from_jax_variables
from livecell_tpu_torch.models.torch_import import load_torchvision_weights
from livecell_tpu_torch.ops.mask_ops import reproject_mask28
from livecell_tpu_torch.ops.nms import nms_iterated
from livecell_tpu_torch.parallel.train_step import apply_update, make_step_fn
from livecell_tpu_torch.serve.stitch import make_frame_predictor
from livecell_tpu_torch.train.train_transfer import stage_optimizer
from tests.util_torch_port import min_gap
from tests.util_torchvision_fake import fake_torchvision_maskrcnn_state_dict

TINY_KW = dict(tile_height=64, tile_width=96, image_height=128,
               image_width=192, resized_width=192,
               rpn_pre_topk_per_level=32, rpn_post_nms=32, box_batch=32,
               mask_slots=8, max_detections=8, max_instances=8, rpn_batch=32,
               compute_dtype="float32")
JCFG = jtr.TransferConfig(roi_backend="xla", rpn_match_backend="xla",
                          **TINY_KW)
PCFG = TransferConfig(**TINY_KW)
B = 2
# Scores that the frameworks compute ~1e-7 apart must not flip a
# selection: every sorted-score gap that decides one exceeds this.
MIN_GAP = 2e-6
# The initial weights' RPN logits (std ~1.5 here: the FPN outputs have
# no ReLU) saturate the sigmoid of the top candidates; halving them
# keeps the sorted scores apart. The box deltas are scaled up so that
# the refined boxes move off the proposals. The mask logits of the
# initial head run to the hundreds, where f32's relative rounding moves
# the probabilities of the transition by ~1e-3; scaled down to O(1-10).
PREDICTOR_SCALE = {("rpn", "cls_logits", "kernel"): 0.5,
                   ("box_predictor", "bbox_pred", "kernel"): 30.0,
                   ("mask_head", "mask_fcn_logits", "kernel"): 0.01}


def jcall(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


@functools.lru_cache(maxsize=1)
def jax_variables():
    _, v = jtr.create_transfer_model(rng=jax.random.key(0), cfg=JCFG)
    v = jax.tree.map(lambda x: np.array(x, np.float32), v)
    for path, s in PREDICTOR_SCALE.items():
        node = v["params"]
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = node[path[-1]] * np.float32(s)
    return v


def port_model(train=False):
    m = tr.create_transfer_model(PCFG, device="cpu", train=train)
    m.load_state_dict(from_jax_variables(jax_variables()), strict=True)
    return m


def batch(seed=0):
    """Images in [0, 1] and three valid GT boxes of 10-30 px per image
    (tests/test_transfer.py:synthetic), as numpy."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, 64, 96, 3)).astype(np.float32)
    i = PCFG.max_instances
    boxes = np.zeros((B, i, 4), np.float32)
    valid = np.zeros((B, i), bool)
    for bi in range(B):
        for k in range(3):
            x1, y1 = rng.uniform(0, 60), rng.uniform(0, 30)
            boxes[bi, k] = [x1, y1, x1 + rng.uniform(10, 30),
                            y1 + rng.uniform(10, 25)]
            valid[bi, k] = True
    mask28 = (rng.uniform(size=(B, i, 28, 28)) > 0.5).astype(np.float32)
    return images, {"boxes": boxes, "valid": valid, "mask28": mask28}


def torch_targets(t):
    return {k: torch.from_numpy(v) for k, v in t.items()}


# ---------------------------------------------------------------------------
# (c) nms_iterated.
# ---------------------------------------------------------------------------

def dense_boxes(rng, n, spread=60):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(8, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("max_keep", [40, 12])
def test_nms_iterated_matches_jax_dense(max_keep):
    rng = np.random.default_rng(1)
    boxes = np.stack([dense_boxes(rng, 60, spread=25) for _ in range(3)])
    scores = rng.uniform(size=(3, 60)).astype(np.float32)
    valid = rng.uniform(size=(3, 60)) < 0.9
    idx, ok = nms_iterated(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.5, max_keep, torch.from_numpy(valid))
    for i in range(3):
        wi, wo = map(np.asarray, j_nms_iterated(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5, max_keep,
            jnp.asarray(valid[i])))
        np.testing.assert_array_equal(ok[i].numpy(), wo)
        np.testing.assert_array_equal(idx[i].numpy()[wo], wi[wo])
        assert 0 < wo.sum() < valid[i].sum()     # some were suppressed


def chain(n):
    """n boxes in a row, each overlapping the next at IoU 0.6 and no
    other, scores falling along the row: greedy NMS at 0.5 keeps every
    other box, and the sweeps need ~n/2 pairs to get there."""
    x = np.arange(n, dtype=np.float32) * 4.0
    boxes = np.stack([x, np.zeros(n), x + 16.0, np.full(n, 10.0)], 1)
    return boxes.astype(np.float32), np.linspace(1, 0.5, n).astype(
        np.float32)


@pytest.mark.parametrize("max_sweeps", [4, 5, 32])
def test_nms_iterated_matches_jax_when_sweeps_run_out(max_sweeps):
    boxes, scores = chain(24)
    idx, ok = nms_iterated(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None], 0.5, 24,
                           max_sweeps=max_sweeps)
    wi, wo = map(np.asarray, j_nms_iterated(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, 24,
        max_sweeps=max_sweeps))
    np.testing.assert_array_equal(ok[0].numpy(), wo)
    np.testing.assert_array_equal(idx[0].numpy(), wi)
    # 4 or 5 sweeps end before the fixpoint: a superset of greedy's 12.
    assert wo.sum() == 12 if max_sweeps == 32 else wo.sum() > 12


# ---------------------------------------------------------------------------
# (d) reproject_mask28, the RPN targets, the box targets.
# ---------------------------------------------------------------------------

def test_reproject_mask28_matches_jax():
    rng = np.random.default_rng(2)
    gt = dense_boxes(rng, 12).reshape(2, 6, 4)
    prop = (gt + rng.normal(0, 4, gt.shape)).astype(np.float32)
    masks = rng.uniform(size=(2, 6, 28, 28)).astype(np.float32)
    got = reproject_mask28(torch.from_numpy(masks), torch.from_numpy(gt),
                           torch.from_numpy(prop)).numpy()
    for i in range(2):
        want = np.asarray(j_reproject(jnp.asarray(masks[i]),
                                      jnp.asarray(gt[i]),
                                      jnp.asarray(prop[i])))
        # The same f32 contractions (JAX at "highest"): 1e-6 absolute on
        # values in [0, 1].
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)


def canvas_gt():
    _, t = batch(0)
    sy, sx = 128 / 64, 192 / 96
    gt = t["boxes"] * np.float32([sx, sy, sx, sy])
    valid = t["valid"].copy()
    valid[1, 1] = False
    gt[0, 3] = gt[0, 0]                       # two GT share a best anchor
    valid[0, 3] = True
    return gt.astype(np.float32), valid


def test_rpn_targets_from_match_match_jax():
    anchors = np.concatenate(jtr.torchvision_anchors(
        jtr.pyramid_shapes(128, 192), JCFG.anchor_sizes, JCFG.anchor_ratios,
        JCFG.level_strides))
    a = anchors.shape[0]
    gt, valid = canvas_gt()
    mx, tgt, best = map(np.asarray, match_anchors_xla(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid)))
    keys = jax.random.split(jax.random.key(5), B)
    u = [jax.random.split(k) for k in keys]
    u_fg = np.stack([np.asarray(jax.random.uniform(k[0], (a,))) for k in u])
    u_bg = np.stack([np.asarray(jax.random.uniform(k[1], (a,))) for k in u])
    t = torch.from_numpy
    got = tr.rpn_targets_from_match(
        PCFG, t(anchors), t(mx), t(tgt), t(best).long(), t(gt), t(valid),
        t(u_fg), t(u_bg))
    for i in range(B):
        want = jax.tree.map(np.asarray, jtr._rpn_targets_from_match(
            JCFG, jnp.asarray(anchors), mx[i], tgt[i], best[i],
            jnp.asarray(gt[i]), jnp.asarray(valid[i]), keys[i]))
        for g, w in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(g[i].numpy(), w)
        np.testing.assert_array_equal(got[5][i].numpy(), want[5])
    assert got[4].sum() > 0                   # some positives sampled


def test_box_targets_match_jax():
    rng = np.random.default_rng(4)
    gt, valid = canvas_gt()
    p = 20
    props = (np.repeat(gt[:, :5], 4, axis=1)
             + rng.normal(0, 6, (B, p, 4))).astype(np.float32)
    pvalid = rng.uniform(size=(B, p)) < 0.85
    keys = jax.random.split(jax.random.key(6), B)
    n = p + gt.shape[1]
    u = [jax.random.split(k) for k in keys]
    u_fg = np.stack([np.asarray(jax.random.uniform(k[0], (n,))) for k in u])
    u_bg = np.stack([np.asarray(jax.random.uniform(k[1], (n,))) for k in u])
    t = torch.from_numpy
    got = tr.box_targets(PCFG, t(props), t(pvalid), t(gt), t(valid),
                         t(u_fg), t(u_bg))
    for i in range(B):
        want = jax.tree.map(np.asarray, jtr._box_targets(
            JCFG, jnp.asarray(props[i]), jnp.asarray(pvalid[i]),
            jnp.asarray(gt[i]), jnp.asarray(valid[i]), keys[i]))
        for k, (g, w) in enumerate(zip(got, want)):
            if k == 4:   # regression targets: the same f32 formula
                np.testing.assert_allclose(g[i].numpy(), w, rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g[i].numpy(), w)
        assert want[5].sum() > 0


# ---------------------------------------------------------------------------
# (e) the whole slice.
# ---------------------------------------------------------------------------

def assert_selection_margins(model, images):
    """Every level's top-k (and the cut after it) and the union of the
    levels' candidates are spread wider than MIN_GAP; so are the box
    head's class-1 scores of the proposals."""
    with torch.no_grad():
        feats = model.features(torch.from_numpy(images))
        objs, dlts = model.rpn_outputs(feats)
        for i in range(B):
            cand = []
            for o in objs:
                s = np.sort(torch.sigmoid(o[i]).numpy())[::-1]
                top = s[:PCFG.rpn_pre_topk_per_level + 1]
                assert min_gap(top) > MIN_GAP
                cand.append(top[:-1])
            assert min_gap(np.concatenate(cand)) > MIN_GAP
        pb, pv = tr.image_proposals(PCFG, objs, dlts,
                                    model.anchors(torch.device("cpu")),
                                    model.img_hw)
        rois = model.ms_roi(feats, pb, PCFG.roi_size)
        cls, _ = model.box_predictor(model.box_head(
            rois.reshape((-1,) + rois.shape[2:])))
        sc = torch.softmax(cls, -1)[:, 1].reshape(B, -1)
        for i in range(B):
            # Boxes clipped to the whole canvas from several levels are
            # one box with one score: equal in both frameworks, their
            # order is the index order. Distinct scores must be apart.
            s = sc[i][pv[i]].numpy()
            assert min_gap(np.unique(s)) > MIN_GAP
            assert np.abs(s - PCFG.score_thresh).min() > MIN_GAP
    return pv


@pytest.fixture(scope="module")
def jax_model():
    return jtr.TransferMaskRCNN(JCFG)


@pytest.fixture(scope="module")
def jax_dets(jax_model):
    images, _ = batch(0)
    return jcall(lambda v, x: jax_model.apply(v, x, train=False),
                 jax_variables(), jnp.asarray(images))


def test_inference_forward_matches_jax(jax_dets):
    images, _ = batch(0)
    model = port_model()
    pvalid = assert_selection_margins(model, images)
    assert pvalid.sum() > 10
    got = model.inference_forward(torch.from_numpy(images))
    np.testing.assert_array_equal(got.valid.numpy(), jax_dets.valid)
    v = jax_dets.valid
    assert v.sum() >= 4
    # f32 through R50-FPN, the heads and the decoders: 1e-4.
    np.testing.assert_allclose(got.boxes.numpy()[v], jax_dets.boxes[v],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[v], jax_dets.scores[v],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.mask_probs.numpy()[v],
                               jax_dets.mask_probs[v], rtol=0, atol=1e-4)


def jax_noise(jax_model, key, a, p):
    """JAX's draws of train_forward as the port's `noise` dict: the
    `sampling` key split as transfer.py:514-517, then per image as
    _rpn_targets (kf, kb) and _box_targets (kf, kb)."""
    root = jax_model.apply(jax_variables(),
                           method=lambda m: m.make_rng("sampling"),
                           rngs={"sampling": key})
    k_rpn, k_box = jax.random.split(root)
    out = {"rpn_fg": [], "rpn_bg": [], "box_fg": [], "box_bg": []}
    for kr, kb in zip(jax.random.split(k_rpn, B), jax.random.split(k_box, B)):
        for name, k, n in (("rpn", kr, a), ("box", kb, p)):
            kf, kg = jax.random.split(k)
            out[name + "_fg"].append(np.asarray(jax.random.uniform(kf, (n,))))
            out[name + "_bg"].append(np.asarray(jax.random.uniform(kg, (n,))))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_train():
    """(losses, grads) of JAX's train forward on batch(1), key 1, with
    the Pallas matcher (transfer.py:530-536) in interpret mode."""
    images, targets = batch(1)
    v = jax_variables()
    jax_model = jtr.TransferMaskRCNN(dataclasses.replace(
        JCFG, rpn_match_backend="pallas"))

    def fn(params, x, t):
        def loss_fn(p):
            losses = jax_model.apply(
                {"params": p, "batch_stats": v["batch_stats"]}, x, t,
                train=True, rngs={"sampling": jax.random.key(1)})
            return sum(losses.values()), losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return losses, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_match, "match_anchors_pallas", functools.partial(
            pallas_match.match_anchors_pallas, interpret=True))
        return jcall(fn, v["params"], jnp.asarray(images),
                     {k: jnp.asarray(x) for k, x in targets.items()})


def port_grads(images, targets, noise):
    model = port_model(train=True)
    losses = model.train_forward(torch.from_numpy(images),
                                 torch_targets(targets), noise=noise)
    sum(losses.values()).backward()
    return losses, {n: p.grad.numpy() for n, p in model.named_parameters()}


def rel_errors(got, want):
    """Per tensor: (|got - want|_max / |want|_max, L2 of the difference /
    L2 of want)."""
    out = {}
    for n, w in want.items():
        d = got[n] - w
        out[n] = (np.abs(d).max() / max(np.abs(w).max(), 1e-12),
                  np.linalg.norm(d) / max(np.linalg.norm(w), 1e-12))
    return out


def test_train_losses_and_gradients_match_jax(jax_model, jax_train):
    images, targets = batch(1)
    model = port_model(train=True)
    assert_selection_margins(model, images)
    a = sum(x.shape[0] for x in model.anchors(torch.device("cpu")))
    noise = jax_noise(jax_model, jax.random.key(1), a,
                      model.proposal_count() + PCFG.max_instances)
    record = {}
    model.train_forward(torch.from_numpy(images), torch_targets(targets),
                        noise=noise, record=record)
    assert record["box_valid"][:, :PCFG.box_pos].sum() > 0
    losses, grads = port_grads(images, targets, noise)
    want_losses, want_grads = jax_train
    assert list(losses) == ["loss_objectness", "loss_rpn_box_reg",
                            "loss_classifier", "loss_box_reg", "loss_mask"]
    for k, v in losses.items():
        # f32 sums in another order through ~60 layers: 1e-5 relative.
        np.testing.assert_allclose(float(v), float(want_losses[k]),
                                   rtol=1e-5, err_msg=k)
    want = {k: v.numpy() for k, v in from_jax_variables(
        {"params": want_grads}).items()}
    err = rel_errors(grads, want)
    # The gradients of these random weights are ill-conditioned despite
    # the frozen batch norm: ReLU and max-pool kinks turn on a 1e-6
    # change of the input, which moves the port's own gradients by up to
    # 1.7% of a tensor's largest entry and 0.4% of its norm (measured
    # below). JAX and the port agree well inside that: 1e-2 of the
    # largest entry and 2e-3 of the norm, per tensor.
    rng = np.random.default_rng(0)
    nudged = (images + rng.normal(0, 1e-6, images.shape)).astype(np.float32)
    floor = rel_errors(port_grads(nudged, targets, noise)[1], grads)
    assert max(e[1] for e in floor.values()) > 2e-3
    for name, (e_max, e_l2) in err.items():
        assert e_max < 1e-2 and e_l2 < 2e-3, (name, e_max, e_l2)


def test_scan_and_sweep_proposals_agree():
    """rpn_nms_mode "scan" (nms_fixed) and "sweep" (nms_iterated, run to
    its fixpoint) select the same proposals."""
    images, _ = batch(0)
    model = port_model()
    with torch.no_grad():
        objs, dlts = model.rpn_outputs(model.features(
            torch.from_numpy(images)))
    anchors = model.anchors(torch.device("cpu"))
    got = [tr.image_proposals(
        dataclasses.replace(PCFG, rpn_nms_mode=mode), objs, dlts, anchors,
        model.img_hw) for mode in ("scan", "sweep")]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert got[0][1].sum() > 10


def test_step_fn_runs_the_transfer_model_and_keeps_bn_statistics():
    images, targets = batch(1)
    model = port_model(train=True)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    opt = stage_optimizer(model, 5e-3, 0.9, 5e-4, freeze=True,
                          clip_norm=10.0)
    m = make_step_fn(model, opt)(
        torch.from_numpy((images * 255).astype(np.uint8)),
        torch_targets(dict(targets, mask28=(targets["mask28"] * 255)
                           .astype(np.uint8))),
        generator=torch.Generator().manual_seed(0))
    assert set(m) == {"total_loss", "grad_norm", "loss_objectness",
                      "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
                      "loss_mask"}
    assert all(np.isfinite(float(v)) for v in m.values())
    for k, v in model.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k


# ---------------------------------------------------------------------------
# (f) the stage optimizer against optax.
# ---------------------------------------------------------------------------

class Five(torch.nn.Module):
    """A stand-in with the transfer model's top-level module names."""

    def __init__(self):
        super().__init__()
        for name in ("backbone", "fpn", "rpn", "box_head", "mask_head"):
            self.add_module(name, torch.nn.Linear(3, 2))


@pytest.mark.parametrize("freeze,clip", [(True, 0.0), (False, 0.0),
                                         (True, 0.5), (False, 0.5)])
def test_stage_optimizer_matches_optax(freeze, clip):
    rng = np.random.default_rng(8)
    names = ("backbone", "fpn", "rpn", "box_head", "mask_head")
    params = {n: {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                  "bias": rng.normal(size=2).astype(np.float32)}
              for n in names}
    grads = [{n: {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                  "bias": rng.normal(size=2).astype(np.float32)}
              for n in names} for _ in range(3)]
    tx = jax_stage_optimizer(5e-3, 0.9, 5e-4, freeze, clip)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    model = Five()
    with torch.no_grad():
        for n in names:
            getattr(model, n).weight.copy_(torch.from_numpy(
                params[n]["kernel"].T))
            getattr(model, n).bias.copy_(torch.from_numpy(params[n]["bias"]))
    opt = stage_optimizer(model, 5e-3, 0.9, 5e-4, freeze, clip)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for n in names:
            getattr(model, n).weight.grad = torch.from_numpy(
                g[n]["kernel"].T.copy())
            getattr(model, n).bias.grad = torch.from_numpy(g[n]["bias"])
        apply_update(opt)
    for n in names:
        # Three f32 updates of the same formula: 1e-6.
        np.testing.assert_allclose(getattr(model, n).weight.detach().numpy(),
                                   np.asarray(jp[n]["kernel"]).T, rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        np.testing.assert_allclose(getattr(model, n).bias.detach().numpy(),
                                   np.asarray(jp[n]["bias"]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        if freeze and n in ("backbone", "fpn", "rpn"):
            np.testing.assert_array_equal(
                getattr(model, n).bias.detach().numpy(), params[n]["bias"])


# ---------------------------------------------------------------------------
# (g) the torchvision importer.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_pth(tmp_path_factory):
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in fake_torchvision_maskrcnn_state_dict(91).items()}
    path = tmp_path_factory.mktemp("tv") / "maskrcnn.pth"
    torch.save(sd, path)
    return path, sd


def test_torchvision_import_matches_jax_importer(fake_pth):
    path, sd = fake_pth
    jv = jax_load_torchvision(jax_variables(), str(path), strict=True)
    want = from_jax_variables(jax.tree.map(np.asarray, jv))
    model = load_torchvision_weights(port_model(), path, strict=True)
    got = model.state_dict()
    swapped = ("box_predictor.", "mask_head.mask_fcn_logits.")
    checked = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or k.startswith(swapped):
            continue
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)
        checked += 1
    assert checked == 299        # every tensor but the 2-class predictors
    # The 91-class predictors were skipped: the 2-class ones stay.
    assert got["box_predictor.cls_score.weight"].shape == (2, 1024)
    torch.testing.assert_close(got["backbone.conv1.weight"],
                               sd["backbone.body.conv1.weight"])
    det = model.inference_forward(torch.from_numpy(batch(0)[0]))
    assert np.isfinite(det.boxes.numpy()).all()
    assert np.isfinite(det.mask_probs.numpy()).all()


def test_torchvision_import_strict_mode(fake_pth):
    _, sd = fake_pth
    bad = dict(sd, **{"roi_heads.extra.weight": torch.zeros(1)})
    load_torchvision_weights(port_model(), bad)          # non-strict: skip
    with pytest.raises(KeyError):
        load_torchvision_weights(port_model(), bad, strict=True)
    wrong = dict(sd, **{"backbone.body.conv1.weight": torch.zeros(64, 3, 5,
                                                                  5)})
    with pytest.raises(ValueError):
        load_torchvision_weights(port_model(), wrong, strict=True)


def test_deconv_conversion_matches_flax():
    """Golden: a flax ConvTranspose kernel carried through
    models/convert.py reproduces flax's output in torch's
    ConvTranspose2d (the conversion flips the kernel in space)."""
    rng = np.random.default_rng(9)
    kernel = rng.normal(size=(2, 2, 3, 5)).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    x = rng.normal(size=(2, 7, 7, 3)).astype(np.float32)
    want = fnn.ConvTranspose(5, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    deconv = torch.nn.ConvTranspose2d(3, 5, 2, stride=2)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            _kernel("mask_head/conv5_mask/kernel", kernel))))
        deconv.bias.copy_(torch.from_numpy(bias))
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (h) the frame predictor's input tile.
# ---------------------------------------------------------------------------

# Frame tiles of 60x90 px, inside TINY's 64x96 input tile.
TCFG = TileConfig(frame_width=210, frame_height=140)


def test_jax_frame_predictor_scales_transfer_boxes_down():
    """The JAX frame predictor pads each tile to image_height x
    image_width (serve/stitch.py:147-155), which for a TransferConfig is
    the canvas, not the input tile; the model then treats that canvas as
    a tile, resizes it again and unscales its boxes by tile/canvas. An
    object at tile pixel (y, x) lands at canvas (y, x) instead of
    (y * sy, x * sx), so its box comes back sy, sx times too small (2 at
    TINY; 800/224 = 3.6 at the default geometry)."""
    seen = []

    class Spy:
        cfg = JCFG

        def apply(self, variables, images, train=False):
            seen.append(tuple(images.shape))
            b, d = images.shape[0], JCFG.max_detections
            return JaxDetections(
                boxes=jnp.zeros((b, d, 4)), scores=jnp.zeros((b, d)),
                labels=jnp.ones((b, d), jnp.int32),
                valid=jnp.zeros((b, d), bool),
                mask_probs=jnp.zeros((b, d, 28, 28)))

    jt = JaxTileConfig(frame_width=210, frame_height=140)
    run = jax_predictor(Spy(), {}, jt, score_threshold=0.0)
    run(np.zeros((jt.num_tiles, jt.tile_height, jt.tile_width, 3), np.uint8))
    assert seen[0][1:3] == (JCFG.image_height, JCFG.image_width) != (
        JCFG.tile_height, JCFG.tile_width)

    # A bright pixel at tile (y, x), padded as the JAX predictor pads it,
    # stays at (y, x) through the model's transform.
    y, x = 20, 30
    canvas = np.zeros((1, JCFG.image_height, JCFG.image_width, 3), np.float32)
    canvas[0, y, x] = 1.0
    model = jtr.TransferMaskRCNN(JCFG)
    out = np.asarray(model.apply({}, jnp.asarray(canvas),
                                 method=jtr.TransferMaskRCNN._transform))
    assert np.unravel_index(out[0, ..., 0].argmax(), out.shape[1:3]) == (y, x)
    sy, sx = JCFG.image_height / JCFG.tile_height, \
        JCFG.resized_width / JCFG.tile_width
    assert (sy, sx) == (2.0, 2.0)

    # The port pads to the input tile, so the same pixel lands at
    # (y * sy, x * sx) on its canvas, where the unscale expects it.
    seen_port = []
    pm = port_model()
    orig = pm.inference_forward

    def spy_forward(images):
        seen_port.append(tuple(images.shape))
        return orig(images)

    pm.inference_forward = spy_forward
    tile = np.zeros((1, JCFG.tile_height, JCFG.tile_width, 3), np.float32)
    tile[0, y, x] = 1.0
    pout = pm.transform(torch.from_numpy(tile)).numpy()
    py, px = np.unravel_index(pout[0, ..., 0].argmax(), pout.shape[1:3])
    assert abs(py - y * sy) <= 1 and abs(px - x * sx) <= 1
    prun = make_frame_predictor(pm, TCFG, score_threshold=0.0, device="cpu")
    prun(np.zeros((TCFG.num_tiles, TCFG.tile_height, TCFG.tile_width, 3),
                  np.uint8))
    assert seen_port[0] == (TCFG.num_tiles, PCFG.tile_height,
                            PCFG.tile_width, 3)


def test_frame_predictor_serves_the_transfer_model():
    rng = np.random.default_rng(11)
    frame = (rng.uniform(size=(TCFG.frame_height, TCFG.frame_width, 3))
             * 255).astype(np.uint8)
    tiles = []
    for t in range(TCFG.num_tiles):
        c0, r0 = t % TCFG.tiles_per_row, t // TCFG.tiles_per_row
        x0, y0 = c0 * TCFG.mini_tile_width, r0 * TCFG.mini_tile_height
        tiles.append(frame[y0:y0 + TCFG.tile_height,
                           x0:x0 + TCFG.tile_width])
    run = make_frame_predictor(port_model(), TCFG, score_threshold=0.0,
                               device="cpu")
    det = run(np.stack(tiles))
    assert len(det.boxes) > 0
    # Boxes are clipped to the input tile, which reaches past the frame
    # tile by its padding.
    pad_w = PCFG.tile_width - TCFG.tile_width
    pad_h = PCFG.tile_height - TCFG.tile_height
    assert (det.boxes[:, 2] <= TCFG.frame_width + pad_w + 1e-3).all()
    assert (det.boxes[:, 3] <= TCFG.frame_height + pad_h + 1e-3).all()
    assert det.masks.shape[1:] == (TCFG.tile_height, TCFG.tile_width)


def test_geometry_matches_jax():
    for hw in ((128, 192), (800, 1088)):
        assert tr.pyramid_shapes(*hw) == jtr.pyramid_shapes(*hw)
    cfg = TransferConfig()
    shapes = tr.pyramid_shapes(cfg.image_height, cfg.image_width)
    got = tr.torchvision_anchors(shapes, cfg.anchor_sizes, cfg.anchor_ratios,
                                 cfg.level_strides)
    want = jtr.torchvision_anchors(shapes, cfg.anchor_sizes,
                                   cfg.anchor_ratios, cfg.level_strides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) == 217_413
    jfields = {f.name: f.default
               for f in dataclasses.fields(jtr.TransferConfig)}
    for f in dataclasses.fields(TransferConfig):
        assert f.default == jfields[f.name], f.name
