"""The port's CustomMaskRCNN vs the JAX package's, with the same weights
(carried across by models/convert.py) on the same numpy inputs, at
64x96 and f32. Tolerance: rtol 1e-4, atol 1e-4 (f32 convolutions
summed in another order, through ~20 layers)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from livecell_tpu.models.mask_rcnn import CustomMaskRCNN as JaxMaskRCNN
from livecell_tpu_torch.models.convert import from_jax_variables
from livecell_tpu_torch.models.mask_rcnn import create_model
from tests.util_torch_port import (
    JAX_CFG, PORT_CFG, images, jax_call, jax_model, jax_variables, min_gap,
    port_model)

TOL = dict(rtol=1e-4, atol=1e-4)
# Selections must sit farther apart than the two frameworks' f32
# disagreement (~3e-7 in the scores), or a flip could pass or fail
# silently.
MIN_GAP = 2e-6


@pytest.fixture(scope="module")
def models():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return jax_variables(), port_model()


def test_from_jax_variables_is_strict(models):
    v, model = models
    sd = from_jax_variables(v)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(x.size for x in jax_leaves(v))
    n_port = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for k, b in model.named_buffers()
        if not k.endswith("num_batches_tracked"))
    assert n_port == n_jax          # every JAX value lands exactly once
    fresh = create_model(PORT_CFG, device="cpu")
    partial = dict(sd)
    partial.pop("box_head.fc1.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        fresh.load_state_dict(partial, strict=True)


def test_from_jax_variables_rejects_unmapped_leaves(models):
    v, _ = models
    bad = {"params": {**v["params"], "extra": {"weird": np.zeros(3)}},
           "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="unmapped param leaf"):
        from_jax_variables(bad)
    bad = {"params": v["params"],
           "batch_stats": {"backbone": {"bn1": {"count": np.zeros(3)}}}}
    with pytest.raises(KeyError, match="unmapped stat leaf"):
        from_jax_variables(bad)


def jax_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in jax_leaves(v)]
    return [tree]


def test_trunk_and_fpn_features_match(models):
    v, model = models
    x = images(0)
    want = jax_call(lambda v, x: JaxMaskRCNN(JAX_CFG).apply(
        v, x, False, method=JaxMaskRCNN.extract_features), v, x)
    got = model.extract_features(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)


def shift_bn_means(v, m: float):
    """The same function with every batch norm's running mean moved by
    m standard deviations and its bias moved to compensate: a mean large
    against its std, as trained statistics can hold."""
    v = {"params": copy.deepcopy(v["params"]),
         "batch_stats": copy.deepcopy(v["batch_stats"])}

    def walk(params, stats):
        for k, s in stats.items():
            if "mean" in s:
                std = np.sqrt(s["var"] + np.float32(1e-5))
                s["mean"] = s["mean"] + np.float32(m) * std
                params[k]["bias"] = params[k]["bias"] \
                    + np.float32(m) * params[k]["scale"]
            else:
                walk(params[k], s)

    walk(v["params"], v["batch_stats"])
    return v


def test_bf16_trunk_normalizes_in_f32():
    """In bf16 the port's trunk is no farther from the f32 result than
    the JAX package's bf16 trunk: relative RMS error per FPN level at
    most 1.25x the JAX bf16 one. Batch norm means sit 64 std from 0, so
    storing them (or the compensating bias) in bf16 would add ~2^-9 * 64
    of the activation scale per layer, several times the error of bf16
    activations alone (measured: ~1x with f32 batch norm, up to ~9x at
    the last level with bf16 batch norm)."""
    v = shift_bn_means(jax_variables(), 64.0)
    x = images(0)
    ref = jax_call(lambda v, x: JaxMaskRCNN(JAX_CFG).apply(
        v, x, False, method=JaxMaskRCNN.extract_features), v, x)
    jcfg = dataclasses.replace(JAX_CFG, compute_dtype="bfloat16")
    jbf = jax_call(lambda v, x: JaxMaskRCNN(jcfg).apply(
        v, x, False, method=JaxMaskRCNN.extract_features), v, x)
    model = create_model(dataclasses.replace(PORT_CFG,
                                             compute_dtype="bfloat16"),
                         device="cpu")
    model.load_state_dict(from_jax_variables(v), strict=True)
    for name, t in model.state_dict().items():
        if ".bn" in name and not name.endswith("num_batches_tracked"):
            assert t.dtype == torch.float32, name
    got = model.extract_features(torch.from_numpy(x))

    def rel_rms(a, r):
        return np.sqrt(((a - r) ** 2).mean() / (r ** 2).mean())

    for g, j, r in zip(got, jbf, ref):
        assert g.dtype == torch.bfloat16
        assert rel_rms(g.detach().float().numpy(), r) <= 1.25 * rel_rms(
            np.asarray(j, np.float32), r)


def test_rpn_outputs_match(models):
    v, model = models
    rng = np.random.default_rng(1)
    feats = [rng.uniform(0, 2, (2, 16 >> i, 24 >> i, 256)).astype(np.float32)
             for i in range(4)]
    want = jax_call(lambda v, f: JaxMaskRCNN(JAX_CFG).apply(
        v, f, method=lambda m, f: m.rpn(f)), v, feats)
    with torch.no_grad():
        got = model.rpn([torch.from_numpy(f).permute(0, 3, 1, 2)
                         for f in feats])
    for gs, ws in zip(got, want):            # (cls levels, delta levels)
        for g, w in zip(gs, ws):
            assert g.shape == w.shape        # NHWC, (y, x, a[, c]) order
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_box_and_mask_heads_match(models):
    v, model = models
    rois = np.random.default_rng(2).uniform(
        0, 1, (5, 7, 7, 256)).astype(np.float32)
    want = jax_call(lambda v, r: JaxMaskRCNN(JAX_CFG).apply(
        v, r, method=lambda m, r: (m.box_head(r), m.mask_head(r))), v, rois)
    with torch.no_grad():
        r = torch.from_numpy(rois)
        got = (model.box_head(r), model.mask_head(r))
    (gc, gd), gm = got
    (wc, wd), wm = want
    for g, w in ((gc, wc), (gd, wd), (gm, wm)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("decode", [False, True])
def test_inference_forward_matches(models, decode):
    v, model = models
    x = images(3)
    jm = jax_model(decode_proposals=decode)
    want = jax_call(lambda v, x: jm.apply(v, x, train=False), v, x)

    # Margins first: the proposal top-k (with the first rejected score)
    # and the detection NMS order and threshold.
    c = JAX_CFG
    cls, _ = jax_call(lambda v, x: jm.apply(
        v, x, False, method=lambda m, x, t: m.rpn(m.extract_features(x, t))),
        v, x)
    obj = 1 / (1 + np.exp(-cls[0].reshape(len(x), -1).astype(np.float64)))
    for o in obj:
        assert min_gap(np.sort(o)[-(c.infer_pre_topk + 1):]) > MIN_GAP
    for s, ok in zip(want.scores, want.valid):
        assert ok.sum() >= 2
        assert min_gap(s[ok]) > MIN_GAP
        assert np.abs(s[ok] - c.det_score_thresh).min() > MIN_GAP

    model.cfg = dataclasses.replace(PORT_CFG, decode_proposals=decode)
    got = model.inference_forward(torch.from_numpy(x))
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    ok = want.valid
    np.testing.assert_allclose(got.boxes.numpy()[ok], want.boxes[ok], **TOL)
    np.testing.assert_allclose(got.scores.numpy()[ok], want.scores[ok],
                               **TOL)
    np.testing.assert_allclose(got.mask_probs.numpy()[ok],
                               want.mask_probs[ok], **TOL)
