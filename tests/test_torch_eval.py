"""The port's evaluation vs the JAX package's, on the CPU: the box
metrics (batch_eval_stats, MetricAccumulator, evaluate), the eval steps
(make_eval_step, make_indexed_eval_step) and COCO AP
(evaluate_coco_multi), for the custom model at the TINY geometry of
tests/util_torch_port.py and the transfer model at that of
tests/test_transfer.py, both in f32 from the same converted JAX
weights, over the same tiled split. JAX runs its exact einsum RoIAlign
(custom) and gather MultiScaleRoIAlign (transfer) at "highest"; the
port runs its plain versions (CPU tensors)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livecell_tpu.config import ModelConfig as JaxModelConfig
from livecell_tpu.data.dataset import PackedDataset as JaxPacked
from livecell_tpu.data.device_data import DeviceDataset as JaxDeviceDataset
from livecell_tpu.data.tiling import LIVECellPreprocessor
from livecell_tpu.models import transfer as jtr
from livecell_tpu.models.detector import Detections as JaxDetections
from livecell_tpu.parallel.train_step import make_eval_step as j_eval_step
from livecell_tpu.train import coco_eval as jce
from livecell_tpu.train import metrics as jm
from livecell_tpu_torch.config import ModelConfig
from livecell_tpu_torch.data.coco import CocoIndex, ann_to_mask
from livecell_tpu_torch.data.dataset import PackedDataset
from livecell_tpu_torch.data.device_data import (
    DeviceDataset, make_indexed_eval_step)
from livecell_tpu_torch.models.detector import Detections
from livecell_tpu_torch.ops.boxes import box_iou
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.parallel.train_step import make_eval_step
from livecell_tpu_torch.train import coco_eval as ce
from livecell_tpu_torch.train import metrics as pm
from tests import test_torch_transfer as ttr
from tests import util_torch_port as up
from tests.util_fakedata import make_fake_livecell

AP_KEYS = ("AP", "AP50", "AP75")


def port_dets(**arrays) -> Detections:
    return Detections(**{k: torch.from_numpy(np.asarray(v))
                         for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# Box metrics.
# ---------------------------------------------------------------------------

def stats_case(rng, kind):
    """(Detections, gt_boxes, gt_valid, batch_valid) of 4 images x 12
    slots x 6 GT slots."""
    b, d, g = 4, 12, 6
    gt = np.zeros((b, g, 4), np.float32)
    xy = rng.uniform(0, 80, (b, g, 2))
    gt[..., :2], gt[..., 2:] = xy, xy + rng.uniform(5, 30, (b, g, 2))
    gtv = rng.uniform(size=(b, g)) < 0.7
    pick = rng.integers(0, g, (b, d))
    boxes = np.take_along_axis(gt, pick[..., None], 1) + rng.normal(
        0, 3, (b, d, 4))
    scores = rng.uniform(0.2, 1.0, (b, d))
    valid = rng.uniform(size=(b, d)) < 0.8
    bvalid = np.ones(b, bool)
    if kind == "duplicates":
        # Three copies of the one GT box: three true positives for one GT,
        # so per-image recall is 3 and F1 1.5 (the reference's rule).
        gtv[:] = False
        gtv[:, 0] = True
        boxes[:, :3] = gt[:, :1]
        scores[:, :3] = 0.9
        valid[:] = False
        valid[:, :3] = True
    elif kind == "padded":
        bvalid[2:] = False
    elif kind == "no_gt":
        gtv[1] = False
        valid[3] = False
    det = dict(boxes=boxes.astype(np.float32),
               scores=scores.astype(np.float32),
               labels=np.ones((b, d), np.int32), valid=valid,
               mask_probs=np.zeros((b, d, 28, 28), np.float32))
    return det, gt, gtv, bvalid


@pytest.mark.parametrize("kind", ["random", "duplicates", "padded", "no_gt"])
def test_batch_eval_stats_and_accumulator_match_jax(rng, kind):
    acc, jacc = pm.MetricAccumulator(), jm.MetricAccumulator()
    for _ in range(3):
        det, gt, gtv, bv = stats_case(rng, kind)
        got = pm.batch_eval_stats(port_dets(**det), torch.from_numpy(gt),
                                  torch.from_numpy(gtv),
                                  torch.from_numpy(bv))
        want = jm.batch_eval_stats(
            JaxDetections(**{k: jnp.asarray(v) for k, v in det.items()}),
            jnp.asarray(gt), jnp.asarray(gtv), jnp.asarray(bv))
        assert set(got) == set(want)
        for k in want:
            # Sums of at most 48 f32 terms: 1e-6 relative.
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)
        acc.update(got)
        jacc.update(jax.tree.map(np.asarray, want))
    s, js = acc.summary(), jacc.summary()
    assert set(s) == set(js)
    for k in js:
        np.testing.assert_allclose(s[k], js[k], rtol=1e-6, err_msg=k)
    if kind == "duplicates":
        assert s["mean_recall"] == 3.0 and s["f1_score"] == 1.5
    assert s["total_pred_instances"] > 0


# ---------------------------------------------------------------------------
# COCO AP on detections placed near the GT.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """One frame at LIVECell statistics cut into 25 tiles by the JAX
    tiler."""
    src = make_fake_livecell(tmp_path_factory.mktemp("src"),
                             images_per_split=(0, 0, 1), stats="livecell",
                             mean_instances=100, seed=3)
    out = tmp_path_factory.mktemp("split")
    LIVECellPreprocessor(str(src), str(out), total_images=1).preprocess()
    return out


def near_gt_detections(ds, tiles, d=100, seed=0):
    """Detections for `tiles`: each GT box jittered by ~2 px with its
    mask target as the mask, a few random boxes, random scores."""
    rng = np.random.default_rng(seed)
    b = len(tiles)
    boxes = np.zeros((b, d, 4), np.float32)
    probs = np.zeros((b, d, 28, 28), np.float32)
    valid = np.zeros((b, d), bool)
    for bi, t in enumerate(tiles):
        lo, hi = ds.offsets[t], ds.offsets[t + 1]
        n = min(hi - lo, d - 8)
        boxes[bi, :n] = ds.boxes[lo:lo + n] + rng.normal(0, 2, (n, 4))
        probs[bi, :n] = ds.mask28[lo:lo + n] / 255.0
        xy = rng.uniform(0, 250, (8, 2))
        boxes[bi, n:n + 8] = np.concatenate([xy, xy + 20], 1)
        probs[bi, n:n + 8] = rng.uniform(size=(8, 28, 28))
        valid[bi, :n + 8] = True
    return dict(boxes=boxes, scores=rng.uniform(0.1, 1, (b, d)).astype(
        np.float32), labels=np.ones((b, d), np.int32), valid=valid,
        mask_probs=probs)


def test_evaluate_coco_multi_near_gt_matches_jax(split):
    jds = JaxPacked(str(split), "test", JaxModelConfig(), cache=False)
    pds = PackedDataset(str(split), "test", ModelConfig(), cache=False,
                        device="cpu")
    bs = 8
    batches = [np.arange(i, i + bs) % len(jds) for i in range(0, 25, bs)]
    dets = [near_gt_detections(jds, t, seed=i) for i, t in enumerate(batches)]
    calls = {"jax": 0, "port": 0}

    def port_step(images):
        calls["port"] += 1
        return port_dets(**dets[calls["port"] - 1])

    def jax_step(params, batch_stats, images):
        calls["jax"] += 1
        return JaxDetections(**{k: jnp.asarray(v) for k, v in
                                dets[calls["jax"] - 1].items()})

    got = ce.evaluate_coco_multi(port_step, pds, bs, box_metrics=True,
                                 device="cpu")
    want = jce.evaluate_coco_multi(jax_step, None, None, jds, bs,
                                   box_metrics=True)
    assert calls == {"jax": 4, "port": 4}
    for t in ("segm", "bbox"):
        assert got[t]["AP"] > 0.2, got
        for k in AP_KEYS:
            # The same IoU matrices (exact 0/1 products, the same f32
            # divisions) and the same host matching: 1e-6, measured 0.
            assert abs(got[t][k] - want[t][k]) <= 1e-6, (t, k)
    for k, v in want["box_metrics"].items():
        np.testing.assert_allclose(got["box_metrics"][k], v, rtol=1e-6,
                                   err_msg=k)
    it = iter(dets)
    single = ce.evaluate_coco(lambda im: port_dets(**next(it)), pds, bs,
                              device="cpu")
    assert single == got["segm"]


def test_unpack_gt_is_packbits_inverse(rng):
    """MSB-first unpacking, cropped after the unpack, at widths that are
    not a multiple of 8 (a tile is 300 wide)."""
    for w in (300, 45, 8, 1):
        m = (rng.uniform(size=(5, 7, w)) > 0.5).astype(np.uint8)
        packed = np.packbits(m, axis=-1)
        got = ce.unpack_gt(torch.from_numpy(packed), 7, w).numpy()
        np.testing.assert_array_equal(got, m)


def bucket_case(tmp_path, rng):
    """tests/test_coco_eval.py's two tiles of 3 and 37 GT (the second
    crosses the 32 bucket), at a width of 45 (not a multiple of 8)."""
    h, w, d = 48, 45, 8
    n_gt = [3, 37]
    images, anns, gt_boxes = [], [], []
    aid = 1
    for i, n in enumerate(n_gt):
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": f"t{i}.png"})
        bxs = []
        for _ in range(n):
            x0, y0 = rng.uniform(0, w - 9), rng.uniform(0, h - 9)
            bw, bh = rng.uniform(4, 8), rng.uniform(4, 8)
            anns.append({"id": aid, "image_id": i + 1, "category_id": 1,
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw,
                                           y0 + bh, x0, y0 + bh]],
                         "iscrowd": 0})
            bxs.append([x0, y0, x0 + bw, y0 + bh])
            aid += 1
        gt_boxes.append(np.asarray(bxs, np.float32))
    ann_file = str(tmp_path / "coco.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "cell"}]}, f)

    class DS:
        cfg = dataclasses.make_dataclass(
            "Cfg", [("image_height", int, h), ("image_width", int, w)])()
        tile_hw = (h, w)
        image_ids = np.asarray([1, 2])
        offsets = np.cumsum([0] + n_gt)
        boxes = np.concatenate(gt_boxes, axis=0)

        def batches(self, bs):
            yield (np.zeros((2, h, w, 1), np.float32),
                   {"boxes": np.zeros((2, 4, 4), np.float32),
                    "valid": np.zeros((2, 4), bool)},
                   np.asarray([True, True]))

    DS.ann_file = ann_file
    boxes = np.zeros((2, d, 4), np.float32)
    for bi in range(2):
        for k in range(d):
            g = gt_boxes[bi][rng.integers(len(gt_boxes[bi]))]
            boxes[bi, k] = np.clip(g + rng.normal(0, 1.2, 4), 0, [w, h, w, h])
    det = dict(boxes=boxes, scores=rng.uniform(0.1, 1, (2, d)).astype(
        np.float32), labels=np.ones((2, d), np.int32),
        valid=rng.uniform(size=(2, d)) > 0.3,
        mask_probs=rng.uniform(0, 1, (2, d, 28, 28)).astype(np.float32))
    return DS, det, n_gt, (h, w)


def test_bucketing_across_32_matches_unfused_and_jax(tmp_path, rng):
    DS, det, n_gt, (h, w) = bucket_case(tmp_path, rng)
    got = ce.evaluate_coco_multi(lambda im: port_dets(**det), DS(), 2,
                                 device="cpu")
    want = jce.evaluate_coco_multi(
        lambda p, b, im: JaxDetections(**{k: jnp.asarray(v)
                                          for k, v in det.items()}),
        None, None, DS(), 2)
    # The straightforward computation: no packing, no padding, no fusion.
    coco = CocoIndex(DS.ann_file)
    per = {"segm": [], "bbox": []}
    for bi in range(2):
        v = det["valid"][bi]
        s = det["scores"][bi][v]
        order = np.argsort(-s)[:100]
        gb = DS.boxes[DS.offsets[bi]:DS.offsets[bi + 1]]
        biou = box_iou(torch.from_numpy(det["boxes"][bi][v]),
                       torch.from_numpy(gb)).numpy()
        per["bbox"].append((s[order], biou[order], n_gt[bi]))
        gm = np.stack([ann_to_mask(a, h, w) for a in coco.get_anns(bi + 1)])
        dm = paste_masks(torch.from_numpy(det["mask_probs"][bi]),
                         torch.from_numpy(det["boxes"][bi]), (h, w),
                         valid=torch.from_numpy(v)) > 0
        miou = ce.mask_iou_matrix(dm[torch.from_numpy(v)],
                                  torch.from_numpy(gm)).numpy()
        per["segm"].append((s[order], miou[order], n_gt[bi]))
    unfused = {t: ce.compute_ap(per[t]) for t in per}
    for t in ("segm", "bbox"):
        for k in AP_KEYS:
            assert got[t][k] == unfused[t][k], (t, k)
            # Against JAX: 1e-6, measured 0.
            assert abs(got[t][k] - want[t][k]) <= 1e-6, (t, k)
    assert got["segm"]["AP"] > 0


# ---------------------------------------------------------------------------
# Both models, from the same converted weights.
# ---------------------------------------------------------------------------

class Setup:
    """One model in both packages, with the split packed for it."""

    def __init__(self, kind, split):
        if kind == "custom":
            self.bs = 8
            mi = 32
            self.jmodel = up.jax_model(max_instances=mi)
            self.variables = up.jax_variables()
            self.pmodel = up.port_model()
            jcfg = dataclasses.replace(up.JAX_CFG, max_instances=mi)
            pcfg = dataclasses.replace(up.PORT_CFG, max_instances=mi)
        else:
            self.bs = 4
            self.jmodel = jtr.TransferMaskRCNN(ttr.JCFG)
            self.variables = ttr.jax_variables()
            self.pmodel = ttr.port_model()
            # The trainer's dataset config: the transfer model's input
            # tile and instance slots (train_transfer.py builds dcfg so).
            kw = dict(max_instances=ttr.JCFG.max_instances,
                      mask_size=ttr.JCFG.mask_size,
                      image_height=ttr.JCFG.tile_height,
                      image_width=ttr.JCFG.tile_width)
            jcfg, pcfg = JaxModelConfig(**kw), ModelConfig(**kw)
        # Cached: both models pack the same tiles and mask targets.
        self.jds = JaxPacked(str(split), "test", jcfg)
        self.pds = PackedDataset(str(split), "test", pcfg, device="cpu")
        self.jstep = j_eval_step(self.jmodel)
        self.pstep = make_eval_step(self.pmodel, device="cpu")

    def jax_step(self, params, batch_stats, images):
        with jax.default_matmul_precision("highest"):
            return self.jstep(params, batch_stats, images)

    @property
    def vars(self):
        return self.variables["params"], self.variables["batch_stats"]


@pytest.fixture(scope="module", params=["custom", "transfer"])
def setup(request, split):
    return Setup(request.param, split)


def assert_dets_close(got: Detections, want):
    """Equal valid slots; boxes, scores and mask probabilities within
    1e-4 (f32 through either model and its decoders, the tolerance of
    tests/test_torch_model.py and test_torch_transfer.py)."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    assert v.sum() >= 4
    for f in ("boxes", "scores", "mask_probs"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_eval_step_matches_jax(setup):
    images, _ = setup.pds.gather(np.arange(setup.bs) + 3)
    got = setup.pstep(images)
    assert got.boxes.device.type == "cpu"
    want = setup.jax_step(*setup.vars, jnp.asarray(images))
    assert_dets_close(got, want)
    # Float input passes through unnormalized.
    again = setup.pstep(torch.from_numpy(images).float() / 255.0)
    np.testing.assert_array_equal(again.valid.numpy(), got.valid.numpy())


def test_indexed_eval_step_matches_jax(setup):
    """The batch gathered on the device gives the detections of JAX's eval
    step on the same tiles (JAX's indexed step is its gather, the same
    normalization and the same forward) and the normalized targets of
    JAX's DeviceDataset."""
    idx = np.array([5, 0, 24, 11, 7, 7, 2, 19][:setup.bs], np.int32)
    dd = DeviceDataset.from_packed(setup.pds, device="cpu")
    got, gt = make_indexed_eval_step(setup.pmodel, dd)(idx)
    jdd = JaxDeviceDataset(setup.jds)
    want = setup.jax_step(*setup.vars, jdd.images[jnp.asarray(idx)])
    assert_dets_close(got, want)
    assert gt["mask28"].dtype == torch.float32
    for k in ("boxes", "labels", "valid"):
        np.testing.assert_array_equal(gt[k].numpy(),
                                      np.asarray(jdd.targets[k])[idx])
    # mask28 within one count of 1/255 (test_torch_dataset.py).
    np.testing.assert_allclose(
        gt["mask28"].numpy(), np.asarray(jdd.targets["mask28"])[idx] / 255.0,
        rtol=0, atol=1.0 / 255 + 1e-7)


def capture_compute_ap(module, monkeypatch):
    """Record the per-image (scores, IoU, n_gt) lists that `module`'s
    evaluate_coco_multi hands to compute_ap."""
    seen = []
    real = module.compute_ap

    def spy(per_image):
        seen.append(per_image)
        return real(per_image)

    monkeypatch.setattr(module, "compute_ap", spy)
    return seen


def test_evaluations_match_jax(setup, monkeypatch):
    params, bstats = setup.vars
    seen = capture_compute_ap(ce, monkeypatch)
    jseen = capture_compute_ap(jce, monkeypatch)
    got = ce.evaluate_coco_multi(setup.pstep, setup.pds, setup.bs,
                                 box_metrics=True, score_thresh=0.4,
                                 device="cpu")
    want = jce.evaluate_coco_multi(setup.jax_step, params, bstats,
                                   setup.jds, setup.bs, box_metrics=True,
                                   score_thresh=0.4)
    # The IoU matrices and ranked scores each AP is computed from: the
    # same images, detections and GT counts; IoUs within 1e-5 (the
    # detections' boxes differ by at most ~1e-4 px between the
    # frameworks), scores within 1e-4 as above.
    assert len(seen) == len(jseen) == 2
    n_iou = 0
    for per, jper in zip(seen, jseen):
        assert len(per) == len(jper) == 25
        for (s, iou, n), (js, jiou, jn) in zip(per, jper):
            assert n == jn and iou.shape == jiou.shape
            np.testing.assert_allclose(s, js, rtol=0, atol=1e-4)
            np.testing.assert_allclose(iou, jiou, rtol=0, atol=1e-5)
            n_iou += int((jiou > 0).sum())
    assert n_iou > 50
    for t in ("segm", "bbox"):
        for k in AP_KEYS:
            # Measured equal; the bound from the issue's expectation.
            assert abs(got[t][k] - want[t][k]) <= 1e-4, (t, k)
    # metrics.evaluate is the box-metric sweep alone (JAX's equals its
    # box_metrics=True, tests/test_coco_eval.py).
    box = pm.evaluate(setup.pstep, setup.pds, setup.bs, score_thresh=0.4,
                      device="cpu")
    assert box == got["box_metrics"]
    jbox = want["box_metrics"]
    assert jbox["total_pred_instances"] > 0
    for k, v in jbox.items():
        # Sums of f32 IoUs and confidences over the split: 1e-5 relative.
        np.testing.assert_allclose(box[k], v, rtol=1e-5, err_msg=k)
