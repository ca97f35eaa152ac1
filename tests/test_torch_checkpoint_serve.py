"""Checkpoints that name their model, and the engine that serves either
one (train/checkpoint.py, serve/app.py), with the tracker's JSONL
(train/tracker.py), against the JAX package on the CPU.

The custom model is tests/util_torch_port.py's (64x96 input, f32) on
tests/test_torch_serve.py's 140x98 frame (25 tiles of 60x42); the
transfer model tests/test_transfer.py's TINY geometry in f32 with
weights from a seed, on a 128x84 crop of that frame cut into 4 tiles of
96x63 (its input tile).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import livecell_tpu.config as jconfig
import livecell_tpu.serve.visualize  # noqa: F401  (binds the real Config)
from livecell_tpu.config import model_config_from_dict as jax_config_from_dict
from livecell_tpu.config import model_config_to_dict as jax_config_to_dict
from livecell_tpu.serve.app import InferenceEngine as JaxEngine
from livecell_tpu.train import checkpoint as jax_checkpoint
from livecell_tpu.train.tracker import Tracker as JaxTracker
from livecell_tpu_torch.config import ModelConfig, TileConfig
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.ops.mask_ops import paste_masks
from livecell_tpu_torch.serve.app import (
    InferenceEngine, load_model, save_model)
from livecell_tpu_torch.serve.stitch import make_frame_predictor
from livecell_tpu_torch.train import checkpoint
from livecell_tpu_torch.train.tracker import Tracker
from tests import test_torch_transfer as ttr
from tests import util_torch_port as up
from tests.test_torch_serve import (
    MAX_MASK_MISMATCH, SCORE, TCFG, TOL, make_frame)

JAX_TCFG = jconfig.TileConfig(frame_width=TCFG.frame_width,
                              frame_height=TCFG.frame_height)
T_TCFG = TileConfig(frame_width=128, frame_height=84, tiles_per_image=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the test run shares the
    CPU between several workers, and torch's thread pool on top of them
    oversubscribes it, which slows the CLIs' many small ops by an order
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_frame()


def assert_masks_close(got, want):
    """Thresholded f32 probabilities: at most 0.1% of pixels flip."""
    assert got.shape == want.shape
    if got.size:
        assert np.mean(got != want) <= MAX_MASK_MISMATCH


def assert_same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Sidecars.
# ---------------------------------------------------------------------------

def test_jax_sidecar_loads_as_custom(tmp_path):
    """A sidecar of the JAX package's model_config_to_dict has no
    model_type: it loads as the custom model, JAX's routes mapped."""
    path = tmp_path / "ckpt"
    save_model(up.port_model(), str(path))
    (path / "model_config.json").write_text(
        json.dumps(jax_config_to_dict(up.JAX_CFG)))
    kind, cfg, sd = checkpoint.load_model_state(str(path), "cpu")
    assert kind == "custom" and cfg == up.PORT_CFG
    model = load_model(str(path), device="cpu")
    assert type(model).__name__ == "CustomMaskRCNN"


def test_port_custom_sidecar_reads_in_jax(tmp_path):
    """The port's custom sidecar, read by JAX's model_config_from_dict
    (which skips model_type), gives the same ModelConfig."""
    cfg = dataclasses.replace(
        up.PORT_CFG, anchor_sizes=(12, 24, 48), max_instances=64,
        heads_all_images=True, decode_proposals=True, mask_train_samples=8,
        frozen_bn=True)
    path = tmp_path / "ckpt"
    model = up.port_model()
    model.cfg = cfg
    save_model(model, str(path))
    d = json.loads((path / "model_config.json").read_text())
    assert d["model_type"] == "custom"
    jcfg = jax_config_from_dict(d)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def test_unknown_model_type_raises(tmp_path):
    path = tmp_path / "ckpt"
    save_model(up.port_model(), str(path))
    d = json.loads((path / "model_config.json").read_text())
    (path / "model_config.json").write_text(
        json.dumps(dict(d, model_type="unet")))
    with pytest.raises(ValueError, match="unet"):
        checkpoint.load_model_state(str(path), "cpu")


def test_transfer_checkpoint_round_trip(tmp_path):
    """A transfer model saves with its TransferConfig, restores as a
    training model under the strict load, and loads as a serving one."""
    model = create_transfer_model(ttr.PCFG, torch.Generator().manual_seed(3),
                                  device="cpu", train=True)
    path = checkpoint.save(str(tmp_path / "ckpt"), model, epoch=2,
                           train_losses=[3.5, 2.5])
    d = json.loads((tmp_path / "ckpt/model_config.json").read_text())
    assert d["model_type"] == "transfer" and d["tile_width"] == 96
    kind, cfg, _ = checkpoint.load_model_state(path, "cpu")
    assert kind == "transfer" and cfg == ttr.PCFG
    restored, opt, meta = checkpoint.restore(path, device="cpu")
    assert type(restored).__name__ == "TransferMaskRCNN"
    assert restored.training and opt is None
    assert meta == {"epoch": 2, "train_losses": [3.5, 2.5]}
    served = load_model(path, device="cpu")
    assert not served.training and served.cfg == ttr.PCFG
    for (k, a), (_, b), (_, c) in zip(model.state_dict().items(),
                                      restored.state_dict().items(),
                                      served.state_dict().items()):
        assert torch.equal(a, b) and torch.equal(a, c.to(a.dtype)), k


def test_restore_refuses_the_other_model_type(tmp_path):
    """A transfer checkpoint restored into a caller's custom model
    raises; into a transfer model it loads."""
    model = create_transfer_model(ttr.PCFG, torch.Generator().manual_seed(3),
                                  device="cpu", train=True)
    path = checkpoint.save(str(tmp_path / "ckpt"), model, epoch=1)
    with pytest.raises(ValueError, match="holds a transfer model"):
        checkpoint.restore(path, "cpu", model=up.port_model())
    other = create_transfer_model(ttr.PCFG, torch.Generator().manual_seed(4),
                                  device="cpu", train=True)
    got, opt, meta = checkpoint.restore(path, "cpu", model=other)
    assert got is other and opt is None and meta == {"epoch": 1}
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# The engine: custom against JAX's.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def custom_engines(tmp_path_factory):
    """engines(dets) -> (JAX's engine over a JAX checkpoint of the test
    variables, written by JAX's own checkpoint.save with its sidecar; the
    port's over the same variables converted and saved by the port)."""
    root = tmp_path_factory.mktemp("engines")
    v = up.jax_variables()
    jpath = str(root / "jax_ckpt")
    jax_checkpoint.save(jpath, v["params"], v["batch_stats"],
                        model_config=jax_config_to_dict(up.JAX_CFG))
    ppath = str(root / "port_ckpt")
    save_model(up.port_model(), ppath)
    built = {}

    def engines(dets):
        if dets not in built:
            # JAX's engine takes its tile geometry and its tile path's
            # input size from Config(), not from the checkpoint: the
            # test's Config() holds the test frame's tiles and model.
            real = jconfig.Config
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jconfig, "Config",
                           lambda: real(tile=JAX_TCFG, model=up.JAX_CFG))
                jeng = JaxEngine(jpath, "custom", dets=dets)
            built[dets] = (jeng, InferenceEngine(
                ppath, tile_cfg=TCFG, device="cpu", dets=dets))
        return built[dets]

    return engines


@pytest.mark.parametrize("request_kind,dets", [("tile", 0), ("frame", 0),
                                               ("frame", 8)])
def test_custom_engine_matches_jax(custom_engines, frame, dets,
                                   request_kind):
    """The dense flags (dets=8) change the stored config in both."""
    jeng, peng = custom_engines(dets)
    assert peng.model_type == "custom"
    want_cfg = up.PORT_CFG if not dets else dataclasses.replace(
        up.PORT_CFG, infer_pre_topk=40, infer_post_nms=8, max_detections=8)
    assert peng.cfg.model == want_cfg
    image = frame if request_kind == "frame" else \
        frame[:TCFG.tile_height, :TCFG.tile_width]
    with jax.default_matmul_precision("highest"):
        jb, js, jm = jeng.predict(image, SCORE)
    pb, ps, pm = peng.predict(image, SCORE)
    assert len(ps) >= 2 and len(ps) == len(js)
    # f32 results of the same selections: rtol/atol 1e-4.
    np.testing.assert_allclose(pb, jb, **TOL)
    np.testing.assert_allclose(ps, js, **TOL)
    assert pm.shape == (len(ps),) + image.shape[:2]
    assert_masks_close(pm, jm)


# ---------------------------------------------------------------------------
# The engine: transfer, against the port's own forward and predictor.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def transfer_served(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("transfer") / "ckpt")
    model = create_transfer_model(ttr.PCFG, torch.Generator().manual_seed(0),
                                  device="cpu")
    save_model(model, path)
    return path, model


@pytest.fixture(scope="module")
def t_frame(frame):
    return np.ascontiguousarray(frame[:T_TCFG.frame_height,
                                      :T_TCFG.frame_width])


def test_transfer_engine_tile_is_inference_forward(transfer_served,
                                                   t_frame):
    """The tile path pads to the transfer model's input tile
    (tile_height x tile_width, not its canvas) and runs one forward."""
    path, model = transfer_served
    eng = InferenceEngine(path, model_type="transfer", tile_cfg=T_TCFG,
                          device="cpu")
    assert eng.model_type == "transfer" and eng.model.cfg == ttr.PCFG
    tile = t_frame[:50, :70]
    h, w = tile.shape[:2]
    ih, iw = ttr.PCFG.tile_height, ttr.PCFG.tile_width
    canvas = np.zeros((1, ih, iw, 3), np.float32)
    canvas[0, :h, :w] = tile / np.float32(255.0)
    det = model.inference_forward(torch.from_numpy(canvas))
    keep = det.valid[0] & (det.scores[0] > 0.0)
    full = paste_masks(det.mask_probs[0], det.boxes[0], (ih, iw),
                       valid=keep)
    k = keep.numpy()
    want = (det.boxes[0].numpy()[k], det.scores[0].numpy()[k],
            full.numpy()[k][:, :h, :w] > 0)
    got = eng.predict(tile, 0.0)
    assert len(got[1]) >= 2
    assert_same(got, want)


def test_transfer_engine_frame_is_frame_predictor(transfer_served,
                                                  t_frame):
    path, model = transfer_served
    eng = InferenceEngine(path, tile_cfg=T_TCFG, device="cpu")
    run = make_frame_predictor(model, T_TCFG, score_threshold=0.0,
                               device="cpu")
    tiles = np.stack([t_frame[y:y + T_TCFG.tile_height,
                              x:x + T_TCFG.tile_width]
                      for y in (0, T_TCFG.mini_tile_height)
                      for x in (0, T_TCFG.mini_tile_width)])
    dets = run(tiles)
    keep = dets.scores > 0.0
    h, w = t_frame.shape[:2]
    masks = np.zeros((int(keep.sum()), h, w), bool)
    for i, k in enumerate(np.nonzero(keep)[0]):
        ox, oy = dets.offsets[k].astype(int)
        m = dets.masks[k][:h - oy, :w - ox]
        masks[i, oy:oy + m.shape[0], ox:ox + m.shape[1]] = m
    got = eng.predict(t_frame, 0.0)
    assert len(got[1]) >= 2
    assert_same(got, (dets.boxes[keep], dets.scores[keep], masks))


def test_transfer_engine_refusals(transfer_served):
    """A model_type that disagrees with the checkpoint raises; so do the
    dense flags, which a transfer model does not have (JAX drops them
    silently)."""
    path, model = transfer_served
    with pytest.raises(ValueError, match="model_type"):
        InferenceEngine(path, model_type="custom", device="cpu")
    with pytest.raises(ValueError, match="custom model only"):
        InferenceEngine(model=model, dets=8, device="cpu")
    with pytest.raises(ValueError, match="model_type"):
        InferenceEngine(model=up.port_model(), model_type="transfer",
                        device="cpu")


# ---------------------------------------------------------------------------
# The tracker.
# ---------------------------------------------------------------------------

def tracker_lines(cls, root, monkeypatch):
    monkeypatch.chdir(root)
    t = cls(True, "proj", "run1", {"lr": 0.1, "bs": 4})
    t.update_config({"total_params": 5, "custom_percentage": 63.9})
    t.log({"epoch": 1, "train/total_loss": 2.0, "val/f1_score": 0.5})
    t.log_image("training_plot", "outputs/custom_training_plot.png")
    t.log({"test/mask_AP": 0.25})
    t.finish()
    disabled = cls(False, "proj", "run2")
    disabled.log({"epoch": 1})
    disabled.finish()
    lines = [json.loads(ln) for ln in
             (root / "outputs/runs/run1.jsonl").read_text().splitlines()]
    assert not (root / "outputs/runs/run2.jsonl").exists()
    for ln in lines:
        ln.pop("time", None)
    return lines


def test_tracker_jsonl_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = tracker_lines(JaxTracker, tmp_path / "jax", monkeypatch)
    got = tracker_lines(Tracker, tmp_path / "port", monkeypatch)
    assert got == want
    assert [ln["event"] for ln in got] == ["init", "config_update", "log",
                                           "image", "log"]


def test_custom_model_config_default_has_no_transfer_fields():
    """The custom sidecar holds ModelConfig's fields and model_type, no
    more: JAX's reader sees only keys it knows or skips."""
    from livecell_tpu_torch.config import config_to_dict
    d = config_to_dict(ModelConfig())
    assert set(d) - {"model_type"} == {
        f.name for f in dataclasses.fields(jconfig.ModelConfig)}
