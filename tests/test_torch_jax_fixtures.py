"""The committed JAX checkpoints of tests/fixtures/jax_ckpt (written by
tests/jax_ckpt_fixtures.py through the JAX package's checkpoint.save),
which chip_smoke.py's phase 22 reads on the card.

A regeneration into a temporary directory writes leaves with the
committed SHA-256s; the port reads the committed directories to those
hashes; and the port's forward on
the CPU holds the recorded JAX outputs within the tolerances phase 22
states."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from livecell_tpu_torch import native
from livecell_tpu_torch.config import TransferConfig
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.serve.app import InferenceEngine
from livecell_tpu_torch.train import checkpoint
from livecell_tpu_torch.train import jax_checkpoint as pjc
from tests import jax_ckpt_fixtures as fx

ROOT = fx.OUT
# Phase 22's tolerances (chip_smoke.py:JAX_CKPT_TOL): f32 through the
# backbone, FPN and heads against JAX's f32 on the CPU.
BOX_ATOL, SCORE_ATOL, MASK_RTOL = 1e-2, 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def committed_tables():
    return json.loads((ROOT / "leaves.json").read_text())


def test_regeneration_writes_the_committed_leaves(tmp_path):
    assert fx.write_checkpoints(tmp_path) == committed_tables()


def test_port_reads_the_committed_fixtures():
    """Through the C++ decoder (the Python one reads a checkpoint in
    tests/test_torch_jax_ckpt.py: these 550 MB of leaves take it a
    minute)."""
    assert native.backend() == "cpp"
    tables = committed_tables()
    for name in ("custom", "transfer"):
        payload = pjc.load(ROOT / name)
        assert fx.leaf_table(payload) == tables[name], name
    assert len(tables["custom"]) == 3 * 114 + 40 + 2
    assert len(tables["transfer"]) == 307


def assert_matches_recorded(boxes, scores, mask_sums, want):
    """The recorded JAX detections' first TOP_K (score order): same
    count where fewer, boxes within BOX_ATOL px, scores within
    SCORE_ATOL, mask-probability sums within MASK_RTOL."""
    k = min(fx.TOP_K, len(want["scores"]))
    order = np.argsort(-np.asarray(scores), kind="stable")[:k]
    want_order = np.argsort(-np.asarray(want["scores"]), kind="stable")[:k]
    if len(want["scores"]) <= fx.TOP_K:
        assert len(scores) == len(want["scores"])
    np.testing.assert_allclose(np.asarray(boxes)[order],
                               np.asarray(want["boxes"])[want_order],
                               rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(np.asarray(scores)[order],
                               np.asarray(want["scores"])[want_order],
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(np.asarray(mask_sums)[order],
                               np.asarray(want["mask_prob_sums"])[want_order],
                               rtol=MASK_RTOL)


def test_custom_fixture_serves_the_recorded_outputs():
    want = json.loads((ROOT / "outputs.json").read_text())["custom"]
    tile = np.load(ROOT / "tile_custom.npy")
    eng = InferenceEngine(str(ROOT / "custom"), device="cpu")
    boxes, scores, _ = eng.predict(tile, 0.0)
    det = eng.model.inference_forward(
        torch.from_numpy(tile[None].astype(np.float32) / 255.0))
    v = det.valid[0]
    sums = det.mask_probs[0][v].reshape(int(v.sum()), -1).sum(1).numpy()
    np.testing.assert_array_equal(scores, det.scores[0][v].numpy())
    assert_matches_recorded(boxes, scores, sums, want)


def test_transfer_fixture_serves_the_recorded_outputs():
    want = json.loads((ROOT / "outputs.json").read_text())["transfer"]
    tile = np.load(ROOT / "tile_transfer.npy")
    kind, cfg, sd = checkpoint.load_model_state(str(ROOT / "transfer"), "cpu")
    assert kind == "transfer" and cfg == TransferConfig()
    model = create_transfer_model(
        dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
    model.load_state_dict(sd, strict=True)
    det = model.inference_forward(
        torch.from_numpy(tile[None].astype(np.float32) / 255.0))
    v = det.valid[0]
    assert_matches_recorded(
        det.boxes[0][v].numpy(), det.scores[0][v].numpy(),
        det.mask_probs[0][v].reshape(int(v.sum()), -1).sum(1).numpy(), want)


def test_fixtures_stay_small():
    size = sum(p.stat().st_size for p in Path(ROOT).rglob("*") if p.is_file())
    assert size < 2.5 * 2 ** 20
