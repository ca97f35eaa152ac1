"""The port's benchmark and study tools (livecell_tpu_torch/tools/
bench_serve.py, bench_transfer_nms.py, bench_nms.py, bench_conv1.py,
bench_roi_blocks.py, check_torch_import.py) on the CPU, against the JAX
package's scripts/ imported by path where a script's output is a
function of its inputs:

  * bench_nms: nms_fixed's indices equal JAX's on the script's draws;
  * bench_conv1: the space-to-depth kernel regroup equal to JAX's
    `_s2d_kernel`, each form within 1e-5 of the plain convolution, and
    the plain one of JAX's;
  * check_torch_import: the P2-P5 features and RPN objectness of
    tests/util_torchvision_fake.py's file equal JAX's `run_ours` within
    1e-5 of their magnitude (both f32), JAX's zero-shot gate refusal
    word for word, and with the RPN bias leaned by +3 the same
    "import OK (tier 2)" line;
  * bench_serve: the tiling frame count of JAX's preprocessor on the
    same fake tree, and every row's keys.

Every tool's main runs with device="cpu" at a small size (the tool
modules' configs and sizes monkeypatched, never edited)."""

import functools
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import livecell_tpu.models.transfer as jax_transfer
from livecell_tpu.data.tiling import LIVECellPreprocessor as JaxTiler
from livecell_tpu.ops.nms import nms_fixed as jax_nms_fixed
from livecell_tpu_torch.config import ModelConfig, TileConfig, TransferConfig
from livecell_tpu_torch.ops.nms import nms_fixed
from livecell_tpu_torch.tools import (
    bench_conv1, bench_nms, bench_roi_blocks, bench_serve,
    bench_transfer_nms, check_torch_import)
from livecell_tpu_torch.tools.synth_splits import make_fake_livecell
from tests.util_torchvision_fake import fake_torchvision_maskrcnn_state_dict

ROOT = Path(__file__).resolve().parent.parent
# The transfer model on the fixture's 224x304 tile, a 256x384 canvas, in
# f32 (both packages).
IMPORT_CANVAS = dict(image_height=256, resized_width=347, image_width=384,
                     compute_dtype="float32")
TINY_TRANSFER = dict(tile_height=64, tile_width=96, image_height=128,
                     image_width=192, resized_width=192, box_batch=32,
                     mask_slots=8, max_detections=8, rpn_batch=32,
                     compute_dtype="float32")
TINY_CUSTOM = dict(image_height=64, image_width=96, compute_dtype="float32",
                   infer_pre_topk=64, infer_post_nms=16, max_detections=16)


def jax_script(name: str) -> types.ModuleType:
    """scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run shares the cores among workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# bench_nms.
# ---------------------------------------------------------------------------

def test_nms_indices_equal_jax():
    """The script's draws at 4 x 200 -> 60 at 0.7 and 0.4: the kept
    indices and their validity equal JAX's vmapped nms_fixed."""
    boxes, scores = bench_nms.draw(np.random.default_rng(0), 4, 200)
    for thresh in (0.7, 0.4):
        idx, ok = nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                            thresh, 60)
        jidx, jok = jax.vmap(lambda b, s: jax_nms_fixed(b, s, thresh, 60))(
            jnp.asarray(boxes), jnp.asarray(scores))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(idx.numpy()[ok.numpy()],
                                      np.asarray(jidx)[np.asarray(jok)])
        assert ok.sum() > 0


def test_bench_nms_main(monkeypatch, capsys):
    monkeypatch.setattr(bench_nms, "SHAPES", [("tiny", 2, 30, 10, 0.7)])
    monkeypatch.setattr(bench_nms, "ITERS", 2)
    rows = bench_nms.main([], device="cpu")
    assert capsys.readouterr().out.count("nms_tiny_torch") == 1
    assert set(rows[0]) == {"metric", "value", "unit", "batch", "n", "keep",
                            "launches", "graph_launches", "card"}
    assert rows[0]["launches"] is None and rows[0]["value"] > 0
    assert rows[0]["graph_launches"] is None


# ---------------------------------------------------------------------------
# bench_conv1.
# ---------------------------------------------------------------------------

def test_s2d_kernel_equals_jax():
    """The regrouped [O, 12, 4, 4] kernel is JAX's [4, 4, 12, O] one in
    OIHW, exactly (a permutation of the same values and zeros)."""
    w = np.random.default_rng(1).normal(size=(7, 7, 3, 8)).astype(np.float32)
    want = np.asarray(jax_script("bench_conv1")._s2d_kernel(jnp.asarray(w)))
    got = bench_conv1.s2d_kernel(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


def test_conv_forms_agree():
    """s2d and im2col within 1e-5 of plain (relative to its largest
    output, f32 sums in another order), and plain within 1e-5 of JAX's
    plain convolution, on the script's kind of input at 2 x 32 x 24."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 24, 3)).astype(np.float32)
    k = (rng.normal(size=(7, 7, 3, 16)) * 0.1).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tk = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    ref = bench_conv1.conv_plain(tx, tk)
    scale = ref.abs().max().item()
    for name, fn in bench_conv1.VARIANTS.items():
        got = fn(tx, tk)
        assert got.shape == ref.shape == (2, 16, 16, 12), name
        assert (got - ref).abs().max().item() <= 1e-5 * scale, name
    with jax.default_matmul_precision("highest"):
        jref = np.asarray(jax_script("bench_conv1")._conv_plain(
            jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(ref.permute(0, 2, 3, 1).numpy(), jref,
                               atol=1e-5 * scale, rtol=0)


def test_bench_conv1_main(monkeypatch):
    for name, v in (("BATCH", 2), ("HEIGHT", 32), ("WIDTH", 24),
                    ("CALLS", 2)):
        monkeypatch.setattr(bench_conv1, name, v)
    rows = bench_conv1.main([], device="cpu")
    checks = [r for r in rows if "check" in r]
    assert [r["check"] for r in checks] == ["plain", "s2d", "im2col"]
    assert all(r["rel_err"] <= 1e-5 for r in checks)
    assert [set(r) for r in rows[3:]] == [
        {"variant", "fwd_ms", "fwd_wgrad_ms", "card"}] * 3


# ---------------------------------------------------------------------------
# bench_roi_blocks and bench_transfer_nms.
# ---------------------------------------------------------------------------

def test_bench_roi_blocks_main(monkeypatch):
    """Both passes checked and timed; on the CPU the wrappers take their
    plain versions (equal) and no geometry is read."""
    monkeypatch.setattr(bench_roi_blocks, "FEAT", (2, 16, 24, 256))
    monkeypatch.setattr(bench_roi_blocks, "CALLS", 2)
    rows = bench_roi_blocks.main([], device="cpu")
    assert [r["k"] for r in rows] == [128, 64]
    for r in rows:
        assert r["k1_equal_to_plain"] and r["k2_max_err"] == 0
        assert r["k3_max_err"] == 0 and r["geometry"] is None
        assert r["fwd_ms"] > 0 and r["fwdbwd_ms"] > 0


def test_bench_transfer_nms_main(monkeypatch):
    monkeypatch.setattr(bench_transfer_nms, "TransferConfig",
                        functools.partial(TransferConfig, **TINY_TRANSFER))
    rec = bench_transfer_nms.main(["--steps", "1"], device="cpu")
    assert set(rec) == {"topk_512_ms", "topk_1000_ms", "parity_cost_ms",
                        "card"}
    assert rec["parity_cost_ms"] == pytest.approx(
        rec["topk_1000_ms"] - rec["topk_512_ms"], abs=0.011)


# ---------------------------------------------------------------------------
# check_torch_import.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """The fake torchvision file, and the same with the RPN objectness
    bias leaned by +3 (a peak that passes the zero-shot gate)."""
    d = tmp_path_factory.mktemp("weights")
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in fake_torchvision_maskrcnn_state_dict().items()}
    torch.save(sd, d / "fake.pth")
    sd["rpn.head.cls_logits.bias"] = sd["rpn.head.cls_logits.bias"] + 3.0
    torch.save(sd, d / "leaned.pth")
    return str(d / "fake.pth"), str(d / "leaned.pth")


def test_check_torch_import_equals_jax(weight_files, monkeypatch, capsys):
    monkeypatch.setattr(check_torch_import, "TransferConfig",
                        functools.partial(TransferConfig, **IMPORT_CANVAS))
    monkeypatch.setattr(jax_transfer, "TransferConfig", functools.partial(
        jax_transfer.TransferConfig, **IMPORT_CANVAS))
    script = jax_script("check_torch_import")
    img = check_torch_import.fixture_image()
    np.testing.assert_array_equal(img, script.fixture_image())
    jax_outputs = {}
    run_jax = script.run_ours

    def cached_run(weights, im):
        if weights not in jax_outputs:
            jax_outputs[weights] = run_jax(weights, im)
        return jax_outputs[weights]

    monkeypatch.setattr(script, "run_ours", cached_run)
    fake, leaned = weight_files
    feats, obj = check_torch_import.run_ours(fake, img, "cpu")
    jfeats, jobj = cached_run(fake, img)
    assert [f.shape for f in feats] == [f.shape for f in jfeats]
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f, jf, rtol=0,
                                   atol=1e-5 * np.abs(jf).max())
    np.testing.assert_allclose(obj, jobj, rtol=0,
                               atol=1e-5 * np.abs(jobj).max())

    with pytest.raises(AssertionError) as ours:
        check_torch_import.main(["--weights", fake], device="cpu")
    monkeypatch.setattr(sys, "argv", ["check", "--weights", fake])
    with pytest.raises(AssertionError) as theirs:
        script.main()
    assert str(ours.value) == str(theirs.value)
    assert "zero-shot RPN peak objectness" in str(ours.value)

    capsys.readouterr()
    res = check_torch_import.main(["--weights", leaned], device="cpu")
    line = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["check", "--weights", leaned])
    script.main()
    assert line == capsys.readouterr().out
    assert line.startswith("import OK (tier 2)")
    assert res["tier"] == 2 and res["peak_objectness"] > 0.7


# ---------------------------------------------------------------------------
# bench_serve.
# ---------------------------------------------------------------------------

def test_tiling_frame_count_equals_jax(tmp_path):
    """On one fake tree of 8/1/1 frames, JAX's preprocessor tiles as many
    frames as the port's (its 70/15/15 split of int(8 / 0.7) = 11)."""
    make_fake_livecell(tmp_path / "src", images_per_split=(8, 1, 1),
                       cells_per_image=4)
    ours = bench_serve.tile_tree(tmp_path / "src", tmp_path / "port", 8)
    JaxTiler(str(tmp_path / "src"), str(tmp_path / "jax"),
             total_images=int(8 / 0.7)).preprocess()
    theirs = sum(len(list((tmp_path / "jax" / s / "images").glob("*.png")))
                 for s in ("train", "val", "test")) / 25
    assert ours["frames"] == theirs == 9


def test_bench_serve_main(monkeypatch, capsys):
    """Every row's keys: JAX's, with host_ms in place of rtt_ms /
    host_rtt_ms and the card named; tiling adds its frame count."""
    monkeypatch.setattr(bench_serve, "ModelConfig",
                        functools.partial(ModelConfig, **TINY_CUSTOM))
    monkeypatch.setattr(bench_serve, "TileConfig", functools.partial(
        TileConfig, frame_width=160, frame_height=112))
    monkeypatch.setattr(bench_serve, "TILING_FRAMES", (2, 1, 1))
    monkeypatch.setattr(bench_serve, "PIPELINE_FRAMES", 2)
    rows = bench_serve.main([], device="cpu")
    printed = capsys.readouterr().out
    assert [r["metric"] for r in rows] == [
        "tiling_frames_per_sec", "single_tile_inference_p50_ms",
        "full_frame_serve_p50_ms", "pipelined_serve_fps"]
    assert all(f'"{r["metric"]}"' in printed for r in rows)
    latency = {"metric", "value", "unit", "device_ms", "host_ms", "card"}
    assert [set(r) for r in rows] == [
        {"metric", "value", "unit", "frames"}, latency, latency,
        {"metric", "value", "unit", "frames", "decode_ms", "device_ms",
         "overlay_ms", "serial_sum_ms", "card"}]
    assert rows[0]["frames"] == 2 and rows[3]["frames"] == 2
    assert all(r["value"] > 0 for r in rows)
