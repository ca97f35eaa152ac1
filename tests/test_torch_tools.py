"""The port's quality tools (livecell_tpu_torch/tools/) against the JAX
package's scripts/ on the CPU: the synthetic splits' annotations, the
model-free AP ceiling, a checkpoint's evaluation row, the oracle-box
probe's report, and the commands, JSONL and tables of the quality
matrix and the dense sweep. The scripts are imported by path as
modules; nothing under scripts/ changes. The models are
tests/util_torch_port.py's TINY f32 custom model, the same weights
saved by each package's checkpoint code; the splits are 1/1/1 frames of
each synthetic mode."""

import importlib.util
import json
import sys
import tomllib
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import livecell_tpu.utils.compilation_cache as jcc
from livecell_tpu.config import model_config_to_dict as jax_config_to_dict
from livecell_tpu.data.tiling import LIVECellPreprocessor as JaxTiler
from livecell_tpu.train import checkpoint as jax_checkpoint
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.tools import (
    dense_sweep, eval_ckpt, gt_bound, oracle_probe, quality_matrix,
    synth_splits)
from livecell_tpu_torch.train import checkpoint
from tests import util_torch_port as up
from tests.test_torch_transfer import PCFG as TRANSFER_TINY
from tests.util_fakedata import make_fake_livecell

ROOT = Path(__file__).resolve().parent.parent
FRAMES = (1, 1, 1)


def jax_script(name: str) -> types.ModuleType:
    """scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    monkeypatch.setattr(jcc, "enable_compilation_cache", lambda *a: None)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """{mode: (the port's root, JAX's root)}: 1/1/1 frames of each mode
    at seed 0, by tools/synth_splits.py and by make_fake_livecell with
    JAX's tiler (scripts/make_synth_splits.py's build, in process)."""
    out = {}
    for mode, kw in synth_splits.MODES.items():
        port = tmp_path_factory.mktemp(f"port_{mode}")
        jroot = tmp_path_factory.mktemp(f"jax_{mode}")
        synth_splits.build(mode, port, FRAMES, 0)
        make_fake_livecell(jroot / "src", images_per_split=FRAMES, seed=0,
                           **kw)
        JaxTiler(str(jroot / "src"), str(jroot / "split"),
                 total_images=sum(FRAMES)).preprocess()
        out[mode] = (port, jroot)
    return out


def annotation_files(root: Path):
    return sorted(p.relative_to(root)
                  for p in root.glob("*/annotations/*.json"))


@pytest.mark.parametrize("mode", list(synth_splits.MODES))
def test_synth_split_annotations_equal_jax(splits, mode):
    """The source and tiled COCO JSONs equal JAX's key for key (the same
    draws in the same order, the same tiler); the source frames are
    grey TIFFs that PIL reads back as the frames drawn, which differ
    from PIL's drawing only at cell edges."""
    port, jroot = splits[mode]
    files = annotation_files(jroot)
    # 1/1/1 frames: the tiler's 70/15/15 selection of 3 frames leaves
    # the val split empty (int(0.45) = 0).
    assert len(files) == 5 and annotation_files(port) == files
    for rel in files:
        assert json.loads((port / rel).read_text()) == \
            json.loads((jroot / rel).read_text()), rel
    tiles = sorted(p.name for p in (port / "split/test/images").iterdir())
    assert tiles == sorted(
        p.name for p in (jroot / "split/test/images").iterdir())
    assert len(tiles) == 25
    name = "A172_Phase_test_000.tif"
    ours = np.asarray(Image.open(port / "src/test/images" / name))
    theirs = np.asarray(Image.open(jroot / "src/test/images" / name))
    assert ours.shape == theirs.shape == (520, 704)
    # Edge pixels only: measured 0.1% (sparse) to 2.6% (dense).
    assert (ours != theirs).mean() < 0.05


@pytest.mark.parametrize("mode", ["lc", "dense"])
@pytest.mark.parametrize("caps", [["--dets", "50", "--det_nms", "0.5"],
                                  ["--dets", "256", "--det_nms", "0.6"]])
def test_gt_bound_equals_jax(splits, mode, caps, capsys):
    """The same JSON line as JAX's scripts/gt_bound.py on the same tiled
    annotations, exactly (numpy on both sides, the same seeded
    scores)."""
    port, _ = splits[mode]
    argv = ["--data_dir", str(port / "split"), "--seeds", "2"] + caps
    got = gt_bound.main(argv)
    ours = capsys.readouterr().out
    jax_script("gt_bound").main(argv)
    assert ours == capsys.readouterr().out
    assert got["n_gt_total"] > 0 and 0 < got["segm_AP"] <= 1


# ---------------------------------------------------------------------------
# A checkpoint of each package holding the same weights.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(the port's checkpoint, JAX's) of tests/util_torch_port.py's
    TINY variables: JAX's written by its own checkpoint.save with its
    sidecar, the port's by train/checkpoint.py from the converted
    model."""
    root = tmp_path_factory.mktemp("ckpts")
    v = up.jax_variables()
    jpath = str(root / "jax.ckpt")
    jax_checkpoint.save(jpath, v["params"], v["batch_stats"],
                        model_config=jax_config_to_dict(up.JAX_CFG))
    ppath = checkpoint.save(str(root / "port.ckpt"), up.port_model())
    return ppath, jpath


def run_jax(main, argv, capsys):
    """JAX's main(argv) at f32 matmul precision; what it printed."""
    with jax.default_matmul_precision("highest"):
        main(argv)
    return capsys.readouterr().out


LIFTED = ["--dets", "32", "--infer_nms", "0.7", "--det_nms", "0.6"]


def test_eval_ckpt_row_equals_jax(splits, checkpoints, capsys):
    """One row of the same keys as JAX's, every value within 1e-4 (the
    same f32 weights and tiles; the rows round to 4 places). The random
    model's predictors are scaled (PREDICTOR_SCALE), so the row holds
    detections over the GT: not a comparison of zeros. The caps are
    lifted (--dets 32 against the model's 16), which both tools apply
    over the checkpoint's config."""
    ppath, jpath = checkpoints
    argv = ["--data_dir", str(splits["lc"][0] / "split")] + LIFTED
    got = eval_ckpt.main(["--ckpt", ppath] + argv, device="cpu")
    capsys.readouterr()
    want = json.loads(run_jax(jax_script("eval_ckpt").main,
                              ["--ckpt", jpath] + argv,
                              capsys).strip().splitlines()[-1])
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
    assert (got["dets"], got["infer_nms"], got["det_nms"]) == (32, 0.7, 0.6)
    # Detections above the 0.5 score overlap the GT and a few clear IoU
    # 0.5 (box AP50 > 0): the random model matches nothing at the mask
    # thresholds.
    assert got["mean_iou"] > 0.1 and got["box_AP50"] > 0


def test_eval_ckpt_no_coco_ap_is_the_box_row(splits, checkpoints, capsys):
    """--no_coco_ap scores the box metrics alone (train/metrics.py), the
    values of the full row's box keys."""
    ppath, _ = checkpoints
    argv = ["--ckpt", ppath, "--data_dir", str(splits["lc"][0] / "split")]
    full = eval_ckpt.main(argv, device="cpu")
    boxes = eval_ckpt.main(argv + ["--no_coco_ap"], device="cpu")
    assert boxes == {k: v for k, v in full.items() if "AP" not in k}


def test_eval_ckpt_refuses_a_transfer_checkpoint(splits, tmp_path):
    """The JAX tool has no transfer path; the port's says so."""
    path = checkpoint.save(str(tmp_path / "t.ckpt"), create_transfer_model(
        TRANSFER_TINY, device="cpu"))
    with pytest.raises(SystemExit, match="transfer model"):
        eval_ckpt.main(["--ckpt", path, "--data_dir",
                        str(splits["sparse"][0] / "split")], device="cpu")


def test_eval_ckpt_refuses_a_mismatched_model(splits, checkpoints,
                                              tmp_path):
    """A checkpoint whose tensors do not fit the configured model exits
    with JAX's message."""
    ppath, _ = checkpoints
    sd = torch.load(Path(ppath) / "model.pt", weights_only=True)
    bad = tmp_path / "bad.ckpt"
    bad.mkdir()
    sd.pop(next(iter(sd)))
    torch.save(sd, bad / "model.pt")
    (bad / "model_config.json").write_text(
        (Path(ppath) / "model_config.json").read_text())
    with pytest.raises(SystemExit, match="do not match the model config"):
        eval_ckpt.main(["--ckpt", str(bad), "--data_dir",
                        str(splits["lc"][0] / "split")], device="cpu")


def test_oracle_probe_report_equals_jax(splits, checkpoints, capsys):
    """The same report as JAX's on the dense split's first tiles: the
    same keys, images and counts; every mean (each arm's and each size
    bin's) within 1e-3. Arm A is model-free, and JAX's mask targets
    differ from the port's by one count on ~5e-5 of the entries; arms
    B and C run the same weights in f32."""
    ppath, jpath = checkpoints
    argv = ["--data_dir", str(splits["dense"][0] / "split"),
            "--batch_size", "2", "--max_images", "2"]
    got = oracle_probe.main(["--ckpt", ppath] + argv, device="cpu")
    capsys.readouterr()
    printed = run_jax(jax_script("oracle_probe").main,
                      ["--ckpt", jpath] + argv, capsys)
    want = json.loads(printed[printed.index("\n{\n") + 1:])
    assert set(got) == set(want)
    assert got["images"] == want["images"] == 2
    for arm in oracle_probe.ARMS:
        g, w = got[arm], want[arm]
        assert g["n"] == w["n"] > 0 and set(g) == set(w), arm
        assert abs(g["mean"] - w["mean"]) <= 1e-3, (arm, g, w)
        assert g["by_size"].keys() == w["by_size"].keys(), arm
        for b, wb in w["by_size"].items():
            assert g["by_size"][b]["n"] == wb["n"], (arm, b)
            assert abs(g["by_size"][b]["mean"] - wb["mean"]) <= 1e-3, \
                (arm, b)
    # The TINY model's 64x96 window holds few of a 300x222 dense tile's
    # cells; arm A pastes those inside it at IoU >= 0.75 (8% of the GT).
    assert got["quant_ceiling"]["frac_ge_75"] > 0.05


# ---------------------------------------------------------------------------
# The matrix and the sweep: the children they spawn, recorded.
# ---------------------------------------------------------------------------

class Recorder:
    """A stand-in for subprocess.run: records (command, cwd) and answers
    an eval child with a row whose values follow the call count, a
    training child with a line of text."""

    def __init__(self, fail: str = ""):
        self.calls, self.fail = [], fail

    def __call__(self, cmd, cwd=None, **kw):
        self.calls.append((list(cmd), str(cwd)))
        n = len(self.calls)
        is_eval = any("eval_ckpt" in c for c in cmd)
        code = int(bool(self.fail) and (self.fail == "eval") == is_eval)
        row = {"split": "test", "dets": 50, "mask_AP": 0.1 * n,
               "mask_AP50": 0.01 * n, "mask_AP75": 0.5 / n,
               "box_AP": 0.2 / n, "f1": 0.3 + 0.01 * n}
        out = ("noise\n" + json.dumps(row) + "\n") if is_eval else \
            "Epoch 1 Training\n"
        return types.SimpleNamespace(returncode=code, stdout=out,
                                     stderr="child's own error\n")


def port_command(cmd):
    """JAX's child command as the port spells it."""
    if cmd[1].endswith("scripts/eval_ckpt.py"):
        return [cmd[0], "-m", "livecell_tpu_torch.tools.eval_ckpt"] + cmd[2:]
    return [c.replace("livecell_tpu.", "livecell_tpu_torch.") for c in cmd]


def run_both(tool: str, argv, out: Path, monkeypatch, capsys):
    """(the port's run, JAX's run): each the recorded children, what it
    printed and the JSONL it wrote to `out`.<side>, from the same
    recorded answers."""
    runs = []
    for side in ("port", "jax"):
        rec = Recorder()
        out_argv = argv + ["--out", f"{out}.{side}"]
        if side == "port":
            module = {"quality_matrix": quality_matrix,
                      "dense_sweep": dense_sweep}[tool]
            module.main(out_argv, device="cpu", runner=rec)
        else:
            module = jax_script(tool)
            monkeypatch.setattr(module, "subprocess",
                                types.SimpleNamespace(run=rec))
            monkeypatch.setattr(sys, "argv", [tool] + out_argv)
            module.main()
        runs.append((rec.calls, capsys.readouterr().out,
                     Path(f"{out}.{side}").read_text()))
    return runs


def test_quality_matrix_equals_jax(tmp_path, monkeypatch, capsys):
    """The same children (JAX's with the port's module names), the same
    printed lines and table, the same JSONL."""
    argv = ["--splits", f"sparse:{tmp_path}/s", f"dense:{tmp_path}/d",
            "--epochs", "3"]
    port, jax_ = run_both("quality_matrix", argv, tmp_path / "m.jsonl",
                          monkeypatch, capsys)
    assert port[0] == [(port_command(c), cwd) for c, cwd in jax_[0]]
    assert len(port[0]) == 6
    assert port[0][0][0][2] == "livecell_tpu_torch.train.train_custom"
    assert port[1:] == jax_[1:]
    assert "| dense | lifted |" in port[1]


def test_dense_sweep_equals_jax(tmp_path, monkeypatch, capsys):
    (tmp_path / "lc" / "split" / "train").mkdir(parents=True)
    argv = ["--split", str(tmp_path / "lc"), "--name", "lc", "--recipes",
            "a12", "a4x", "--seeds", "0", "1", "--workroot",
            str(tmp_path / "work")]
    port, jax_ = run_both("dense_sweep", argv, tmp_path / "s.jsonl",
                          monkeypatch, capsys)
    assert port[0] == [(port_command(c), cwd) for c, cwd in jax_[0]]
    assert len(port[0]) == 12
    assert "8,16,32,64" in port[0][9][0]
    # The training lines carry each run's seconds; the rest is equal.
    strip = [[ln for ln in out.splitlines() if "trained in" not in ln]
             for out in (port[1], jax_[1])]
    assert strip[0] == strip[1] and "| a4x | lifted |" in port[1]
    assert port[2] == jax_[2]


def test_relative_roots_reach_the_children_absolute(tmp_path, monkeypatch):
    """The children run from other directories than the caller's, so
    the tools hand them absolute paths (JAX's pass a relative root on
    as it is, which its children then miss)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "lc" / "split" / "train").mkdir(parents=True)
    rec = Recorder()
    quality_matrix.main(["--splits", "lc:lc", "--out", "m.jsonl"],
                        device="cpu", runner=rec)
    dense_sweep.main(["--split", "lc", "--recipes", "a12", "--seeds", "0",
                      "--workroot", "w", "--out", "s.jsonl"], device="cpu",
                     runner=rec)
    for cmd, cwd in rec.calls:
        assert Path(cwd).is_absolute()
        for flag in ("--ckpt", "--data_dir"):
            if flag in cmd and cmd[cmd.index(flag) + 1] != "split":
                assert Path(cmd[cmd.index(flag) + 1]).is_absolute(), cmd
    assert str(tmp_path / "lc" / "models") in rec.calls[1][0][4]


@pytest.mark.parametrize("fail", ["train", "eval"])
def test_a_failed_child_stops_the_tools(tmp_path, fail, capsys):
    """A child's non-zero exit stops either tool with a non-zero exit,
    after the tail of the child's output."""
    (tmp_path / "lc" / "split" / "train").mkdir(parents=True)
    for main, argv in (
            (quality_matrix.main, ["--splits", f"lc:{tmp_path}/lc"]),
            (dense_sweep.main, ["--split", str(tmp_path / "lc"),
                                "--recipes", "a12", "--seeds", "0",
                                "--workroot", str(tmp_path / "w")])):
        rec = Recorder(fail)
        with pytest.raises(SystemExit) as e:
            main(argv + ["--out", str(tmp_path / "o.jsonl")], device="cpu",
                 runner=rec)
        assert e.value.code not in (0, None) and fail in str(e.value.code)
        assert "child's own error" in capsys.readouterr().err
        assert len(rec.calls) == (1 if fail == "train" else 2)


# ---------------------------------------------------------------------------
# The console scripts.
# ---------------------------------------------------------------------------

def test_console_scripts_name_the_ports_mains():
    """pyproject.toml names seven port entry points, the counterparts of
    the JAX package's seven, each a callable `main`."""
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    jax_targets = {v for v in scripts.values()
                   if v.startswith("livecell_tpu.")}
    port = {k: v for k, v in scripts.items()
            if v.startswith("livecell_tpu_torch.")}
    assert len(jax_targets) == len(port) == 7
    assert {v.replace("livecell_tpu_torch.", "livecell_tpu.")
            for v in port.values()} == jax_targets
    for name, target in port.items():
        assert name.startswith("livecell-torch-")
        module, fn = target.split(":")
        assert callable(getattr(importlib.import_module(module), fn)), name
