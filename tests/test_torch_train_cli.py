"""The port's trainer CLIs (train/train_custom.py, train/train_transfer.py)
vs the JAX package's, on the CPU at tests/test_model.py's TINY geometry
(custom) and tests/test_transfer.py's (transfer), over a tiny tiled split
(4/1/1 frames of tests/util_fakedata.py's uniform ellipses, tiled by the
JAX package's tiler, trimmed to 8/4/4 tiles).

The configs, instance slots, index matrices and learning rates are
compared with JAX's exactly; JAX's `main` is stopped where it has built
them (a monkeypatched function raises a sentinel carrying them), so no
JAX step is compiled. The port's own runs are compared bit for bit:
--device_data on vs off, a resumed run vs a straight one, stage 1's
frozen modules across the stage.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import livecell_tpu.data.dataset as jds
import livecell_tpu.models.mask_rcnn as jmr
import livecell_tpu.models.transfer as jtr
import livecell_tpu.utils.compilation_cache as jcc
from livecell_tpu.config import Config as JaxConfig
from livecell_tpu.config import model_config_to_dict as jax_config_to_dict
from livecell_tpu.data.device_data import epoch_indices as jax_epoch_indices
from livecell_tpu.data.tiling import LIVECellPreprocessor
from livecell_tpu.train import train_custom as jtc
from livecell_tpu.train import train_transfer as jtt
from livecell_tpu_torch.config import (
    Config, ModelConfig, TransferConfig, model_config_from_dict)
from livecell_tpu_torch.models.mask_rcnn import (
    count_parameters, create_model, create_train_model)
from livecell_tpu_torch.models.torch_import import load_torchvision_weights
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.data.dataset import get_datasets
from livecell_tpu_torch.parallel.train_step import make_step_fn, scheduled_lr
from livecell_tpu_torch.train import train_custom as tc
from livecell_tpu_torch.train import train_transfer as tt
from livecell_tpu_torch.train.checkpoint import load_model_state
from livecell_tpu_torch.train.train_transfer import FROZEN_STAGE1
from livecell_tpu_torch.utils.flops import count_flops
from tests.test_model import TINY
from tests.test_transfer import TINY as JAX_TTINY
from tests.util_fakedata import make_fake_livecell
from tests.util_torchvision_fake import fake_torchvision_maskrcnn_state_dict

PORT_TINY = model_config_from_dict(jax_config_to_dict(TINY))
PORT_TTINY = TransferConfig(**{f.name: getattr(JAX_TTINY, f.name)
                               for f in dataclasses.fields(TransferConfig)})
FLAGSHIP = ["--fixed_heads", "--decode_proposals", "--mask_samples", "8"]
SPLIT_TILES = {"train": 8, "val": 4, "test": 4}


class Captured(Exception):
    def __init__(self, **kw):
        super().__init__("captured")
        self.kw = kw


def capture(*names):
    """A stand-in that raises Captured carrying its positional arguments
    under `names` and its keyword arguments."""
    def fn(*args, **kw):
        raise Captured(**dict(zip(names, args)), **kw)
    return fn


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


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    """JAX's trainers turn on a persistent compile cache in the repo;
    these tests compile nothing."""
    monkeypatch.setattr(jcc, "enable_compilation_cache", lambda *a: None)


def write_split(root: Path, seed: int = 0, **fake) -> Path:
    """4/1/1 frames of uniform ellipses tiled by the JAX tiler, each
    split's annotation file trimmed to SPLIT_TILES tiles."""
    src = make_fake_livecell(root / "src", images_per_split=(4, 1, 1),
                             seed=seed, **fake)
    out = root / "split"
    LIVECellPreprocessor(str(src), str(out), total_images=7).preprocess()
    for split, n in SPLIT_TILES.items():
        path = out / "annotations" / f"livecell_coco_{split}.json"
        d = json.loads(path.read_text())
        keep = {im["id"] for im in d["images"][:n]}
        d["images"] = [im for im in d["images"] if im["id"] in keep]
        d["annotations"] = [a for a in d["annotations"]
                            if a["image_id"] in keep]
        path.write_text(json.dumps(d))
    return out


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("sparse"))


def run_custom(argv, cwd, monkeypatch, split):
    monkeypatch.chdir(cwd)
    return tc.main(["--data_dir", str(split), "--batch_size", "4"] + argv,
                   config=Config(model=PORT_TINY), device="cpu")


def run_transfer(argv, cwd, monkeypatch, split):
    monkeypatch.chdir(cwd)
    return tt.main(["--data_dir", str(split), "--batch_size", "4",
                    "--clip_grad_norm", "10"] + argv,
                   transfer_cfg=PORT_TTINY, device="cpu")


def assert_states_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_states_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                if isinstance(x, dict):
                    assert_states_equal(x, y)
                else:
                    assert x == y, k
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# The model config each CLI builds from its flags.
# ---------------------------------------------------------------------------

CUSTOM_ARGVS = {
    "defaults": [],
    "flagship": FLAGSHIP + ["--frozen_bn", "--lr_step_size", "6"],
    "dense": ["--dets", "256", "--infer_nms", "0.7", "--det_nms", "0.6"],
    "train_shape": ["--anchor_sizes", "12,24,48", "--anchor_ratios",
                    "0.5,1,2,3", "--train_topk", "300", "--train_samples",
                    "64", "--rpn_batch", "512", "--rpn_pos", "64",
                    "--stem_s2d"],
    "jax_routes": ["--roi_backend", "pallas", "--match_backend", "xla",
                   "--topk_backend", "approx"],
}


@pytest.mark.parametrize("case", sorted(CUSTOM_ARGVS))
def test_custom_model_config_matches_jax(case, monkeypatch, tmp_path):
    argv = ["--data_dir", str(tmp_path)] + CUSTOM_ARGVS[case]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jds, "get_datasets", capture("root", "mcfg"))
    with pytest.raises(Captured) as want:
        jtc.main(argv)
    monkeypatch.setattr(tc, "get_datasets", capture("root", "mcfg"))
    with pytest.raises(Captured) as got:
        tc.main(argv, device="cpu")
    jcfg, pcfg = want.value.kw["mcfg"], got.value.kw["mcfg"]
    # JAX's route names load as the port's (config.JAX_ROUTES).
    assert pcfg == model_config_from_dict(jax_config_to_dict(jcfg))
    assert (pcfg.roi_backend, pcfg.match_backend) == ("auto", "auto")
    if case == "jax_routes":
        assert (jcfg.roi_backend, jcfg.topk_backend) == ("pallas", "approx")
        assert pcfg.topk_backend == "exact"
    else:
        assert jax_config_to_dict(jcfg) == jax_config_to_dict(pcfg)


TRANSFER_ARGVS = {
    "defaults": [],
    "frozen_on": ["--frozen_bn", "on"],
    "pretrained_auto": ["--pretrained", "weights.pth"],
    "pretrained_frozen_off": ["--pretrained", "weights.pth",
                              "--frozen_bn", "off"],
}


@pytest.mark.parametrize("case", sorted(TRANSFER_ARGVS))
def test_transfer_config_matches_jax(case, monkeypatch, tmp_path):
    """The TransferConfig and the dataset config the transfer CLI builds
    are JAX's."""
    argv = ["--data_dir", str(tmp_path)] + TRANSFER_ARGVS[case]
    monkeypatch.chdir(tmp_path)
    seen = {}

    def datasets(root, dcfg, **kw):
        seen.setdefault("dcfg", []).append(dcfg)
        return {"train": None}

    monkeypatch.setattr(jds, "get_datasets", datasets)
    monkeypatch.setattr(jtr, "create_transfer_model", capture())
    with pytest.raises(Captured) as want:
        jtt.main(argv)
    monkeypatch.setattr(tt, "get_datasets", datasets)
    monkeypatch.setattr(tt, "create_transfer_model", capture("cfg"))
    with pytest.raises(Captured) as got:
        tt.main(argv, device="cpu")
    jcfg, pcfg = want.value.kw["cfg"], got.value.kw["cfg"]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert pcfg.frozen_bn == (case in ("frozen_on", "pretrained_auto"))
    jd, pd = seen["dcfg"]
    assert jax_config_to_dict(jd) == jax_config_to_dict(pd)


def test_parameter_counts_match_jax():
    """count_parameters (meta.json's param_info) gives JAX's per
    subsystem, from the shapes of JAX's variables."""
    rois = np.zeros((1, TINY.roi_output_size, TINY.roi_output_size,
                     TINY.fpn_channels), np.float32)
    shapes = jax.eval_shape(
        lambda k: jmr.CustomMaskRCNN(TINY).init(
            {"params": k}, np.zeros((1, 64, 64, 3), np.float32), rois,
            method="init_forward"), jax.random.key(0))
    assert count_parameters(create_model(PORT_TINY, device="cpu")) == \
        jmr.count_parameters(shapes["params"])


# ---------------------------------------------------------------------------
# Instance slots, index matrices and learning rates.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_split(tmp_path_factory):
    """Up to ~110 instances a tile: slots grow past the default."""
    return write_split(tmp_path_factory.mktemp("dense"), seed=1,
                       cells_per_image=500)


@pytest.mark.parametrize("which", ["sparse", "dense"])
def test_instance_slots_match_jax(which, split, dense_split, monkeypatch,
                                  tmp_path):
    """The slots sized to the split (JAX stopped at create_model, after
    the resize) and written back to every dataset's config."""
    root = split if which == "sparse" else dense_split
    argv = ["--data_dir", str(root), "--batch_size", "4"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jmr, "create_model", capture("mcfg"))
    with pytest.raises(Captured) as want:
        jtc.main(argv, config=JaxConfig(model=TINY))
    made = {}
    real = tc.get_datasets

    def spy(*a, **kw):
        made.update(real(*a, **kw))
        return made

    monkeypatch.setattr(tc, "get_datasets", spy)
    monkeypatch.setattr(tc, "create_train_model", capture("mcfg"))
    with pytest.raises(Captured) as got:
        tc.main(argv, config=Config(model=PORT_TINY), device="cpu")
    jslots = want.value.kw["mcfg"].max_instances
    assert got.value.kw["mcfg"].max_instances == jslots
    observed = max(int(ds.instance_counts().max()) for ds in made.values())
    assert jslots == min(max(32, -(-observed // 32) * 32), 512)
    assert (jslots == 32) == (which == "sparse")
    assert all(ds.cfg.max_instances == jslots for ds in made.values())
    images, targets = made["train"].gather(np.arange(2))
    assert targets["valid"].shape == (2, jslots)


def spy_indices(module, monkeypatch):
    calls = []
    real = module.epoch_indices

    def spy(n, bs, shuffle, seed):
        out = real(n, bs, shuffle, seed)
        calls.append((n, bs, shuffle, seed, out))
        return out

    monkeypatch.setattr(module, "epoch_indices", spy)
    return calls


def test_custom_epoch_plan_matches_jax(split, monkeypatch, tmp_path):
    """Each epoch's index matrix is JAX's epoch_indices(n, bs, True,
    seed + epoch); each update's learning rate is JAX's schedule at its
    step count (optax's count), and the logged one its epoch's."""
    calls = spy_indices(tc, monkeypatch)
    out = run_custom(["--num_epochs", "3", "--lr_step_size", "1",
                      "--seed", "5", "--use_wandb"], tmp_path, monkeypatch,
                     split)
    n = SPLIT_TILES["train"]
    assert [c[3] for c in calls] == [6, 7, 8]
    for (cn, bs, shuffle, seed, got) in calls:
        np.testing.assert_array_equal(got, jax_epoch_indices(
            n, 4, True, seed))
    spe = out["steps_per_epoch"]
    _, schedule = jtc.build_optimizer(1e-3, 1e-4, spe, 1, 0.1)
    group = dict(out["optimizer"].param_groups[0])
    assert group["schedule_step"] == 3 * spe
    for t in range(3 * spe):
        # Both 1e-3 * 0.1 ** k, from the same integers: 1e-7 relative
        # (f32 schedule vs Python floats).
        np.testing.assert_allclose(
            scheduled_lr(dict(group, schedule_step=t)),
            float(schedule(t)), rtol=1e-7)
    logs = [json.loads(ln) for ln in (tmp_path / "outputs/runs/"
            "custom_lr0.001_bs4_ep3.jsonl").read_text().splitlines()]
    lrs = [ln["dynamics/learning_rate"] for ln in logs
           if "dynamics/learning_rate" in ln]
    np.testing.assert_allclose(
        lrs, [float(schedule(e * spe)) for e in range(3)], rtol=1e-7)


# ---------------------------------------------------------------------------
# The custom CLI end to end.
# ---------------------------------------------------------------------------

def test_custom_cli_end_to_end(split, monkeypatch, tmp_path):
    out = run_custom(FLAGSHIP + ["--num_epochs", "1", "--coco_ap",
                                 "--use_wandb", "--save_every", "1"],
                     tmp_path, monkeypatch, split)
    ckpt = tmp_path / "models/custom_maskrcnn_1epochs.ckpt"
    assert sorted(os.listdir(ckpt)) == ["meta.json", "model.pt",
                                        "model_config.json", "optimizer.pt"]
    # --save_every skips the last epoch, which the final save covers.
    assert not (tmp_path / "models/custom_maskrcnn_epoch1.ckpt").exists()
    assert (tmp_path / "outputs/custom_training_plot.png").exists()
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epoch"] == 1 and meta["train_losses"] == out["train_losses"]
    assert meta["val_metrics"] == out["val_metrics"]
    assert meta["param_info"] == count_parameters(out["model"])
    assert np.isfinite(meta["train_losses"]).all()
    sidecar = json.loads((ckpt / "model_config.json").read_text())
    assert sidecar["model_type"] == "custom"
    assert sidecar["max_instances"] == 32 and sidecar["heads_all_images"]
    kind, cfg, sd = load_model_state(str(ckpt), "cpu")
    assert kind == "custom" and cfg == out["model"].cfg
    assert_states_equal(sd, out["model"].state_dict())
    assert 0.0 <= out["test_ap"]["AP50"] <= 1.0

    # The tracker's events and keys: JAX's (train_custom.py:386-475).
    lines = [json.loads(ln) for ln in (tmp_path / "outputs/runs/"
             "custom_lr0.001_bs4_ep1.jsonl").read_text().splitlines()]
    assert [ln["event"] for ln in lines] == [
        "init", "config_update", "log", "log", "image", "log", "log"]
    assert lines[0]["config"]["weight_decay"] == 1e-4
    assert set(lines[1]["config"]) == {
        "total_params", "custom_params", "cbam_params",
        "custom_percentage", "model_memory_mb"}
    assert set(lines[2]) - {"event", "time"} == {
        "epoch", "train/total_loss", "train/rpn_cls_loss",
        "train/box_cls_loss", "train/box_reg_loss", "train/mask_loss",
        "dynamics/gradient_norm_mean", "dynamics/gradient_norm_max",
        "dynamics/learning_rate", "dynamics/memory_usage_mb",
        "dynamics/epoch_time_seconds"}
    assert set(lines[3]) - {"event", "time"} == {
        "epoch", "val/mean_iou", "val/precision", "val/recall",
        "val/f1_score"}
    assert lines[4]["key"] == "training_plot"
    assert set(lines[5]) - {"event", "time"} == {
        "test/mean_iou", "test/precision", "test/recall", "test/f1_score"}
    assert set(lines[6]) - {"event", "time"} == {
        "test/mask_AP", "test/mask_AP50", "test/mask_AP75"}


def test_custom_cli_without_matplotlib(split, monkeypatch, tmp_path,
                                       capsys):
    """No matplotlib (as on the card's machine): one line, then on."""
    import builtins
    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    out = run_custom(["--num_epochs", "1", "--device_data", "off"],
                     tmp_path, monkeypatch, split)
    assert "Training plot skipped" in capsys.readouterr().out
    assert not (tmp_path / "outputs/custom_training_plot.png").exists()
    assert "test_metrics" in out


@pytest.fixture(scope="module")
def flagship_runs(split, tmp_path_factory):
    """The flagship command (--lr_step_size 1: the LR decays after epoch
    1) for 1 epoch with --device_data on and off, and for 2 epochs, each
    from its own directory: {mode: (directory, result)}."""
    base = FLAGSHIP + ["--lr_step_size", "1"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for mode, argv in (("on", ["--num_epochs", "1", "--device_data",
                                   "on"]),
                           ("off", ["--num_epochs", "1", "--device_data",
                                    "off"]),
                           ("straight", ["--num_epochs", "2"])):
            cwd = tmp_path_factory.mktemp(mode)
            runs[mode] = cwd, run_custom(base + argv, cwd, mp, split)
    return runs


def test_device_data_on_equals_off(flagship_runs):
    """The card-held split and the prefetched host batches train on the
    same batches with the same draws: bit-equal weights and optimizer
    state."""
    on, off = flagship_runs["on"][1], flagship_runs["off"][1]
    assert on["train_losses"] == off["train_losses"]
    assert_states_equal(on["model"].state_dict(), off["model"].state_dict())
    assert_states_equal(on["optimizer"].state_dict(),
                        off["optimizer"].state_dict())


def test_resume_equals_straight_run(flagship_runs, split, monkeypatch,
                                    tmp_path):
    """1 epoch, then --resume for epoch 2, is a straight 2-epoch run bit
    for bit: weights, optimizer state and schedule_step (the LR decays
    after epoch 1)."""
    straight = flagship_runs["straight"][1]
    first = flagship_runs["on"][0] / "models/custom_maskrcnn_1epochs.ckpt"
    resumed = run_custom(FLAGSHIP + ["--lr_step_size", "1", "--num_epochs",
                                     "2", "--resume", str(first)],
                         tmp_path, monkeypatch, split)
    assert resumed["train_losses"] == straight["train_losses"][1:]
    assert_states_equal(resumed["model"].state_dict(),
                        straight["model"].state_dict())
    so, ro = straight["optimizer"], resumed["optimizer"]
    assert ro.param_groups[0]["schedule_step"] == \
        so.param_groups[0]["schedule_step"] == 2 * straight["steps_per_epoch"]
    assert_states_equal(ro.state_dict(), so.state_dict())
    meta = json.loads((tmp_path / "models/custom_maskrcnn_2epochs.ckpt/"
                       "meta.json").read_text())
    assert meta["epoch"] == 2


def test_resume_keeps_the_flags_schedule(flagship_runs, split, monkeypatch,
                                         tmp_path):
    """--resume takes the checkpoint's moments and step count, and the
    schedule of its own flags: --lr_step_size 6 where the checkpoint had
    1 keeps epoch 2 at the base rate."""
    first = flagship_runs["on"][0] / "models/custom_maskrcnn_1epochs.ckpt"
    resumed = run_custom(FLAGSHIP + ["--lr_step_size", "6", "--lr", "2e-3",
                                     "--num_epochs", "2", "--resume",
                                     str(first)],
                         tmp_path, monkeypatch, split)
    group = resumed["optimizer"].param_groups[0]
    spe = resumed["steps_per_epoch"]
    assert (group["lr_step_size"], group["base_lr"]) == (6, 2e-3)
    assert group["schedule_step"] == 2 * spe
    assert scheduled_lr(dict(group, schedule_step=spe)) == 2e-3


# ---------------------------------------------------------------------------
# The transfer CLI end to end.
# ---------------------------------------------------------------------------

def test_transfer_cli_end_to_end(split, monkeypatch, tmp_path):
    """One epoch a stage: stage 1 leaves the backbone, FPN and RPN bit
    for bit as they were, stage 2 moves them; the index matrices are
    JAX's (seed + stage * 100 + epoch); the checkpoint names the
    transfer model."""
    calls = spy_indices(tt, monkeypatch)
    snaps = []
    real = tt.stage_optimizer

    def spy(model, *a, **kw):
        snaps.append({n: p.detach().clone()
                      for n, p in model.named_parameters()})
        return real(model, *a, **kw)

    monkeypatch.setattr(tt, "stage_optimizer", spy)
    out = run_transfer(["--stage1_epochs", "1", "--stage2_epochs", "1",
                        "--coco_ap", "--seed", "3"], tmp_path, monkeypatch,
                       split)
    assert [c[3] for c in calls] == [104, 204]
    for (n, bs, _, seed, got) in calls:
        np.testing.assert_array_equal(got, jax_epoch_indices(n, bs, True,
                                                             seed))
    final = dict(out["model"].named_parameters())
    frozen = [n for n in final if n.split(".")[0] in FROZEN_STAGE1]
    heads = [n for n in final if n.split(".")[0] not in FROZEN_STAGE1]
    assert frozen and heads
    s1, s2 = snaps
    assert all(torch.equal(s1[n], s2[n]) for n in frozen)
    assert any(not torch.equal(s1[n], s2[n]) for n in heads)
    for module in FROZEN_STAGE1:
        assert any(not torch.equal(s2[n], final[n]) for n in frozen
                   if n.split(".")[0] == module), module
    assert len(out["history"]) == 2
    ckpt = tmp_path / "models/maskrcnn_resnet50_two_stage.ckpt"
    kind, cfg, sd = load_model_state(str(ckpt), "cpu")
    assert kind == "transfer" and cfg == PORT_TTINY
    assert_states_equal(sd, out["model"].state_dict())
    for t in ("segm", "bbox"):
        assert 0.0 <= out["test_ap"][t]["AP"] <= 1.0


def test_transfer_device_data_on_equals_off(split, monkeypatch, tmp_path,
                                            capsys):
    """The transfer CLI's card-held split and its host batches (with
    --track_preds' eval forward after each step) train alike, bit for
    bit."""
    runs = {}
    for mode, extra in (("on", []), ("off", ["--track_preds"])):
        (tmp_path / mode).mkdir()
        runs[mode] = run_transfer(["--stage1_epochs", "1",
                                   "--stage2_epochs", "1", "--device_data",
                                   mode] + extra, tmp_path / mode,
                                  monkeypatch, split)
    assert capsys.readouterr().out.count("preds>0.5 per image") == 2
    assert runs["on"]["history"] == runs["off"]["history"]
    assert_states_equal(runs["on"]["model"].state_dict(),
                        runs["off"]["model"].state_dict())


def test_transfer_pretrained_weights(split, monkeypatch, tmp_path):
    """--pretrained takes a local .pth: with no epochs the trained model
    is load_torchvision_weights' import of it. A caller's TransferConfig
    is kept as given, frozen_bn included (JAX's rule; the flag's effect
    is test_transfer_config_matches_jax's)."""
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          fake_torchvision_maskrcnn_state_dict().items()}
    torch.save(sd, tmp_path / "tv.pth")
    out = run_transfer(["--stage1_epochs", "0", "--stage2_epochs", "0",
                        "--pretrained", str(tmp_path / "tv.pth")],
                       tmp_path, monkeypatch, split)
    want = load_torchvision_weights(create_transfer_model(
        PORT_TTINY, torch.Generator().manual_seed(0), device="cpu",
        train=True), sd)
    assert_states_equal(out["model"].state_dict(), want.state_dict())
    _, cfg, _ = load_model_state(
        str(tmp_path / "models/maskrcnn_resnet50_two_stage.ckpt"), "cpu")
    assert cfg == PORT_TTINY


def test_transfer_mfu_prints_the_step_flops(split, monkeypatch, tmp_path,
                                            capsys):
    """--mfu prints, for each stage, count_flops of one step of the
    stage's first batch (the count depends on the shapes alone, so any
    weights and either stage's optimizer count the same), and on the CPU
    an MFU of "unknown"."""
    run_transfer(["--stage1_epochs", "0", "--stage2_epochs", "0",
                  "--mfu"], tmp_path, monkeypatch, split)
    out = capsys.readouterr().out
    dcfg = ModelConfig(max_instances=PORT_TTINY.max_instances,
                       mask_size=PORT_TTINY.mask_size,
                       image_height=PORT_TTINY.tile_height,
                       image_width=PORT_TTINY.tile_width)
    ds = get_datasets(str(split), dcfg, device="cpu")["train"]
    images, targets, _ = next(ds.batches(4, shuffle=False, drop_last=True))
    model = create_transfer_model(PORT_TTINY, device="cpu", train=True)
    want = count_flops(
        make_step_fn(model, tt.stage_optimizer(model, 5e-3, 0.9, 1e-4, True)),
        torch.from_numpy(images),
        {k: torch.from_numpy(v) for k, v in targets.items()},
        generator=torch.Generator().manual_seed(0))
    lines = [ln for ln in out.splitlines() if "analytic step FLOPs" in ln]
    assert lines == [f"  analytic step FLOPs: {want / 1e12:.3f} TFLOP "
                     f"({want:.0f} FLOP)"] * 2
    assert out.count("MFU unknown") == 2


def test_custom_cli_on_a_two_rank_mesh(split, monkeypatch, tmp_path):
    """Under torchrun's environment with two ranks (gloo on the CPU) the
    custom CLI trains on a data-parallel mesh: host batches through
    ShardedLoader (--device_data off), the same global losses on both
    ranks, rank 0 alone printing the epochs and writing the checkpoint,
    which loads into the no-mesh model. With --lr 0 the weights stay,
    so the epoch's mean loss compares the mesh's forwards with the
    single process's over the same batches: 1e-5 relative."""
    import socket

    import torch.multiprocessing as mp

    from tests import torch_mesh_worker

    argv = ["--data_dir", str(split), "--batch_size", "4", "--num_epochs",
            "1", "--device_data", "off", "--lr", "0"] + FLAGSHIP
    (tmp_path / "mesh").mkdir()
    torch.save(jax_config_to_dict(TINY), tmp_path / "cfg.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(torch_mesh_worker.cli_rank, nprocs=2,
                       start_method="spawn",
                       args=(2, port, argv, str(tmp_path / "mesh"),
                             str(tmp_path)))
    ranks = [torch.load(tmp_path / f"cli{r}.pt", weights_only=False)
             for r in range(2)]
    assert ranks[0]["train_losses"] == ranks[1]["train_losses"]
    assert "Epoch 1 Training" in ranks[0]["printed"]
    assert "Epoch 1 Training" not in ranks[1]["printed"]
    assert "Mesh: data 2 x model 1" in ranks[0]["printed"]
    path = tmp_path / "mesh" / "models" / "custom_maskrcnn_1epochs.ckpt"
    _, cfg, sd = load_model_state(str(path), "cpu")
    create_train_model(cfg, device="cpu").load_state_dict(sd, strict=True)

    (tmp_path / "single").mkdir()
    single = run_custom(argv[4:], tmp_path / "single", monkeypatch, split)
    np.testing.assert_allclose(ranks[0]["train_losses"],
                               single["train_losses"], rtol=1e-5)
