"""The port's reader of the JAX package's checkpoints
(train/jax_checkpoint.py over utils/ocdbt.py, utils/zarr_v2.py and the
zstd decoder) against the JAX package's own checkpoint.save and load,
on the CPU.

Every directory here is written by the JAX package (Orbax): the custom
trainer's full save (train_custom.py:437-442: params, batch_stats and
optax's AdamW state after two JAX steps, the meta, the sidecar), the
transfer trainer's bare save (train_transfer.py:316-319), a bare
variables tree, and a full-width ModelConfig() save. The port reads
them leaf for leaf equal to JAX's `checkpoint.load`, serves them
(InferenceEngine, visualize.load_model, the frame predictor) as JAX
serves the same variables, and resumes a custom one as JAX's --resume
does. The models are tests/util_torch_port.py's (64x96, f32) and
tests/test_torch_transfer.py's TINY transfer geometry; both have the
published widths (31.0 M and 44.0 M parameters).
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import livecell_tpu.config as jconfig
import livecell_tpu.serve.visualize  # noqa: F401  (binds the real Config)
from livecell_tpu.config import model_config_to_dict as jax_config_to_dict
from livecell_tpu.models.mask_rcnn import count_parameters
from livecell_tpu.models.mask_rcnn import create_model as jax_create_model
from livecell_tpu.serve.app import InferenceEngine as JaxEngine
from livecell_tpu.train import checkpoint as jck
from livecell_tpu.train.train_custom import build_optimizer as jax_optimizer
from livecell_tpu_torch import native
from livecell_tpu_torch.config import (
    Config, ModelConfig, TransferConfig, model_config_from_dict)
from livecell_tpu_torch.models.convert import from_jax_variables
from livecell_tpu_torch.models.mask_rcnn import create_train_model
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.parallel.train_step import (
    apply_update, build_optimizer, make_step_fn, scheduled_lr)
from livecell_tpu_torch.serve import visualize
from livecell_tpu_torch.serve.app import InferenceEngine
from livecell_tpu_torch.serve.stitch import make_frame_predictor
from livecell_tpu_torch.train import checkpoint
from livecell_tpu_torch.train import jax_checkpoint as pjc
from livecell_tpu_torch.train import train_custom as tc
from livecell_tpu_torch.utils import ocdbt
from livecell_tpu_torch.utils.zarr_v2 import UnsupportedArray
from tests import test_torch_transfer as ttr
from tests import util_torch_port as up
from tests.test_torch_checkpoint_serve import assert_masks_close
from tests.test_torch_serve import SCORE, TCFG, TOL, make_frame
from tests.test_torch_train import (
    FIXED, LOSS_TOL, assert_grads_match, assert_losses_match, jax_cfg,
    jax_noise, make_batch, port_cfg, run_jax, to_torch)
from tests.test_torch_train import variables as train_variables

JAX_TCFG = jconfig.TileConfig(frame_width=TCFG.frame_width,
                              frame_height=TCFG.frame_height)
# The JAX schedule of the saved run: 1 step an epoch, StepLR(1, 0.1), so
# the resumed step (optax count 2) runs at 1e-5, not the base rate.
LR, WD, SPE, STEP, GAMMA = 1e-3, 1e-4, 1, 1, 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_trees_equal(got, want, path="payload"):
    """Same keys, same container and leaf types, arrays equal bit for
    bit with the same dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def orbax_save(path, tree):
    """Orbax's StandardCheckpointer save of a bare tree, finished."""
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()


def assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# The directories JAX writes.
# ---------------------------------------------------------------------------

def jax_two_steps():
    """(params, batch_stats, opt_state, schedule) after two JAX steps of
    the fixed mode from the train tests' weights."""
    v = train_variables()
    tx, schedule = jax_optimizer(LR, WD, SPE, STEP, GAMMA)
    params, stats, opt_state = v["params"], v["batch_stats"], tx.init(
        v["params"])
    for t in range(2):
        images, targets = make_batch(60 + t)
        _, grads, stats = run_jax(FIXED, params, stats, images, targets,
                                  jax.random.key(70 + t))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(np.asarray,
                              optax.apply_updates(params, updates))
    return params, stats, jax.tree.map(np.asarray, opt_state), tx, schedule


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """{name: directory} of the JAX package's saves, and the two-step
    run's optimizer."""
    root = tmp_path_factory.mktemp("jax_saves")
    params, stats, opt_state, tx, schedule = jax_two_steps()
    custom = str(root / "custom_maskrcnn_2epochs.ckpt")
    jck.save(custom, params, stats, opt_state=opt_state, epoch=2,
             train_losses=[2.5, 1.75],
             val_metrics=[{"mean_iou": 0.25, "f1_score": 0.125},
                          {"mean_iou": 0.5, "f1_score": 0.375}],
             param_info=count_parameters(params),
             model_config=jax_config_to_dict(jax_cfg(**FIXED)))
    tv = ttr.jax_variables()
    transfer = str(root / "maskrcnn_resnet50_two_stage.ckpt")
    jck.save(transfer, tv["params"], tv["batch_stats"])
    bare = str(root / "bare")
    orbax_save(bare, up.jax_variables()["params"])
    served = str(root / "served")
    uv = up.jax_variables()
    jck.save(served, uv["params"], uv["batch_stats"],
             model_config=jax_config_to_dict(up.JAX_CFG))
    yield {"custom": custom, "transfer": transfer, "bare": bare,
           "served": served, "tx": tx, "schedule": schedule}
    # ~750 MB: freed when the module ends, not when pytest's session does.
    shutil.rmtree(root)


# ---------------------------------------------------------------------------
# The payload, leaf for leaf.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["custom", "transfer", "bare", "served"])
def test_payload_equals_jax_load(saves, name):
    stats = {}
    got = pjc.load(saves[name], stats)
    want = jck.load(saves[name])
    assert_trees_equal(got, want)
    assert stats["bytes"] > 1e8 and stats["zstd_s"] > 0
    if name == "custom":
        assert got["meta"]["epoch"] == 2 and got["opt_state"][1] is None
        assert int(got["opt_state"][0]["count"]) == 2
        assert got["meta"]["param_info"]["total"] == 30_958_337
    if name in ("transfer", "bare"):
        assert "model_config" not in got and got["meta"] == {}


def test_full_width_model_config_save(tmp_path):
    """ModelConfig() at full width (30,958,337 parameters, 9,600 batch
    statistics, 113 MB on disk) through the C++ decoder: the payload
    equals JAX's load and the state dict equals from_jax_variables of
    JAX's arrays, bit for bit."""
    assert native.backend() == "cpp"
    cfg = jconfig.ModelConfig()
    _, v = jax_create_model(cfg, jax.random.key(1))
    v = jax.tree.map(np.asarray, v)
    path = str(tmp_path / "full")
    jck.save(path, v["params"], v["batch_stats"],
             model_config=jax_config_to_dict(cfg))
    want = jck.load(path)
    got = pjc.load(path)
    assert_trees_equal(got["params"], want["params"])
    assert_trees_equal(got["batch_stats"], want["batch_stats"])
    kind, pcfg, sd = checkpoint.load_model_state(path, "cpu")
    assert kind == "custom" and pcfg == model_config_from_dict(
        jax_config_to_dict(cfg))
    assert_state_dicts_equal(sd, from_jax_variables(
        {"params": want["params"], "batch_stats": want["batch_stats"]}))
    assert sum(v.numel() for k, v in sd.items()
               if not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked"))) == 30_958_337
    shutil.rmtree(path)


def test_python_decoder_reads_a_checkpoint(tmp_path, monkeypatch):
    """Without the C++ library (the Python zstd and CRC-32C), a small
    tree with every leaf kind Orbax writes reads as JAX's load reads it:
    f32/f64/i32/i64/bool/u8 arrays, a 0-d array, Python scalars, None,
    empty dict and list, nested lists."""
    tree = {"params": {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": {"c": np.array(3, np.int64),
                             "d": np.array([True, False]),
                             "e": np.arange(5, dtype=np.uint8),
                             "f": np.linspace(0, 1, 7),
                             "g": np.array([1, -2], np.int32)}},
            "meta": {"epoch": 4, "train_losses": [0.5, 0.25],
                     "val_metrics": [{"f1_score": 0.75}], "none": None,
                     "empty": {}, "nothing": []}}
    path = str(tmp_path / "small")
    orbax_save(path, tree)
    want = jck.load(path)
    monkeypatch.setattr(native, "library", lambda: None)
    got = pjc.load(path)
    assert_trees_equal(got, want)


# ---------------------------------------------------------------------------
# OCDBT trees and layouts.
# ---------------------------------------------------------------------------

def test_interior_btree_nodes(tmp_path):
    """A tree with interior nodes (tensorstore's OCDBT driver with small
    nodes, 20 commits of 25 keys, some values out of line), and every
    sub-database: the keys and values equal tensorstore's."""
    path = tmp_path / "kv"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(0)
    for c in range(20):
        with ts.Transaction() as txn:
            for i in range(25):
                kv.with_transaction(txn)[f"leaf{c:03d}.{i}/0".encode()] = \
                    rng.bytes(int(rng.integers(0, 64)))
    db = ocdbt.open_store(path)
    assert db.manifest.root_height >= 2
    assert db.keys() == sorted(kv.list().result()) and len(db.keys()) == 500
    for k in db.keys():
        assert db.get(k) == kv.read(k).result().value


def test_few_hundred_leaves_and_sub_databases(tmp_path):
    """300 leaves saved by Orbax: the root database, and the per-process
    sub-database read alone, equal JAX's load."""
    rng = np.random.default_rng(1)
    tree = {f"l{i:03d}": {"kernel": rng.standard_normal(
        (int(rng.integers(1, 40)), 64)).astype(np.float32),
        "bias": np.full(3, i, np.float32)} for i in range(150)}
    path = tmp_path / "many"
    jck.save(str(path), tree, {})
    want = jck.load(str(path))
    assert_trees_equal(pjc.load(path), want)
    root = ocdbt.open_store(path)
    sub = ocdbt.open_store(path / "ocdbt.process_0")
    assert root.keys() == sub.keys() and len(root.keys()) == 2 * 300
    for k in root.keys():
        assert root.get(k) == sub.get(k)
    # Without the root manifest the sub-databases are read.
    (path / "manifest.ocdbt").unlink()
    assert_trees_equal(pjc.load(path), want)


def test_ocdbt_off_layout(tmp_path):
    """Orbax with OCDBT off: one directory of zarr files a leaf."""
    tree = {"params": up.jax_variables()["params"]["box_head"],
            "meta": {"epoch": 1}}
    path = str(tmp_path / "plain")
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        path, tree)
    assert not (tmp_path / "plain/manifest.ocdbt").exists()
    assert_trees_equal(pjc.load(path), jck.load(path))


def test_zarr3_and_foreign_compressor_raise(tmp_path):
    path = tmp_path / "z3"
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        path, {"a": np.arange(6, dtype=np.float32)})
    with pytest.raises(pjc.UnsupportedCheckpoint, match="zarr v3"):
        pjc.load(path)
    path = tmp_path / "gzip"
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        path, {"params": {"a": np.arange(6, dtype=np.float32)}})
    zarray = path / "params.a/.zarray"
    meta = json.loads(zarray.read_text())
    zarray.write_text(json.dumps(dict(meta, compressor={"id": "gzip",
                                                        "level": 1})))
    with pytest.raises(UnsupportedArray, match="gzip"):
        pjc.load(path)
    zarray.write_text(json.dumps(dict(meta, filters=[{"id": "delta"}])))
    with pytest.raises(UnsupportedArray, match="delta"):
        pjc.load(path)


def test_corrupt_node_raises(tmp_path, saves):
    path = tmp_path / "corrupt"
    shutil.copytree(saves["bare"], path)
    node = next((path / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[len(data) // 2] ^= 4
    node.write_bytes(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        pjc.load(path)


# ---------------------------------------------------------------------------
# Serving a JAX checkpoint.
# ---------------------------------------------------------------------------

def test_model_state_and_types(saves):
    kind, cfg, sd = checkpoint.load_model_state(saves["served"], "cpu")
    assert kind == "custom" and cfg == up.PORT_CFG
    assert_state_dicts_equal(sd, from_jax_variables(up.jax_variables()))
    # The transfer trainer's bare save: no sidecar; typed by its keys or
    # by the caller, with the config JAX's trainer builds.
    for mtype in (None, "transfer"):
        kind, cfg, sd = checkpoint.load_model_state(saves["transfer"], "cpu",
                                                    mtype)
        assert kind == "transfer" and cfg == TransferConfig()
    assert_state_dicts_equal(sd, from_jax_variables(ttr.jax_variables()))
    kind, cfg, _ = checkpoint.load_model_state(saves["bare"], "cpu")
    assert kind == "custom" and cfg == ModelConfig()
    with pytest.raises(ValueError, match="model_type 'custom'"):
        checkpoint.load_model_state(saves["transfer"], "cpu", "custom")
    with pytest.raises(ValueError, match="model_type 'transfer'"):
        visualize.load_model(saves["served"], "transfer", device="cpu")
    with pytest.raises(ValueError, match="model_type 'transfer'"):
        InferenceEngine(saves["served"], model_type="transfer",
                        device="cpu")


def test_visualize_load_model_on_a_jax_checkpoint(saves):
    model = visualize.load_model(saves["served"], "custom", device="cpu")
    assert model.cfg == up.PORT_CFG and not model.training
    assert_state_dicts_equal(model.state_dict(), up.port_model().state_dict())


def test_quality_tools_load_a_jax_checkpoint(saves):
    """tools/eval_ckpt.py (and oracle_probe through it): the sidecar's
    config and the state dict; a transfer checkpoint is refused."""
    from livecell_tpu_torch.tools.eval_ckpt import load_custom_model

    mcfg, sd = load_custom_model(saves["served"], ModelConfig(), "cpu")
    assert mcfg == up.PORT_CFG
    assert_state_dicts_equal(sd, from_jax_variables(up.jax_variables()))
    mcfg, _ = load_custom_model(saves["bare"], up.PORT_CFG, "cpu")
    assert mcfg == up.PORT_CFG
    with pytest.raises(SystemExit, match="transfer model"):
        load_custom_model(saves["transfer"], ModelConfig(), "cpu")



def test_load_model_state_takes_a_fallback_without_a_sidecar(saves,
                                                            tmp_path):
    """`fallback` is the config of a directory without a sidecar: a port
    checkpoint, or a JAX one of the fallback's type; a JAX one of the
    other type keeps its own. A port checkpoint without a sidecar and
    without a fallback raises."""
    path = checkpoint.save(str(tmp_path / "port"), up.port_model())
    (tmp_path / "port" / "model_config.json").unlink()
    kind, cfg, sd = checkpoint.load_model_state(path, "cpu",
                                                fallback=up.PORT_CFG)
    assert kind == "custom" and cfg == up.PORT_CFG
    assert_state_dicts_equal(sd, up.port_model().state_dict())
    with pytest.raises(FileNotFoundError):
        checkpoint.load_model_state(path, "cpu")
    kind, cfg, _ = checkpoint.load_model_state(saves["bare"], "cpu",
                                               fallback=up.PORT_CFG)
    assert kind == "custom" and cfg == up.PORT_CFG
    kind, cfg, _ = checkpoint.load_model_state(saves["transfer"], "cpu",
                                               fallback=up.PORT_CFG)
    assert kind == "transfer" and cfg == TransferConfig()

@pytest.fixture(scope="module")
def engines(saves):
    """JAX's engine and the port's, both over the JAX checkpoint."""
    real = jconfig.Config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "Config",
                   lambda: real(tile=JAX_TCFG, model=up.JAX_CFG))
        jeng = JaxEngine(saves["served"], "custom")
    return jeng, InferenceEngine(saves["served"], tile_cfg=TCFG,
                                 device="cpu")


@pytest.mark.parametrize("request_kind", ["tile", "frame"])
def test_engine_on_a_jax_checkpoint_matches_jax(engines, request_kind):
    jeng, peng = engines
    assert peng.model_type == "custom" and peng.cfg.model == up.PORT_CFG
    frame = make_frame()
    image = frame if request_kind == "frame" else \
        frame[:TCFG.tile_height, :TCFG.tile_width]
    with jax.default_matmul_precision("highest"):
        jb, js, jm = jeng.predict(image, SCORE)
    pb, ps, pm = peng.predict(image, SCORE)
    assert len(ps) >= 2 and len(ps) == len(js)
    # f32 results of the same selections (tests/test_torch_serve.py):
    # rtol/atol 1e-4, at most 0.1% of mask pixels flipped.
    np.testing.assert_allclose(pb, jb, **TOL)
    np.testing.assert_allclose(ps, js, **TOL)
    assert_masks_close(pm, jm)


def test_frame_predictor_on_a_jax_transfer_checkpoint(saves):
    """The transfer trainer's bare save at TINY geometry: the forward
    of the model it loads into matches JAX's forward of the same
    variables (tests/test_torch_transfer.py's tolerances), and its frame
    predictor equals the one over the variables carried in memory."""
    kind, _, sd = checkpoint.load_model_state(saves["transfer"], "cpu",
                                              "transfer")
    model = create_transfer_model(ttr.PCFG, device="cpu")
    model.load_state_dict(sd, strict=True)
    images, _ = ttr.batch(0)
    want = ttr.jcall(lambda v, x: ttr.jtr.TransferMaskRCNN(ttr.JCFG).apply(
        v, x, train=False), ttr.jax_variables(), images)
    got = model.inference_forward(torch.from_numpy(images))
    v = want.valid
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() >= 4
    # f32 through R50-FPN, the heads and the decoders: 1e-4.
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes[v],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[v], want.scores[v],
                               rtol=0, atol=1e-4)
    tiles = np.stack([make_frame()[:ttr.TCFG.tile_height,
                                   :ttr.TCFG.tile_width]] * ttr.TCFG.num_tiles)
    run = make_frame_predictor(model, ttr.TCFG, score_threshold=0.0,
                               device="cpu")
    ref = make_frame_predictor(ttr.port_model(), ttr.TCFG,
                               score_threshold=0.0, device="cpu")
    a, b = run(tiles), ref(tiles)
    assert len(a.scores) > 0
    for f in ("boxes", "scores", "masks", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# Resuming a JAX checkpoint.
# ---------------------------------------------------------------------------

def jax_resume_step(saves, images, targets, key):
    """JAX's --resume (train_custom.py:276-297) and its first step:
    (losses, grads, params, mu, nu, start epoch, learning rate)."""
    ckpt = jck.load(saves["custom"])
    tx, schedule = saves["tx"], saves["schedule"]
    ref = tx.init(ckpt["params"])
    opt_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref),
        jax.tree_util.tree_leaves(ckpt["opt_state"]))
    start_epoch = int(ckpt["meta"].get("epoch", 0)) + 1
    lr = float(schedule(opt_state[2].count))
    losses, grads, _ = run_jax(FIXED, ckpt["params"], ckpt["batch_stats"],
                               images, targets, key)
    updates, opt_state = tx.update(grads, opt_state, ckpt["params"])
    params = jax.tree.map(np.asarray,
                          optax.apply_updates(ckpt["params"], updates))
    adam = jax.tree.map(np.asarray, opt_state[0])
    return losses, grads, params, adam.mu, adam.nu, start_epoch, lr


def resumed_port(saves):
    model = create_train_model(port_cfg(**FIXED), device="cpu")
    opt = build_optimizer(model, LR, WD, SPE, STEP, GAMMA)
    _, _, meta = checkpoint.restore(saves["custom"], "cpu", model, opt)
    return model, opt, meta


def test_resumed_step_equals_jax_resume(saves):
    """The first step after the port resumes the JAX checkpoint equals
    the first step after JAX's own --resume: the loss dict (rtol 1e-4,
    atol 1e-5, tests/test_torch_train.py's LOSS_TOL), the gradients (1e-3
    of each tensor's largest entry) and their norm (rtol 1e-4); the
    update from JAX's gradients gives JAX's parameters and both moments
    (rtol 1e-6, atol 1e-7: the f32 rounding of one update); the start
    epoch and the learning rate are JAX's."""
    images, targets = make_batch(80)
    key = jax.random.key(81)
    jl, jg, jp, jmu, jnu, jepoch, jlr = jax_resume_step(saves, images,
                                                        targets, key)
    model, opt, meta = resumed_port(saves)
    group = opt.param_groups[0]
    assert int(meta["epoch"]) + 1 == jepoch == 3
    assert group["schedule_step"] == 2
    np.testing.assert_allclose(scheduled_lr(group), jlr, rtol=1e-7)
    assert jlr == pytest.approx(1e-5)
    first = next(iter(opt.state.values()))
    assert float(first["step"]) == 2.0
    metrics = make_step_fn(model, opt)(
        *to_torch(images, targets), noise=jax_noise(jax_cfg(**FIXED), key, 2))
    got = {k: v for k, v in metrics.items() if k.startswith("loss_")}
    assert_losses_match(got, jl, LOSS_TOL)
    assert_grads_match(model, jg)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(jg)), rtol=1e-4)

    # The update alone: JAX's gradients into a second resumed copy.
    model, opt, _ = resumed_port(saves)
    g = from_jax_variables({"params": jg})
    unreached = {f"fpn.output{i}.{w}" for i in (1, 2, 3)
                 for w in ("weight", "bias")}
    for name, p in model.named_parameters():
        p.grad = None if name in unreached else g[name].clone()
    apply_update(opt)
    want_p = from_jax_variables({"params": jp})
    want_mu = from_jax_variables({"params": jmu})
    want_nu = from_jax_variables({"params": jnu})
    for name, p in model.named_parameters():
        st = opt.state[p]
        for got_t, want_t in ((p.detach(), want_p[name]),
                              (st["exp_avg"], want_mu[name]),
                              (st["exp_avg_sq"], want_nu[name])):
            np.testing.assert_allclose(got_t.numpy(), want_t.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    assert opt.param_groups[0]["schedule_step"] == 3


def test_restore_without_an_optimizer_raises(saves):
    with pytest.raises(ValueError, match="no schedule"):
        checkpoint.restore(saves["custom"], "cpu")
    model, opt, meta = checkpoint.restore(saves["transfer"], "cpu")
    assert type(model).__name__ == "TransferMaskRCNN" and opt is None
    assert model.training and meta == {}


def test_custom_cli_resumes_a_jax_checkpoint(saves, tmp_path, monkeypatch,
                                             capsys):
    """train_custom --resume <JAX directory> for one epoch, as JAX's
    --resume: it starts at the checkpoint's epoch + 1, its updates run at
    the schedule of optax's count (2 + t for the t-th), and the epoch's
    logged rate is the schedule at (epoch - 1) * steps_per_epoch; both
    equal JAX's schedule within 1e-7 (f32 vs Python floats)."""
    from tests.test_torch_train_cli import write_split

    split = write_split(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(port_cfg(**FIXED), image_height=64,
                              image_width=96)
    out = tc.main(["--data_dir", str(split), "--batch_size", "4",
                   "--num_epochs", "3", "--lr", str(LR), "--lr_step_size",
                   str(STEP), "--fixed_heads", "--decode_proposals",
                   "--mask_samples", "16", "--use_wandb", "--resume",
                   saves["custom"]], config=Config(model=cfg), device="cpu")
    assert f"Resumed from {saves['custom']} at epoch 3" in \
        capsys.readouterr().out
    assert len(out["train_losses"]) == 1
    spe = out["steps_per_epoch"]
    _, schedule = jax_optimizer(LR, WD, spe, STEP, GAMMA)
    group = out["optimizer"].param_groups[0]
    assert group["schedule_step"] == 2 + spe
    np.testing.assert_allclose(group["lr"], float(schedule(2 + spe - 1)),
                               rtol=1e-7)
    logs = [json.loads(ln) for ln in next(
        (tmp_path / "outputs/runs").glob("*.jsonl")).read_text().splitlines()]
    lrs = [ln["dynamics/learning_rate"] for ln in logs
           if "dynamics/learning_rate" in ln]
    np.testing.assert_allclose(lrs, [float(schedule(2 * spe))], rtol=1e-7)
    shutil.rmtree(tmp_path / "models")
