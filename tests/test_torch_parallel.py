"""The port's mesh (parallel/mesh.py, the mesh step, data/multihost.py,
the device pool's slices, mesh checkpoints, the mesh frame predictor) on
the CPU: gloo jobs of 2 ranks (data = 2) and 4 ranks (data = 2 x
model = 2) in spawned processes (tests/torch_mesh_worker.py), against
the port's single-process step and JAX's mesh step.

The steps are two SGD steps (lr 1e-3, momentum 0.9, an update linear in
the gradient) of the flagship mode (and quirk mode at data = 2) with
batch norm in train mode, f32, TINY geometry, on one global batch of 4.
At this size train-mode batch norm couples the images so strongly that
two f32 evaluations whose statistics differ in the last bit give
gradients apart by percents; on CPU tensors the port's batch norm takes
its statistics from f64 sums with and without a mesh, so the mesh and
the single process normalize with the same f32 values and the
tolerance can be 1e-5 relative: on every loss
and the gradient norm of each step, on the parameter vector after them
(its L2 distance over its L2 norm) and on each batch-norm running
statistic. Under strict_equivalence_config (batch norm frozen) both
meshes also equal JAX's mesh step (make_mesh(2), make_mesh(4,
model_parallel=2) on the 8 virtual CPU devices) fed JAX's draws, to
1e-5.
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from livecell_tpu.config import TileConfig as JaxTileConfig
from livecell_tpu.config import strict_equivalence_config as jax_strict
from livecell_tpu.models import transfer as jtr
from livecell_tpu.models.mask_rcnn import CustomMaskRCNN as JaxMaskRCNN
from livecell_tpu.models.mask_rcnn import create_model as jax_create_model
from livecell_tpu.parallel.mesh import _param_spec as jax_param_spec
from livecell_tpu.parallel.mesh import batch_sharding
from livecell_tpu.parallel.mesh import make_mesh as jax_make_mesh
from livecell_tpu.parallel.train_step import (
    create_train_state, make_train_step)
from livecell_tpu.serve.stitch import make_frame_predictor as jax_predictor
from livecell_tpu_torch.config import (
    ModelConfig, TileConfig, strict_equivalence_config)
from livecell_tpu_torch.models.convert import from_jax_variables
from livecell_tpu_torch.models.mask_rcnn import (
    create_model, create_train_model)
from livecell_tpu_torch.models.transfer import create_transfer_model
from livecell_tpu_torch.parallel.mesh import param_spec
from livecell_tpu_torch.parallel.train_step import make_step_fn
from livecell_tpu_torch.serve.app import InferenceEngine
from livecell_tpu_torch.serve.stitch import make_frame_predictor
from tests import test_torch_train as ttrain
from tests import test_torch_transfer as ttransfer
from tests import torch_mesh_worker
from tests.test_model import TINY

REL = 1e-5
B = 4
FLAGSHIP = dict(heads_all_images=True, decode_proposals=True,
                mask_train_samples=16)
MESHES = {"data2": (2, 1), "data2_model2": (4, 2)}
ROWS = dict(kind="rows", n=22, batch=4, seed=3, epoch=1)
# The frame predictor: tests/test_serve_parallel.py's tiny geometry, f32.
PRED_CFG = dict(image_height=64, image_width=96, max_instances=8,
                train_pre_topk=64, train_num_samples=16, infer_pre_topk=32,
                infer_post_nms=8, max_detections=8, rpn_pos_per_image=16,
                rpn_batch_per_image=32, compute_dtype="float32")
PRED_TILE = dict(frame_width=64, frame_height=48, tiles_per_image=4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sgd(model):
    return torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)


def natural_state(cfg_kw):
    """The port's own initialization (seed 0) of a TINY model."""
    return create_train_model(ModelConfig(**cfg_kw),
                              torch.Generator().manual_seed(0),
                              device="cpu").state_dict()


def one_batch():
    images, targets = ttrain.make_batch(40, b=B)
    return images, targets


@pytest.fixture(scope="module")
def strict_inputs():
    """JAX's strict flagship config, its weights (util_torch_port's), one
    global batch and the draws of two steps (keys 1, 2)."""
    jcfg = jax_strict(ttrain.jax_cfg(**FLAGSHIP))
    images, targets = one_batch()
    keys = [jax.random.key(1), jax.random.key(2)]
    noise = [ttrain.jax_noise(jcfg, k, B) for k in keys]
    return jcfg, images, targets, keys, noise


def pred_inputs():
    """(JAX f32 TINY model and variables, port weights, tiles)."""
    jcfg = dataclasses.replace(TINY, compute_dtype="float32")
    model, v = jax_create_model(jcfg, jax.random.key(0))
    v = jax.tree.map(lambda x: np.array(x, np.float32), v)
    tcfg = JaxTileConfig(**PRED_TILE)
    tiles = np.random.default_rng(1).integers(
        0, 255, (tcfg.num_tiles, tcfg.tile_height, tcfg.tile_width, 3),
        dtype=np.uint8)
    return model, v, from_jax_variables(v), tiles


@pytest.fixture(scope="module")
def runs(tmp_path_factory, strict_inputs):
    """{mesh name: [per-rank results]} of one job on each mesh."""
    _, images, targets, _, noise = strict_inputs
    port_strict = strict_equivalence_config(ttrain.port_cfg(**FLAGSHIP))
    flagship = dict(ttrain.TRAIN_KW, **FLAGSHIP)
    quirk = dict(ttrain.TRAIN_KW)
    base = {
        "flagship": dict(kind="train", cfg=flagship,
                         state=natural_state(flagship),
                         batches=[(images, targets, 100),
                                  (images, targets, 101)]),
        "strict": dict(kind="train", cfg=dataclasses.asdict(port_strict),
                       state=from_jax_variables(ttrain.variables()),
                       batches=[(images, targets, n) for n in noise]),
        "rows": ROWS,
    }
    out = {}
    for name, (world, model_parallel) in MESHES.items():
        d = tmp_path_factory.mktemp(name)
        job = dict(base)
        job["flagship"] = dict(base["flagship"], checkpoint=str(d / "ckpt"))
        if model_parallel == 1:
            job["quirk"] = dict(kind="train", cfg=quirk,
                                state=natural_state(quirk),
                                batches=[(images, targets, 100),
                                         (images, targets, 101)])
            _, _, state, tiles = pred_inputs()
            job["predict"] = dict(kind="predict", cfg=PRED_CFG, state=state,
                                  tile_cfg=PRED_TILE, tiles=tiles)
        torch.save(job, d / "job.pt")
        mp.start_processes(
            torch_mesh_worker.run, nprocs=world, start_method="spawn",
            args=(world, _free_port(), model_parallel, str(d / "job.pt"),
                  str(d)))
        out[name] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                     for r in range(world)]
        out[name][0]["dir"] = d
    return out


def single_steps(cfg_kw, state, batches):
    """The port's single-process step on the same inputs: (metrics,
    state after)."""
    model = create_train_model(ModelConfig(**cfg_kw), device="cpu")
    model.load_state_dict(state)
    step = make_step_fn(model, _sgd(model))
    metrics = []
    for images, targets, draw in batches:
        noise = draw if isinstance(draw, dict) else None
        gen = None if noise else torch.Generator().manual_seed(draw)
        m = step(torch.from_numpy(images),
                 {k: torch.from_numpy(v) for k, v in targets.items()},
                 noise=noise, generator=gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model.state_dict()


def assert_metrics_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=REL, abs=1e-8), k


def assert_state_close(got, want):
    """The parameter vector to REL (L2 distance / L2 norm); each
    batch-norm running statistic to REL of its largest entry."""
    params = [k for k in want if want[k].is_floating_point()
              and "running" not in k]
    diff = sum(float(((got[k].double() - want[k].double()) ** 2).sum())
               for k in params) ** 0.5
    norm = sum(float((want[k].double() ** 2).sum()) for k in params) ** 0.5
    assert diff / norm < REL, diff / norm
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(
                got[k].numpy(), want[k].numpy(), rtol=0,
                atol=REL * float(want[k].abs().max()), err_msg=k)


# ---------------------------------------------------------------------------
# The sharding rule.
# ---------------------------------------------------------------------------

def _port_name(jax_path: str) -> str:
    name = jax_path.replace("/", ".")
    for a, b in ((".kernel", ".weight"), (".scale", ".weight")):
        if name.endswith(a):
            name = name[:-len(a)] + b
    if name.startswith(("rpn.cls_logits", "rpn.bbox_pred")):
        name = "rpn.fused." + name.rsplit(".", 1)[1]
    return name


@pytest.mark.parametrize("kind", ["custom", "transfer"])
def test_param_spec_matches_jax(kind):
    """JAX's rule on JAX's layout ([in, out] kernels) is the port's rule
    on torch's ([out, in]) for every parameter of both models."""
    if kind == "custom":
        _, v = jax_create_model(TINY, jax.random.key(0))
        port = create_model(ModelConfig(**PRED_CFG), device="cpu")
    else:
        v = jax.eval_shape(lambda: jtr.create_transfer_model(
            rng=jax.random.key(0), cfg=ttransfer.JCFG)[1])
        port = create_transfer_model(ttransfer.PCFG, device="cpu")
    names = {n for n, _ in port.named_parameters()}
    seen = set()
    sharded = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(v["params"])[0]:
        spec = tuple(jax_param_spec(jax.tree_util.keystr(path), leaf))
        key = "/".join(p.key for p in path)
        name = _port_name(key)
        assert name in names, name
        seen.add(name)
        want = spec[::-1] if key.endswith("kernel") and len(spec) == 2 \
            else spec
        assert param_spec(name) == want, (name, spec)
        if "model" in want:
            sharded.append(name)
    assert seen == names
    assert sorted(sharded) == ([] if kind == "transfer" else [
        "box_head.fc1.bias", "box_head.fc1.weight", "box_head.fc2.weight"])


# ---------------------------------------------------------------------------
# The mesh step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_step_equals_single_process(runs, mesh):
    """Non-frozen batch norm, f32: the synced statistics, the global
    normalizers, the noise drawn for the global batch and the global
    gradient norm."""
    images, targets = one_batch()
    cfg = dict(ttrain.TRAIN_KW, **FLAGSHIP)
    task = runs[mesh][0]["flagship"]
    want, state = single_steps(cfg, natural_state(cfg),
                               [(images, targets, 100),
                                (images, targets, 101)])
    # Every loss is active in the first step.
    assert all(v > 0 for k, v in want[0].items() if k.startswith("loss"))
    for r in runs[mesh]:
        assert_metrics_close(r["flagship"]["metrics"], want)
    assert_state_close(task["state"], state)


def test_quirk_mode_mesh_step_equals_single_process(runs):
    """Quirk mode: data rank 0 holds image 0 and trains the heads on it
    against the whole batch's GT, gathered."""
    images, targets = one_batch()
    cfg = dict(ttrain.TRAIN_KW)
    want, state = single_steps(cfg, natural_state(cfg),
                               [(images, targets, 100),
                                (images, targets, 101)])
    for r in runs["data2"]:
        assert_metrics_close(r["quirk"]["metrics"], want)
    assert_state_close(runs["data2"][0]["quirk"]["state"], state)


def test_model_axis_shards_the_box_head(runs):
    ranks = runs["data2_model2"]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    shapes = ranks[0]["flagship"]["shapes"]
    full = natural_state(dict(ttrain.TRAIN_KW, **FLAGSHIP))
    assert shapes["box_head.fc1.weight"] == (512, full[
        "box_head.fc1.weight"].shape[1])
    assert shapes["box_head.fc1.bias"] == (512,)
    assert shapes["box_head.fc2.weight"] == (1024, 512)
    assert shapes["box_head.fc2.bias"] == (1024,)
    assert shapes["box_head.cls_score.weight"] == (2, 1024)
    # The gathered state is full.
    assert ranks[0]["flagship"]["state"]["box_head.fc1.weight"].shape == \
        full["box_head.fc1.weight"].shape


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_strict_mesh_step_equals_jax_mesh_step(runs, strict_inputs, mesh):
    jcfg, images, targets, keys, _ = strict_inputs
    world, model_parallel = MESHES[mesh]
    v = ttrain.variables()
    jmesh = jax_make_mesh(world, model_parallel=model_parallel)
    tx = optax.sgd(1e-3, momentum=0.9)
    model = JaxMaskRCNN(jcfg)
    state = create_train_state(model, {"params": v["params"],
                                       "batch_stats": v["batch_stats"]},
                               tx, mesh=jmesh)
    step = make_train_step(model, tx, mesh=jmesh, donate=False)
    bsh = batch_sharding(jmesh)
    want = []
    with jax.default_matmul_precision("highest"):
        for key in keys:
            state, m = step(
                state, jax.device_put(jnp.asarray(images), bsh),
                {k: jax.device_put(jnp.asarray(x), bsh)
                 for k, x in targets.items()}, key)
            want.append({k: float(x) for k, x in m.items()})
    for r in runs[mesh]:
        assert_metrics_close(r["strict"]["metrics"], want)
    jstate = from_jax_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    assert_state_close(runs[mesh][0]["strict"]["state"], jstate)


# ---------------------------------------------------------------------------
# The rows each rank takes, and mesh checkpoints.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_loader_and_pool_rows_make_the_global_batch(runs, mesh):
    from livecell_tpu_torch.data.device_data import epoch_indices

    ranks = runs[mesh]
    model_parallel = MESHES[mesh][1]
    want = epoch_indices(ROWS["n"], ROWS["batch"], True,
                         ROWS["seed"] + ROWS["epoch"])
    for key in ("loader", "pool"):
        # Data ranks in order (model coordinate 0) make each batch.
        leads = [r["rows"][key] for r in ranks[::model_parallel]]
        got = np.concatenate([np.stack(x) for x in leads], axis=1)
        np.testing.assert_array_equal(got, want)
        # The ranks of one model group take the same rows.
        for r in ranks:
            lead = ranks[r["coords"][0] * model_parallel]
            np.testing.assert_array_equal(np.stack(r["rows"][key]),
                                          np.stack(lead["rows"][key]))


def test_mesh_checkpoint_loads_into_the_no_mesh_model_and_serves(runs):
    rank0 = runs["data2_model2"][0]
    path = str(rank0["dir"] / "ckpt")
    cfg = ModelConfig(**dict(ttrain.TRAIN_KW, **FLAGSHIP))
    model = create_train_model(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(path, "model.pt")),
                          strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, rank0["flagship"]["state"][k]), k
    opt = torch.load(os.path.join(path, "optimizer.pt"))
    idx = [n for n, _ in model.named_parameters()].index(
        "box_head.fc1.weight")
    assert opt["state"][idx]["momentum_buffer"].shape == \
        model.box_head.fc1.weight.shape
    eng = InferenceEngine(path, tile_cfg=TileConfig(**PRED_TILE),
                          device="cpu")
    image = np.random.default_rng(0).integers(0, 255, (48, 64, 3),
                                              dtype=np.uint8)
    boxes, scores, masks = eng.predict(image, score_threshold=0.0)
    assert boxes.shape[1:] == (4,) and len(scores) == len(masks)


# ---------------------------------------------------------------------------
# The frame predictor over the data axis.
# ---------------------------------------------------------------------------

def test_two_rank_frame_predictor(runs):
    """Bit for bit the single-process predictor on every rank, and JAX's
    tile-parallel predictor (4-way tiles on make_mesh(8, 2)) to
    tests/test_serve_parallel.py:82-98's tolerance."""
    jmodel, v, state, tiles = pred_inputs()
    model = create_model(ModelConfig(**PRED_CFG), device="cpu")
    model.load_state_dict(state)
    single = make_frame_predictor(model, TileConfig(**PRED_TILE),
                                  score_threshold=0.0, device="cpu")(tiles)
    assert len(single.scores) > 0
    for r in runs["data2"]:
        got = r["predict"]
        for k, want in single._asdict().items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    sharded = jax_predictor(jmodel, v, JaxTileConfig(**PRED_TILE),
                            score_threshold=0.0,
                            mesh=jax_make_mesh(8, model_parallel=2))(tiles)
    got = runs["data2"][0]["predict"]
    assert len(sharded.scores) == len(got["scores"])
    np.testing.assert_allclose(got["boxes"][np.lexsort((got["scores"],))],
                               sharded.boxes[np.lexsort((sharded.scores,))],
                               rtol=1e-3, atol=0.1)


def test_world_size_one_equals_no_mesh_bit_for_bit(monkeypatch):
    """A mesh of one rank (gloo, in this process) runs the DDP-wrapped
    mesh step and the mesh predictor: their collectives over one rank
    are the identity, so both equal the no-mesh path bit for bit (the
    chip run checks the same over NCCL)."""
    import torch.distributed as dist

    from livecell_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    dist.init_process_group("gloo", rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        images, targets = one_batch()
        cfg = dict(ttrain.TRAIN_KW, **FLAGSHIP)
        state = natural_state(cfg)
        runs = []
        for m in (None, mesh):
            model = create_train_model(ModelConfig(**cfg), device="cpu")
            model.load_state_dict(state)
            step = make_step_fn(model, _sgd(model), m)
            runs.append(([{k: float(v) for k, v in step(
                torch.from_numpy(images),
                {k: torch.from_numpy(v) for k, v in targets.items()},
                generator=torch.Generator().manual_seed(100 + i)).items()}
                for i in range(2)], model.state_dict()))
        assert runs[0][0] == runs[1][0]
        for k, v in runs[0][1].items():
            assert torch.equal(v, runs[1][1][k]), k

        _, _, pstate, tiles = pred_inputs()
        model = create_model(ModelConfig(**PRED_CFG), device="cpu")
        model.load_state_dict(pstate)
        dets = [make_frame_predictor(model, TileConfig(**PRED_TILE),
                                     score_threshold=0.0, device="cpu",
                                     mesh=m)(tiles) for m in (None, mesh)]
        for a, b in zip(*dets):
            np.testing.assert_array_equal(a, b)
    finally:
        dist.destroy_process_group()
