"""One rank of a gloo job on the CPU, driven by tests/test_torch_parallel.py
through torch.multiprocessing (spawn): `run(rank, world, port,
model_parallel, job_path, out_dir)`.

The job file (torch.save) is {task name: task}, each task a dict whose
"kind" names the function that runs it; each rank writes {task name:
result} to out_dir/rank<r>.pt. Not a test module (no
test_ prefix); it imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _train(mesh, task):
    """Steps of the mesh step (SGD, lr 1e-3, momentum 0.9) from the
    task's weights on this rank's rows of its global batches, each with
    its global noise or the seed of the generator that draws it; the
    metrics of each step, the parameters' shapes here, and on rank 0 the
    full (gathered) state after them. With "checkpoint", a mesh
    checkpoint is written there."""
    from livecell_tpu_torch.config import ModelConfig
    from livecell_tpu_torch.models.mask_rcnn import create_train_model
    from livecell_tpu_torch.parallel.mesh import full_state
    from livecell_tpu_torch.parallel.train_step import make_step_fn
    from livecell_tpu_torch.train import checkpoint

    model = create_train_model(ModelConfig(**task["cfg"]), device="cpu")
    model.load_state_dict(task["state"])
    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    step = make_step_fn(model, opt, mesh)
    metrics = []
    for images, targets, draw in task["batches"]:
        rows = mesh.rows(images.shape[0])
        noise = draw if isinstance(draw, dict) else None
        gen = None if noise else torch.Generator().manual_seed(draw)
        m = step(torch.from_numpy(images[rows]),
                 {k: torch.from_numpy(v[rows]) for k, v in targets.items()},
                 noise=noise, generator=gen)
        metrics.append({k: float(v) for k, v in m.items()})
    sd, _ = full_state(model, mesh, opt)
    out = {"metrics": metrics,
           "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}
    if task.get("checkpoint"):
        checkpoint.save(task["checkpoint"], model, opt, epoch=1, mesh=mesh)
    if mesh.is_main:
        out["state"] = {k: v.clone() for k, v in sd.items()}
    return out


class _Packed:
    """len() and gather() of a PackedDataset over index-coded tiles."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def gather(self, idx):
        idx = np.asarray(idx)
        return (np.broadcast_to(idx[:, None, None, None],
                                (len(idx), 2, 2, 3)).astype(np.uint8),
                {"boxes": idx[:, None, None].repeat(4, -1).astype(
                    np.float32)})


def _rows(mesh, task):
    """The tiles ShardedLoader and the device pool give this rank."""
    from livecell_tpu_torch.data.device_data import (
        epoch_indices, local_indices)
    from livecell_tpu_torch.data.multihost import ShardedLoader

    loader = ShardedLoader(_Packed(task["n"]), mesh, task["batch"],
                           shuffle=True, seed=task["seed"])
    batches = [images[:, 0, 0, 0].numpy().astype(int)
               for images, _ in loader.epoch(task["epoch"])]
    idx_mat = epoch_indices(task["n"], task["batch"], True,
                            task["seed"] + task["epoch"])
    return {"loader": batches, "pool": local_indices(idx_mat, mesh)}


def _predict(mesh, task):
    """The frame predictor over the mesh on the job's tiles."""
    from livecell_tpu_torch.config import ModelConfig, TileConfig
    from livecell_tpu_torch.models.mask_rcnn import create_model
    from livecell_tpu_torch.serve.stitch import make_frame_predictor

    model = create_model(ModelConfig(**task["cfg"]), device="cpu")
    model.load_state_dict(task["state"])
    run = make_frame_predictor(model, TileConfig(**task["tile_cfg"]),
                               score_threshold=0.0, device="cpu",
                               mesh=mesh)
    return run(task["tiles"])._asdict()


TASKS = {"train": _train, "rows": _rows, "predict": _predict}


def cli_rank(rank: int, world: int, port: int, argv, cwd: str,
             out_dir: str) -> None:
    """One rank of the custom trainer CLI under torchrun's environment
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT), on the CPU, with
    tests/test_torch_train_cli.py's TINY config; writes the losses it
    returned and what it printed to out_dir."""
    import contextlib
    import io

    from livecell_tpu_torch.config import Config, model_config_from_dict
    from livecell_tpu_torch.train import train_custom

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    os.chdir(cwd)
    cfg = model_config_from_dict(torch.load(
        os.path.join(out_dir, "cfg.pt"), weights_only=False))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = train_custom.main(argv, config=Config(model=cfg),
                                device="cpu")
    torch.save({"train_losses": out["train_losses"],
                "printed": printed.getvalue()},
               os.path.join(out_dir, f"cli{rank}.pt"))


def run(rank: int, world: int, port: int, model_parallel: int,
        job_path: str, out_dir: str) -> None:
    from livecell_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(model_parallel=model_parallel, device="cpu")
        job = torch.load(job_path, weights_only=False)
        out = {name: TASKS[task["kind"]](mesh, task)
               for name, task in job.items()}
        out["coords"] = (mesh.data_rank, mesh.model_rank)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
