"""The ('data', 'model') mesh of the multi-GPU path (counterpart of
livecell_tpu/parallel/mesh.py: make_mesh, _param_spec).

One process a device: `cuda:LOCAL_RANK` over NCCL, or any device over
gloo (the CPU tests; two ranks on one card). The process group exists
before the mesh: `torch.distributed.init_process_group`, as `torchrun`
arranges it. Rank r sits at data coordinate r // model_parallel and
model coordinate r % model_parallel, as JAX's mesh lays out
devices.reshape(n // model_parallel, model_parallel).

  * 'data': the batch is split over it. DistributedDataParallel reduces
    the gradients over its group; the step's own collectives (batch-norm
    statistics, loss normalizers, the metrics) go over a second group of
    the same ranks, so they never interleave with DDP's.
  * 'model': the box head's fc1 is column-sharded and fc2 row-sharded
    over it (`param_spec`, JAX's rule by parameter name), Megatron-style:
    `copy_to_model` before fc1 (identity forward, all-reduce backward),
    `reduce_from_model` after fc2 (all-reduce forward, identity
    backward). Everything else is replicated; the transfer model's box
    head (fc6/fc7) does not match the rule and stays replicated, as in
    JAX.

Every collective here is an all-reduce (a gather is an all-reduce of
zero-filled slots), which gloo also runs on CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from livecell_tpu_torch.device import resolve_device

# Exact gathers: a float's bits summed with zeros as an integer.
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def param_spec(name: str) -> Tuple[Optional[str], ...]:
    """The partition spec of a parameter of the port's layout (torch's
    [out, in] weights) by name: one entry a dimension, "model" where it
    is sharded. JAX's rule (mesh.py:45-59) on the JAX layout ([in, out]
    kernels): fc1's kernel column-sharded, fc2's row-sharded, fc1's bias
    sharded."""
    if "box_head" in name and "fc1" in name:
        if "weight" in name:
            return ("model", None)
        if "bias" in name:
            return ("model",)
    if "box_head" in name and "fc2" in name and "weight" in name:
        return (None, "model")
    return ()


def _merge(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group` where at most one rank holds a non-zero
    value in each place (a gather's slots): bit for bit, as the f32 and
    f64 bits are summed as integers (-0.0 stays -0.0) and bool as
    uint8."""
    if t.dtype == torch.bool:
        return _merge(t.to(torch.uint8), group).bool()
    view = _INT_VIEW.get(t.dtype)
    buf = t.contiguous().clone()
    dist.all_reduce(buf.view(view) if view else buf, group=group)
    return buf


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank's fc1 shard saw the same input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward (fc2's partial products over its row shards);
    the backward passes the replicated gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataSum(torch.autograd.Function):
    """The sum over the data group of a per-rank partial (batch-norm
    sums): every rank's loss depends on the total, so the backward sums
    the gradients over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def data_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _DataSum.apply(x, group)


class DataAxis:
    """What the loss code of a model needs of the data axis: its size,
    this rank's coordinate, the sum of a count over the ranks (no
    gradient) and the gather of rows."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def count(self, t: torch.Tensor) -> torch.Tensor:
        """The global value of a per-rank count (a loss normalizer)."""
        total = t.detach().clone()
        dist.all_reduce(total, group=self.group)
        return total

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """[b, ...] per rank -> [size * b, ...], in data order, on every
        rank, bit for bit."""
        buf = torch.zeros((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        buf[self.rank] = t.detach()
        return _merge(buf, self.group).reshape(
            (self.size * t.shape[0],) + tuple(t.shape[1:]))


class _TrainForward(nn.Module):
    """A model's train_forward as a module's forward, for DDP to wrap."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.train_forward(*args, **kwargs)


class Mesh:
    """The mesh of this process. `data_size` x `model_size` ranks; this
    one at (`data_rank`, `model_rank`) on `device`. `ddp_group` is the
    data group DistributedDataParallel reduces over, `data` the step's
    own data axis (a second group of the same ranks), `model_group` the
    box head's."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.data_size, self.model_size = (device_mesh.size(0),
                                           device_mesh.size(1))
        self.data_rank, self.model_rank = device_mesh.get_coordinate()
        self.ddp_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        # Every rank creates every data column's group, in one order.
        mp = self.model_size
        columns = [dist.new_group([d * mp + m
                                   for d in range(self.data_size)])
                   for m in range(mp)]
        self.data = DataAxis(columns[self.model_rank], self.data_size,
                             self.data_rank)
        self._ddp: Dict[int, nn.Module] = {}

    @property
    def is_main(self) -> bool:
        """Rank 0 of the job: the one that prints, saves and evaluates."""
        return dist.get_rank() == 0

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (its data coordinate's
        slice; ranks of one model group take the same rows)."""
        if global_batch % self.data_size:
            raise ValueError(f"batch {global_batch} is not divisible by the "
                             f"data axis ({self.data_size})")
        per = global_batch // self.data_size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def train_forward(self, model: nn.Module) -> nn.Module:
        """`model.train_forward` under DistributedDataParallel over the
        data group, made once per model: a second wrapper would reduce
        every gradient twice. Parameters a step leaves without a gradient
        (the FPN levels the custom model does not compute) stay without
        one."""
        from torch.nn.parallel import DistributedDataParallel

        key = id(model)
        if key not in self._ddp:
            self._ddp[key] = DistributedDataParallel(
                _TrainForward(model), process_group=self.ddp_group,
                broadcast_buffers=False, find_unused_parameters=True)
        return self._ddp[key]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data_size}, model={self.model_size}, "
                f"device={self.device})")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The ('data', 'model') mesh over the job's ranks, one device a rank:
    `device`, by default cuda:LOCAL_RANK (the card unless the caller
    passes "cpu"). The default process group must exist; `n_devices`,
    when given, must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's process "
                           "group (torchrun, or init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"{n} devices asked for, the job has {world} ranks "
                         f"(one device a rank)")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # The mesh only names the groups; NCCL groups live on the card, gloo
    # groups take tensors anywhere.
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, (n // model_parallel, model_parallel),
                          mesh_dim_names=("data", "model"))
    return Mesh(dm, dev)


def _silent(*args, **kwargs):
    """print() of a rank other than 0."""


def main_print(mesh: Optional[Mesh]):
    """print on rank 0 of the job (and without a mesh), a no-op on the
    other ranks."""
    return print if mesh is None or mesh.is_main else _silent


def trainer_mesh(batch_size: int, device=None) -> Optional[Mesh]:
    """The trainers' mesh (JAX's condition, train_custom.py:269-272):
    under torchrun with more than one rank (WORLD_SIZE), a data-parallel
    mesh over all of them, the process group NCCL on the card and gloo
    on the CPU; with one rank, None. The batch must divide over the
    ranks."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    if batch_size % world:
        raise ValueError(f"--batch_size {batch_size} is not divisible by "
                         f"the {world} ranks")
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_mesh(device=dev)


def _shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    if t.shape[dim] % mesh.model_size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} is not "
                         f"divisible by the model axis ({mesh.model_size})")
    return t.chunk(mesh.model_size, dim)[mesh.model_rank].clone()


def shard_model(model: nn.Module, mesh: Mesh,
                optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Lay `model` (and its optimizer's state) out on the mesh, in place:
    with a data axis of more than one rank, batch norm reduces its batch
    statistics over it and the losses their normalizers (`data_axis`);
    with a model axis of more than one rank, the parameters `param_spec`
    shards keep this rank's slice (the same Parameter objects, so an
    optimizer made before keeps them) and the box head runs sharded.
    A collective over one rank is the identity, so an axis of one
    leaves the model as it is. Done once; a second call does nothing."""
    from livecell_tpu_torch.models.heads import BoxHead
    from livecell_tpu_torch.models.resnet import BatchNorm

    if getattr(model, "mesh", None) is mesh:
        return
    if mesh.data_size > 1:
        model.data_axis = mesh.data
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.data_axis = mesh.data
    if mesh.model_size > 1:
        state = optimizer.state if optimizer is not None else {}
        for name, p in model.named_parameters():
            spec = param_spec(name)
            if "model" not in spec:
                continue
            dim = spec.index("model")
            full = tuple(p.shape)
            p.data = _shard(p.data, dim, mesh)
            for k, v in state.get(p, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) == full:
                    state[p][k] = _shard(v, dim, mesh)
        for m in model.modules():
            if isinstance(m, BoxHead):
                m.model_group = mesh.model_group
    model.mesh = mesh


def full_state(model: nn.Module, mesh: Mesh,
               optimizer: Optional[torch.optim.Optimizer] = None):
    """(state dict, optimizer state dict or None) with every sharded
    tensor gathered to its full shape over the model group, bit for bit:
    what a no-mesh model and optimizer load. Like state_dict(), they hold
    the live tensors where nothing is gathered. A collective: every rank
    calls it."""
    sd = model.state_dict()
    osd = optimizer.state_dict() if optimizer is not None else None
    if mesh.model_size == 1:
        return sd, osd

    def gather(t: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(t.shape)
        n = shape[dim]
        shape[dim] = n * mesh.model_size
        buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
        buf.narrow(dim, mesh.model_rank * n, n).copy_(t)
        return _merge(buf, mesh.model_group)

    index = {id(p): i for i, p in enumerate(
        p for g in (optimizer.param_groups if optimizer else [])
        for p in g["params"])}
    for name, p in model.named_parameters():
        spec = param_spec(name)
        if "model" not in spec:
            continue
        dim = spec.index("model")
        sd[name] = gather(sd[name], dim)
        i = index.get(id(p))
        if osd is not None and i in osd["state"]:
            # A new dict: state_dict() hands out the live per-parameter
            # state.
            osd["state"][i] = {
                k: gather(v, dim) if torch.is_tensor(v)
                and tuple(v.shape) == tuple(p.shape) else v
                for k, v in osd["state"][i].items()}
    return sd, osd
