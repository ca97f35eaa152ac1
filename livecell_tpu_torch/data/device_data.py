"""A split resident on the card, with the batch gathered there
(counterpart of livecell_tpu/data/device_data.py: DeviceDataset,
epoch_indices, make_epoch_train_fn, make_indexed_eval_step). The
trainers' epoch plan lives here too: `epoch_indices` for the batches,
`epoch_generator` for the sampling uniforms.

The split's arrays go to device memory once; every step then gathers
its batch by index on the card, and an epoch fetches its metrics from
the card once, at its end, as the JAX package's scan does.

With a mesh each rank holds the whole split on its own card (replicated,
as in JAX) and takes, from each row of the index matrix, the slice of
its data coordinate (`local_indices`); ranks of one model group take
the same rows.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.models.detector import Detections
from livecell_tpu_torch.parallel.train_step import (
    make_eval_step, make_step_fn, normalize_batch)
from livecell_tpu_torch.utils.profiling import span


class DeviceDataset:
    """A packed split on the card: images [N, H, W, 3] uint8 (padded to
    the model's input size), targets {boxes [N,I,4] f32, labels [N,I],
    mask28 [N,I,28,28] uint8, valid [N,I] bool} with I instance slots
    per tile. Takes numpy arrays or tensors; `from_packed` takes a
    PackedDataset's whole split. `nbytes` is what it holds on the
    device."""

    def __init__(self, images, targets: Dict, device=None):
        dev = resolve_device(device)
        self.images = torch.as_tensor(images).to(dev)
        self.targets = {k: torch.as_tensor(v).to(dev)
                        for k, v in targets.items()}
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in [self.images, *self.targets.values()])

    @classmethod
    def from_packed(cls, packed, device=None) -> "DeviceDataset":
        """Every tile of `packed` (a data/dataset.py:PackedDataset),
        gathered once on the host into the model's input size and
        max_instances slots, then put on `device`."""
        images, targets = packed.gather(np.arange(len(packed),
                                                  dtype=np.int64))
        return cls(images, targets, device=device)

    def __len__(self) -> int:
        return self.images.shape[0]

    def batch(self, idx: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The rows `idx` (an int64 tensor on the card), gathered there."""
        return self.images[idx], {k: v[idx] for k, v in self.targets.items()}


def epoch_indices(n: int, batch_size: int, shuffle: bool = True,
                  seed: int = 0) -> np.ndarray:
    """[steps, batch_size] int32 index matrix for one epoch; the
    remainder that does not fill a batch is dropped."""
    order = np.arange(n, dtype=np.int32)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    steps = n // batch_size
    return order[:steps * batch_size].reshape(steps, batch_size)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch's sampling uniforms, on `device`,
    seeded from (seed, epoch) alone: a run resumed at `epoch` draws what
    a straight run draws there."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def local_indices(idx_mat, mesh=None) -> np.ndarray:
    """This rank's columns of an [S, B] index matrix: all of them
    without a mesh, else the slice of its data coordinate."""
    idx_mat = np.asarray(idx_mat)
    if mesh is None:
        return idx_mat
    return idx_mat[:, mesh.rows(idx_mat.shape[1])]


def train_epoch(model, opt, pool: DeviceDataset, idx_mat,
                generator=None, mesh=None,
                stats: Optional[Dict[str, float]] = None
                ) -> Dict[str, np.ndarray]:
    """One epoch of `make_step_fn(model, opt, mesh)` steps over the
    batches idx_mat [S, B] of `pool` (with a mesh, global batches of
    which this rank takes its rows), the sampling uniforms drawn from
    `generator`. Each step's metrics stay on the card; the epoch fetches
    them once: {name: [S] float array}.

    `stats`, when given, accumulates "steps", "enqueue_s" (host seconds
    from the epoch's start until its last step is enqueued) and
    "wait_s" (host seconds blocked in the metric fetch, which waits for
    the card): whether the host or the card sets the pace."""
    t0 = time.perf_counter()
    step = make_step_fn(model, opt, mesh)
    idx = torch.as_tensor(local_indices(idx_mat, mesh),
                          dtype=torch.long).to(pool.images.device)
    rows = []
    for i in range(idx.shape[0]):
        images, targets = pool.batch(idx[i])
        rows.append(step(images, targets, generator=generator))
    t1 = time.perf_counter()
    out = fetch_metrics(rows)
    if stats is not None:
        for k, v in (("steps", len(rows)), ("enqueue_s", t1 - t0),
                     ("wait_s", time.perf_counter() - t1)):
            stats[k] = stats.get(k, 0) + v
    return out


def fetch_metrics(rows) -> Dict[str, np.ndarray]:
    """Steps' metric dicts of device scalars -> {name: [S] float array},
    in one copy from the device (the span livecell.fetch_metrics)."""
    with span("livecell.fetch_metrics"):
        names = list(rows[0])
        table = torch.stack([torch.stack([r[k].float() for k in names])
                             for r in rows]).cpu().numpy()
    return {k: table[:, j] for j, k in enumerate(names)}


def make_indexed_eval_step(model, dd: DeviceDataset, mesh=None) -> Callable:
    """ev(idx) -> (Detections, targets): the batch `idx` (indices into
    dd) gathered on dd's device, normalized (images / 255, mask targets
    / 255) and run through the model's inference forward, with the
    normalized targets for the metrics, so an evaluation never fetches
    ground truth from the host. With a mesh each rank runs its data
    coordinate's rows and the detections of the whole batch are
    gathered (make_eval_step)."""
    run = make_eval_step(model, device=dd.images.device, mesh=mesh)

    def ev(idx) -> Tuple[Detections, Dict[str, torch.Tensor]]:
        idx = torch.as_tensor(idx, dtype=torch.long,
                              device=dd.images.device)
        images, targets = dd.batch(idx)
        _, targets = normalize_batch(images, targets)
        return run(images), targets

    return ev
