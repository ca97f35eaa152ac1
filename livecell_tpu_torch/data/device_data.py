"""A training split resident on the card, with the batch gathered there
(counterpart of livecell_tpu/data/device_data.py: DeviceDataset,
epoch_indices, make_epoch_train_fn).

The split's arrays go to device memory once; every step then gathers
its batch by index on the card, and an epoch fetches its metrics from
the card once, at its end, as the JAX package's scan does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from livecell_tpu_torch.device import resolve_device
from livecell_tpu_torch.parallel.train_step import make_step_fn


class DeviceDataset:
    """A packed split on the card: images [N, H, W, 3] uint8 (padded to
    the model's input size), targets {boxes [N,I,4] f32, labels [N,I],
    mask28 [N,I,28,28] uint8, valid [N,I] bool} with I instance slots
    per tile. Takes numpy arrays or tensors."""

    def __init__(self, images, targets: Dict, device=None):
        dev = resolve_device(device)
        self.images = torch.as_tensor(images).to(dev)
        self.targets = {k: torch.as_tensor(v).to(dev)
                        for k, v in targets.items()}

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


def train_epoch(model, opt, pool: DeviceDataset, idx_mat,
                generator=None) -> Dict[str, np.ndarray]:
    """One epoch of `make_step_fn(model, opt)` steps over the batches
    idx_mat [S, B] of `pool`, the sampling uniforms drawn from
    `generator`. Each step's metrics stay on the card; the epoch fetches
    them once: {name: [S] float array}."""
    step = make_step_fn(model, opt)
    idx = torch.as_tensor(np.asarray(idx_mat), dtype=torch.long).to(
        pool.images.device)
    rows = []
    for i in range(idx.shape[0]):
        images, targets = pool.batch(idx[i])
        rows.append(step(images, targets, generator=generator))
    names = list(rows[0])
    table = torch.stack([torch.stack([r[k].float() for k in names])
                         for r in rows]).cpu().numpy()
    return {k: table[:, j] for j, k in enumerate(names)}
