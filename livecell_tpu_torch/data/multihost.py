"""Per-rank host data loading for the mesh (counterpart of
livecell_tpu/data/multihost.py: process_batch_slice, ShardedLoader).

Every rank derives the same global shuffle from (seed + epoch), the one
PackedDataset.batches(shuffle=True, seed=seed + epoch) takes, and loads
only its rows of each global batch: those of its data coordinate, which
the ranks of one model group share. The mesh step (parallel/
train_step.py) takes the rows and knows the global batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def process_batch_slice(global_batch: int, mesh) -> Tuple[int, int]:
    """(start, count): the contiguous rows of each global batch this rank
    loads. By the rank's data coordinate, not rank / world: the two agree
    only without a model axis."""
    rows = mesh.rows(global_batch)
    return rows.start, rows.stop - rows.start


class ShardedLoader:
    """Deterministic per-epoch loader of `packed` (a data/dataset.py:
    PackedDataset, or anything with len() and gather(indices)) over the
    mesh: yields (images, targets) of this rank's rows of every global
    batch, as tensors on the mesh's device (uint8 images and mask
    targets, which the step normalizes there). The remainder that does
    not fill a global batch is dropped."""

    def __init__(self, packed, mesh, global_batch: int,
                 shuffle: bool = True, seed: int = 0):
        self.packed = packed
        self.mesh = mesh
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        self._lo, self._n = process_batch_slice(global_batch, mesh)

    def steps_per_epoch(self) -> int:
        return len(self.packed) // self.global_batch

    def indices(self, epoch: int) -> Iterator[np.ndarray]:
        """This rank's tile indices of each global batch of `epoch`."""
        order = np.arange(len(self.packed))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        gb = self.global_batch
        for i in range(self.steps_per_epoch()):
            yield order[i * gb:(i + 1) * gb][self._lo:self._lo + self._n]

    def epoch(self, epoch: int
              ) -> Iterator[Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        dev = self.mesh.device
        for local in self.indices(epoch):
            images, targets = self.packed.gather(local)
            yield (torch.from_numpy(images).to(dev),
                   {k: torch.from_numpy(v).to(dev)
                    for k, v in targets.items()})
