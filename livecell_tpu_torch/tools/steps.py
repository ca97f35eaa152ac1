"""The training steps the measurement tools drive (profile_step,
profile_transfer, roofline): JAX's workload constants, the inputs moved
to the device, and one step a call over the real state or over a copy
of it for the counters, which execute the step."""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from livecell_tpu_torch.parallel.train_step import make_step_fn

# Boxes drawn a tile by JAX's scripts.
N_INST = 40
# optax.adamw(1e-3, weight_decay=1e-4) at a constant rate: an epoch
# longer than any run.
CONSTANT_LR_EPOCH = 10 ** 12


def to_device(images: np.ndarray, targets: Dict[str, np.ndarray], dev
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return (torch.from_numpy(images).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in targets.items()})


def stepper(model, opt, images, targets) -> Callable[[], Dict]:
    """One training step a call (make_step_fn), its sampling uniforms
    drawn from a generator of seed 1 on the images' device."""
    step = make_step_fn(model, opt)
    gen = torch.Generator(device=images.device).manual_seed(1)
    return lambda: step(images, targets, generator=gen)


def copied_stepper(model, opt, images, targets) -> Callable[[], Dict]:
    """`stepper` over a copy of the model and optimizer, for the FLOP
    and byte counters, which execute the step."""
    return stepper(*copy.deepcopy((model, opt)), images, targets)
