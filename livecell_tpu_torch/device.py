"""Device selection for the port's entry points.

The port runs on the card. An entry point runs on the CPU only when its
caller asks for it (`device="cpu"`, as the tests do); without a card
and without that request it raises instead of carrying on quietly on
the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the card ("cuda"). Raises if a CUDA device is asked
    for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "livecell_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


@functools.lru_cache(maxsize=64)
def constant(values: Tuple[float, ...], device: torch.device
             ) -> torch.Tensor:
    """An f32 tensor of `values` on `device`, made once per device and
    shared: do not write to it. A forward that copied such a constant
    from host memory in every call would make the host wait there for
    the work already queued on the card (a pageable copy synchronizes),
    so a frame's dispatch could not run ahead of the card. It is made
    outside inference mode, so training may save it for backward after
    a serving call made it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)
