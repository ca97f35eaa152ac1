"""Device selection for the port's entry points.

The port runs on the card. An entry point runs on the CPU only when its
caller asks for it (`device="cpu"`, as the tests do); without a card
and without that request it raises instead of carrying on quietly on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

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
