"""The kernels' launch counts of a whole process, written when it exits.

When the environment variable LIVECELL_LAUNCH_LOG names a file, a
process that imports the port appends one JSON line to it at its exit:

    {"argv": sys.argv, "pid": ..., "launches": {kernel: count}}

So a caller that runs the port in child processes (a runbook stage, a
trainer CLI) can read what each child launched: every counter starts at
zero in a new process, and a kernel whose module was never imported
counts zero.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from typing import Dict

ENV = "LIVECELL_LAUNCH_LOG"
# Each kernel's wrapper (`<wrapper>.launches`) and the module that holds
# it, under livecell_tpu_torch.ops.
KERNELS = {"roi_weights": "cuda_roi_align",
           "roi_align_fwd": "cuda_roi_align",
           "roi_align_bwd": "cuda_roi_align",
           "match_anchors": "cuda_match",
           "ms_roi_align_fwd": "cuda_ms_roi_align",
           "ms_roi_align_bwd": "cuda_ms_roi_align"}


def counts() -> Dict[str, int]:
    """{kernel: launches so far in this process}."""
    out = {}
    for name, module in KERNELS.items():
        mod = sys.modules.get(f"livecell_tpu_torch.ops.{module}")
        out[name] = getattr(mod, name).launches if mod is not None else 0
    return out


def _write(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"argv": sys.argv, "pid": os.getpid(),
                            "launches": counts()}) + "\n")


def install() -> None:
    """Write this process's counts to $LIVECELL_LAUNCH_LOG at its exit,
    when the variable is set."""
    path = os.environ.get(ENV)
    if path:
        atexit.register(_write, path)
