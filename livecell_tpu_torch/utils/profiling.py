"""Tracing and timing helpers (counterpart of
livecell_tpu/utils/profiling.py: trace, time_fn, device_memory_stats,
enable_nan_debug).

  * `trace(log_dir)`: a torch.profiler session over the CPU and, with a
    card, CUDA activities, exported as a Chrome trace into `log_dir`;
  * `time_fn`: steady-state timing, each call ended by a synchronize on
    the card (PyTorch returns before the card finishes);
  * `device_memory_stats`: the caching allocator's counters in MiB;
  * `enable_nan_debug`: autograd anomaly detection, which fails at the
    backward op that produced a NaN.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "outputs/profile"):
    """Profile the body; on exit the Chrome trace is written to
    `log_dir`/trace_<pid>_<ns>.json. Yields the profiler (its
    `key_averages()` and `trace_path`, set on exit)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _sync() -> None:
    """Wait for the card, where this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kw) -> Dict[str, float]:
    """Mean, median and minimum seconds of `fn(*args, **kw)` after
    `warmup` calls. Each timed call ends with torch.cuda.synchronize()
    once the process has used the card."""
    for _ in range(warmup):
        fn(*args, **kw)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)),
            "median_s": float(np.median(times)),
            "min_s": float(np.min(times))}


def device_memory_stats() -> Dict[str, float]:
    """torch.cuda.memory_stats() of the current card with every number
    in MiB (counts too, as the JAX package divides every value), or {}
    without a card."""
    if not torch.cuda.is_available():
        return {}
    return {k: v / (1024 ** 2) for k, v in torch.cuda.memory_stats().items()
            if isinstance(v, (int, float))}


def enable_nan_debug(enable: bool = True):
    """Autograd anomaly detection (torch.autograd.set_detect_anomaly)."""
    torch.autograd.set_detect_anomaly(enable)
