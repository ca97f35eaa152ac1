"""Tracing and timing helpers (counterpart of
livecell_tpu/utils/profiling.py: trace, time_fn, device_memory_stats,
enable_nan_debug).

  * `trace(log_dir, with_stack=False)`: a torch.profiler session over
    the CPU and, with a card, CUDA activities, exported as a Chrome trace
    into `log_dir` (with the Python frames of each op when asked);
  * `time_fn`: steady-state timing, each call ended by a synchronize on
    the card (PyTorch returns before the card finishes);
  * `per_call_ms`: runs of calls back to back, timed by CUDA events
    on a card;
  * `sync`: wait for the card;
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


# On the H100 a profiler session now and then recorded no device event
# for its first launches, or for any: a count of them, not a span of
# time (chip_smoke.py logs each shortfall it meets). `trace` therefore
# drains the card, then opens each session with a warm-up step the
# profiler discards: WARMUP_LAUNCHES small kernels and SETTLE_S.
WARMUP_LAUNCHES = 64
SETTLE_S = 0.02


@contextlib.contextmanager
def trace(log_dir: str = "outputs/profile", with_stack: bool = False):
    """Profile the body; on exit the Chrome trace is written to
    `log_dir`/trace_<pid>_<ns>.json. Yields the profiler (its
    `key_averages()` and `trace_path`, set on exit). With `with_stack`
    the trace also holds the Python frames of every op
    (`python_function` events), so that a kernel can be traced to its
    source line (tools/trace_summary.py); xprof records them by default,
    torch.profiler only when asked. The body runs as the session's one
    active step, after a warm-up step whose events are dropped."""
    from torch.profiler import ProfilerActivity, profile, schedule

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if card else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    sync()
    with profile(activities=activities, with_stack=with_stack,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        if card:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                x.add_(1.0)
            sync()
            time.sleep(SETTLE_S)
        prof.step()
        yield prof
        sync()
    prof.trace_path = path


def sync(device=None) -> None:
    """Wait for `device` where it is a card; without a device, for the
    card where this process has used one."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kw) -> Dict[str, float]:
    """Mean, median and minimum seconds of `fn(*args, **kw)` after
    `warmup` calls. Each timed call ends with torch.cuda.synchronize()
    once the process has used the card."""
    for _ in range(warmup):
        fn(*args, **kw)
        sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        sync()
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)),
            "median_s": float(np.median(times)),
            "min_s": float(np.min(times))}


def per_call_ms(fn: Callable[[], object], device, calls: int = 30,
                warmup: int = 3, runs: int = 1) -> float:
    """Milliseconds per call of `fn()` on `device`: `warmup` calls, then
    `runs` runs of `calls` calls made back to back, the median run
    divided by `calls`. On a card each run is timed by CUDA events
    around it (device time, the host's enqueue overlapped), elsewhere
    by the host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    on_card = torch.device(device).type == "cuda"
    times = []
    for _ in range(runs):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            times.append((start, end))
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3)
    if on_card:
        sync(device)
        times = [s.elapsed_time(e) for s, e in times]
    return float(np.median(times)) / calls


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
